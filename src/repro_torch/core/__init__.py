"""The paper's two-level NEZGT + hypergraph partitioners, copied from
the JAX package's ``repro/core`` so that both packages plan
bit-identically. Use them through :func:`repro_torch.api.distribute`."""
