"""Device packing (:mod:`repro_torch.pmvc.plan_device`, copied from the
JAX package) and the distributed PMVC executor
(:mod:`repro_torch.pmvc.dist`, ported to PyTorch)."""
