"""The port's language models against the JAX package's, family by
family, on the same weights (carried across with ``lm_from_numpy``):
the teacher-forced forward and a sequence of decode steps, at 1e-4 of
the largest |logit| in float32 and at the reference's 2e-2 in bf16.
Then the reference's own smoke tests on the port, every family
(the encoder-decoder one's parity is in tests/test_torch_encdec.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as ref_models
from _torch_gloo import one_rank_mesh
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.config import get_arch as ref_get_arch
from repro_torch.config import get_arch
from repro_torch.models import MeshCtx, build, lm_from_numpy
from repro_torch.models.common import count_params

TOL = 1e-4  # max |port - ref| / max |ref| over the logits, float32
# bf16: max |port - ref| of the logits, tests/test_models_smoke.py:86; the
# caches' max |port - ref| / max |ref|.
TOL_BF16 = 2e-2
B = 2

# (arch, sequence length): h2o's 40 positions wrap its ring of window + 1
# = 17 slots twice; hymba's 24 reach past its window of 16 on the SWA layer.
FAMILIES = [("granite-8b", 16), ("granite-20b", 16), ("qwen3-1.7b", 16),
            ("h2o-danube-1.8b", 40), ("mamba2-2.7b", 16), ("hymba-1.5b", 24),
            ("llava-next-34b", 16), ("granite-moe-1b-a400m", 16), ("moonshot-v1-16b-a3b", 16)]


def _batch(cfg, s, seed=0):
    batch = {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))
             .astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = np.random.default_rng(seed + 1).standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    return batch


def _pair(arch, **kw):
    """The reference's model and weights, and the port's on the same ones."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    ref_model = ref_models.build(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = lm_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return (ref_model, ref_params), (build(cfg), params)


def _compare(arch, s, tol, scaled=True, **kw):
    (ref_model, ref_params), (model, params) = _pair(arch, **kw)
    batch = _batch(model.cfg, s)

    def err(mine, ref, scaled=scaled):
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        d = np.abs(mine.float().numpy() - ref).max()
        return d / np.abs(ref).max() if scaled else d

    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    ref_logits, ref_aux = ref_model.forward(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert logits.shape == ref_logits.shape == (B, s, model.cfg.vocab_size)
    if model.cfg.is_moe:  # the load-balance loss, summed over the layers
        assert abs(float(aux) - float(ref_aux)) <= tol * float(ref_aux)
    else:
        assert float(aux) == float(ref_aux) == 0.0
    assert err(logits, ref_logits) < tol

    state = model.init_state(params, batch, max_len=s)
    ref_state = ref_model.init_state(ref_params, batch, max_len=s)
    ref_step = jax.jit(ref_model.decode_step)
    for t in range(s):
        tok = batch["tokens"][:, t : t + 1]
        lg, state = model.decode_step(params, tok, state)
        ref_lg, ref_state = ref_step(ref_params, jnp.asarray(tok), ref_state)
        assert err(lg, ref_lg) < tol, t
    assert state.pos == int(ref_state.pos) == s
    for name in ("kv_k", "kv_v", "conv", "ssm"):
        mine, ref = getattr(state, name), getattr(ref_state, name)
        assert (mine is None) == (ref is None), name
        if mine is not None:
            assert mine.shape == ref.shape, name
            assert err(mine, ref, scaled=True) < tol, name  # relative to the cache's scale


@pytest.mark.parametrize("arch,s", FAMILIES)
def test_forward_and_decode_match_the_reference(arch, s):
    _compare(arch, s, TOL)


@pytest.mark.parametrize("arch,s,kw", [
    ("granite-8b", 16, {"tie_embeddings": False, "vocab_pad_to": 96}),  # lm_head, padded embed
    ("hymba-1.5b", 24, {"chunked_attn": True, "attn_chunk": 8}),  # chunked, global and SWA
    ("h2o-danube-1.8b", 40, {"chunked_attn": True, "attn_chunk": 16}),  # chunked with padding
])
def test_options_match_the_reference(arch, s, kw):
    _compare(arch, s, TOL, **kw)


def test_bf16_hybrid_matches_the_reference():
    """bf16 through every mixed-type spot: rope, the hybrid 0.5 mix, the
    SSD's float32 decay products and ``d_skip``."""
    _compare("hymba-1.5b", 24, TOL_BF16, scaled=False, dtype="bfloat16")


# tests/test_models_smoke.py on the port, for the families it has.


@pytest.mark.parametrize("arch", [a for a, _ in FAMILIES] + ["seamless-m4t-medium"])
def test_forward_shapes_no_nans(arch):
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert count_params(params) > 0
    with torch.no_grad():
        logits, aux = model.forward(params, _batch(cfg, 16))
    assert logits.shape == (B, 16, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    assert not bool(torch.isnan(aux))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b", "mamba2-2.7b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_decode_consistency(arch):
    """Teacher-forced forward == step-by-step decode (per family)."""
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, 16)
    with torch.no_grad():
        logits_full, _ = model.forward(params, batch)
    state = model.init_state(params, batch, max_len=16)
    outs = []
    for t in range(16):
        lg, state = model.decode_step(params, batch["tokens"][:, t : t + 1], state)
        outs.append(lg)
    err = float((logits_full - torch.stack(outs, dim=1)).abs().max())
    assert err < 2e-2, err


def test_init_is_deterministic_per_seed():
    cfg = get_arch("hymba-1.5b").reduced()
    model = build(cfg)
    a, b = (model.init(torch.Generator().manual_seed(3), device="cpu") for _ in range(2))
    c = model.init(torch.Generator().manual_seed(4), device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["layers.0.attn.wq"], pc["layers.0.attn.wq"])
    assert pa["layers.1.ssm.a_log"].dtype == torch.float32
    assert not any(p.requires_grad for p in a.parameters())


def test_options_not_ported_say_so():
    """Every option is ported. ``remat`` (its gradients are held against
    ``"none"`` in tests/test_torch_train_step.py) gives the same forward;
    a one-rank ``(1, 1)`` mesh, weights, batch and decode state placed as
    DTensors, gives the meshless logits bitwise, of the forward with
    ``act_anchor`` on or off and of decode steps (the mesh paths run the
    meshless cores per shard). The multi-rank meshes are held against the
    JAX package and the meshless paths in tests/test_torch_launch_mesh.py."""
    cfg = get_arch("qwen3-1.7b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, 8)
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
        for remat in ("full", "dots"):
            assert torch.equal(model.forward(params, batch, remat=remat)[0], logits)
    assert MeshCtx().mesh is None
    from repro_torch.launch.shardings import (batch_shardings, decode_state_shardings,
                                              param_shardings, place)

    batch_t = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad(), one_rank_mesh() as mesh:
        ctx = MeshCtx(mesh, ("data",))
        placed = place(params, param_shardings(params, cfg, mesh))
        for anchor in (False, True):
            acfg = dataclasses.replace(cfg, act_anchor=anchor)
            got, _ = build(acfg).forward(placed, place(batch_t, batch_shardings(batch_t, mesh)),
                                         ctx)
            assert torch.equal(got.full_tensor(), logits)
        state = model.init_state(params, batch_t, max_len=4)
        on_mesh = place(state, decode_state_shardings(state, cfg, mesh))
        for t in range(4):
            tok = batch_t["tokens"][:, t:t + 1]
            ref, state = model.decode_step(params, tok, state)
            got, on_mesh = model.decode_step(placed, tok, on_mesh, ctx)
            assert torch.equal(got.full_tensor(), ref)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_moe_families_build(arch):
    """The MoE family builds now (it refused before the training slice):
    one float32 router and the stacked experts in each block."""
    cfg = get_arch(arch).reduced()
    params = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    block = params["layers"][0]["moe"]
    assert block["router"].dtype == torch.float32
    assert block["w_gate"].shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
