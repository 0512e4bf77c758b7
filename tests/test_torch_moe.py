"""The port's MoE layer against the JAX package's, on the same weights and
inputs: the router (gates, expert ids — ties to the lower id — and the
load-balance loss), the rank of each copy in its expert's queue by both
dispatch variants, the capacity, and the layer itself in both variants
with tokens dropped at capacity factor 1.0 (outputs within 1e-5 of the
largest |y|, gradients within 1e-4 of each leaf's max), and dropless
against ``moe_ffn_dense``. Then the MoE families: forward ≡ decode, and
an engine over reduced granite-moe bitwise ``greedy_generate``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from _torch_gloo import one_rank_mesh
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.config import get_arch as ref_get_arch
from repro_torch.config import get_arch
from repro_torch.models import MeshCtx, build
from repro_torch.models import moe
from repro_torch.models.interop import params_from_numpy
from repro_torch.serve import Request, ServeEngine, greedy_generate

TOL = 1e-5  # max |port - ref| / max |ref| of the layer's output, float32
GRAD_TOL = 1e-4  # max |port - ref| / max |ref|, per gradient leaf


def _cfgs(arch="granite-moe-1b-a400m", **kw):
    return (dataclasses.replace(get_arch(arch).reduced(), **kw),
            dataclasses.replace(ref_get_arch(arch).reduced(), **kw))


def _layer(cfg, ref_cfg, b=2, s=16, seed=0):
    """The reference's MoE weights, the port's on them, and an input."""
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, ref_p), torch.float32, "cpu")
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return p, ref_p, x


def _err(mine, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(mine.detach().float().numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_router_matches_the_reference(arch):
    cfg, ref_cfg = _cfgs(arch)
    p, ref_p, x = _layer(cfg, ref_cfg)
    gates, ids, aux = moe.router_topk(p, torch.tensor(x), cfg)
    ref_gates, ref_ids, ref_aux = ref_moe.router_topk(ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert _err(gates, ref_gates) <= TOL
    assert abs(float(aux) - float(ref_aux)) <= TOL * float(ref_aux)


def test_router_ties_go_to_the_lower_expert_id():
    """A zero router gives every expert the same probability: top-k is
    experts 0..k-1, as jax.lax.top_k gives."""
    cfg, ref_cfg = _cfgs(experts_per_token=3)
    p, ref_p, x = _layer(cfg, ref_cfg)
    p.router.zero_()
    ref_p = dict(ref_p, router=jnp.zeros_like(ref_p["router"]))
    _, ids, _ = moe.router_topk(p, torch.tensor(x), cfg)
    _, ref_ids, _ = ref_moe.router_topk(ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert (ids.numpy() == np.arange(3)).all()


@pytest.mark.parametrize("sort_based", [False, True])
def test_rank_within_matches_the_reference(sort_based):
    ids = np.random.default_rng(1).integers(0, 8, 300).astype(np.int32)
    mine = moe._rank_within(torch.tensor(ids, dtype=torch.long), 8, sort_based)
    ref = ref_moe._rank_within(jnp.asarray(ids), 8, sort_based)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("t,decode", [(32, False), (1000, False), (5, True), (1, True)])
@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_capacity_matches_the_reference(t, decode, cf):
    cfg, ref_cfg = _cfgs(moe_capacity_factor=cf)
    assert moe._capacity(t, cfg, decode) == ref_moe._capacity(t, ref_cfg, decode)


def _dropped(cfg, ids, t):
    pos = moe._rank_within(ids.reshape(-1), cfg.num_experts, False)
    return int((pos >= moe._capacity(t, cfg, False)).sum())


@pytest.mark.parametrize("sort_dispatch", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_layer_with_drops_matches_the_reference(arch, sort_dispatch):
    cfg, ref_cfg = _cfgs(arch, moe_capacity_factor=1.0, moe_sort_dispatch=sort_dispatch)
    p, ref_p, x = _layer(cfg, ref_cfg, b=2, s=24)
    xt = torch.tensor(x, requires_grad=True)
    for w in p.parameters():
        w.requires_grad_(True)
    y, aux = moe.moe_ffn(p, xt, cfg, MeshCtx())
    _, ids, _ = moe.router_topk(p, xt, cfg)
    assert _dropped(cfg, ids, 48) > 0  # capacity factor 1.0 drops copies here
    ref_y, ref_aux = ref_moe.moe_ffn(ref_p, jnp.asarray(x), ref_cfg, ref_moe.MeshCtx())
    assert _err(y, ref_y) <= TOL
    assert abs(float(aux.detach()) - float(ref_aux)) <= TOL * float(ref_aux)

    # Gradients of <y, r> + aux through the dispatch, drops included.
    r = np.random.default_rng(5).standard_normal(y.shape).astype(np.float32)
    (y * torch.tensor(r)).sum().add(aux).backward()

    def ref_loss(pp, xx):
        yy, aa = ref_moe.moe_ffn(pp, xx, ref_cfg, ref_moe.MeshCtx())
        return jnp.sum(yy * r) + aa

    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    assert _err(xt.grad, ref_gx) <= GRAD_TOL
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert _err(getattr(p, k).grad, ref_gp[k]) <= GRAD_TOL, k


def test_bf16_layer_matches_the_reference():
    """bf16 experts with the float32 router, drops at capacity factor 1.0:
    the same expert ids and aux, the output within the reference's bf16
    tolerance of 2e-2 (tests/test_models_smoke.py:86), relative to max |y|."""
    cfg, ref_cfg = _cfgs(dtype="bfloat16", moe_capacity_factor=1.0)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    p = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_p),
                          torch.bfloat16, "cpu")
    assert p.router.dtype == torch.float32 and p.w_gate.dtype == torch.bfloat16
    x = np.random.default_rng(0).standard_normal((4, 64, cfg.d_model)).astype(np.float32)
    xt, xj = torch.tensor(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    with torch.no_grad():
        _, ids, aux = moe.router_topk(p, xt, cfg)
        y, _ = moe.moe_ffn(p, xt, cfg)
    _, ref_ids, ref_aux = ref_moe.router_topk(ref_p, xj, ref_cfg)
    ref_y, _ = ref_moe.moe_ffn(ref_p, xj, ref_cfg, ref_moe.MeshCtx())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert float(aux) == float(ref_aux)
    assert y.dtype == torch.bfloat16 and _err(y, ref_y) <= 2e-2


@pytest.mark.parametrize("sort_dispatch", [False, True])
def test_dropless_layer_is_the_dense_oracle(sort_dispatch):
    cfg, ref_cfg = _cfgs(moe_sort_dispatch=sort_dispatch)  # reduced: capacity factor 8
    p, ref_p, x = _layer(cfg, ref_cfg)
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, torch.tensor(x), cfg)
        dense, dense_aux = moe.moe_ffn_dense(p, torch.tensor(x), cfg)
        _, ids, _ = moe.router_topk(p, torch.tensor(x), cfg)
    assert _dropped(cfg, ids, 32) == 0
    assert float((y - dense).abs().max() / dense.abs().max()) <= TOL
    assert float(aux) == float(dense_aux)
    ref_dense, _ = ref_moe.moe_ffn_dense(ref_p, jnp.asarray(x), ref_cfg)
    assert _err(dense, ref_dense) <= TOL


def test_decode_is_dropless():
    cfg, ref_cfg = _cfgs(moe_capacity_factor=1.0)
    p, ref_p, x = _layer(cfg, ref_cfg, b=6, s=1)
    with torch.no_grad():
        y, _ = moe.moe_ffn(p, torch.tensor(x), cfg)
        dense, _ = moe.moe_ffn_dense(p, torch.tensor(x), cfg)
    assert float((y - dense).abs().max() / dense.abs().max()) <= TOL


def test_a_mesh_raises_naming_its_item():
    """A mesh no longer raises: on a one-rank ``(1, 1)`` mesh (the model
    axis has one rank, so the reference's one-device branch) the layer is
    bitwise the meshless one, ``moe_a2a`` off and on, weights and input
    as DTensors. The multi-rank branches are held against the JAX
    package's in tests/test_torch_launch_mesh.py."""
    from repro_torch.launch.shardings import param_shardings, place

    for a2a in (False, True):
        cfg, ref_cfg = _cfgs(moe_capacity_factor=1.0, moe_a2a=a2a)
        p, _, x = _layer(cfg, ref_cfg)
        with torch.no_grad():
            y0, aux0 = moe.moe_ffn(p, torch.tensor(x), cfg)
            with one_rank_mesh() as mesh:
                ctx = MeshCtx(mesh, ("data",))
                assert ctx.model_ranks == 1
                tree = params_from_numpy({"layers": [{"moe": {
                    k: w.numpy() for k, w in p.named_parameters()}}]}, torch.float32, "cpu")
                placed = place(tree, param_shardings(tree, cfg, mesh))["layers"][0]["moe"]
                with moe.mesh_scope(ctx):
                    y, aux = moe.moe_ffn(placed, moe.as_dtensor(torch.tensor(x), ctx), cfg, ctx)
                y, aux = y.full_tensor(), aux.full_tensor()
        assert torch.equal(y, y0) and torch.equal(aux, aux0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_moe_decode_consistency(arch):
    """Teacher-forced forward == step-by-step decode (tests/test_models_smoke.py)."""
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
    state = model.init_state(params, {"tokens": toks}, max_len=16)
    outs = []
    for t in range(16):
        lg, state = model.decode_step(params, toks[:, t : t + 1], state)
        outs.append(lg)
    assert float((full - torch.stack(outs, dim=1)).abs().max()) < 2e-2


def test_moe_engine_is_greedy_generate():
    """An engine wave of greedy's batch over a cache of greedy's length
    gives greedy's tokens, bit for bit."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 6)).astype(np.int32)
    want = greedy_generate(model, params, prompts, max_new=5)
    eng = ServeEngine(model, params, batch_slots=4, max_len=11, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=5))
    eng.run_until_drained()
    got = {r.rid: r.out for r in eng.completed}
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(got[i]), want[i])
