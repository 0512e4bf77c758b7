"""The port's AdamW against the JAX package's, on the same numpy inputs:
the schedule equal in float32, the global norm, the update per leaf
within 1e-6 of each leaf's scale over several steps (weight decay by the
reference's stacked rank, clipping on and off), the int8 quantizer on
JAX's own noise with one scale per stacked leaf, and the optimizer
cases of ``tests/test_data_optim.py`` run on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as ref_models
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.optim import compress_int8 as ref_compress_int8
from repro.optim import cosine_lr as ref_cosine_lr
from repro.optim import global_norm as ref_global_norm
from repro.optim import init_opt as ref_init_opt
from repro.optim import opt_update as ref_opt_update
from repro_torch.config import TrainConfig, get_arch
from repro_torch.models import Params, lm_from_numpy, lm_to_numpy
from repro_torch.models.common import stacked_groups
from repro_torch.models.interop import opt_to_numpy
from repro_torch.optim import compress_int8, cosine_lr, global_norm, init_opt, opt_update

TOL = 1e-6  # max |port - ref| / max |ref|, per leaf, float32
# The global norm, relative: the reference sums each leaf in float32 in an
# order that loses up to 1e-5 on granite's 65,536-element expert leaves.
REF_NORM_TOL = 2e-5


def _paths(tree):
    """{"layers/attn/wq": array, ...} of a numpy tree."""
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _err(mine, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(mine, np.float32) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _lm(arch, seed=0):
    """The reference's reduced weights, the port's module on them, and
    gradients of the weights' shapes drawn from a seed (layer 0 of each
    stacked leaf ten times layer 1's, so a per-block int8 scale differs)."""
    cfg = get_arch(arch).reduced()
    ref_params = ref_models.build(ref_get_arch(arch).reduced()).init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, ref_params)
    rng = np.random.default_rng(seed + 1)

    def grad_like(path, a):
        g = rng.standard_normal(a.shape).astype(np.float32) * 0.05
        if path[0].key == "layers":
            g[0] *= 10.0
        return g

    grads = jax.tree_util.tree_map_with_path(grad_like, tree)
    return cfg, tree, grads


def _port_grads(cfg, grads):
    return dict(lm_from_numpy(cfg, grads, device="cpu").named_parameters())


@pytest.mark.parametrize("warmup,total,lr", [(10, 100, 1e-3), (3, 17, 3e-4), (100, 1000, 3e-4),
                                             (0, 200, 0.2), (2, 15, 1e-2)])
def test_cosine_lr_equals_the_reference_in_float32(warmup, total, lr):
    tc = TrainConfig(learning_rate=lr, warmup_steps=warmup, total_steps=total)
    ref_tc = RefTrainConfig(learning_rate=lr, warmup_steps=warmup, total_steps=total)
    for s in range(total + 5):
        mine = cosine_lr(tc, np.int32(s))
        assert mine.dtype == np.float32
        assert mine == np.asarray(ref_cosine_lr(ref_tc, jnp.int32(s))), s


def _exact_norm(grads):
    return float(np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in _paths(grads).values())))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b", "granite-moe-1b-a400m",
                                  "seamless-m4t-medium"])
def test_global_norm_matches_the_reference(arch):
    """Within 1e-6 of the float64 norm. The reference's float32 sum of a
    65,536-element leaf (granite's experts) is 1e-5 off it, so the two
    packages agree within REF_NORM_TOL."""
    cfg, _, grads = _lm(arch)
    mine = float(global_norm(_port_grads(cfg, grads)))
    ref = float(ref_global_norm(jax.tree.map(jnp.asarray, grads)))
    exact = _exact_norm(grads)
    assert abs(mine - exact) <= TOL * exact
    assert abs(mine - ref) <= REF_NORM_TOL * ref


def test_stacked_groups_follow_the_reference_leaf_order():
    cfg, tree, _ = _lm("hymba-1.5b")
    module = lm_from_numpy(cfg, tree, device="cpu")
    groups = stacked_groups(n for n, _ in module.named_parameters())
    assert [k for k, _ in groups] == list(_paths(tree))
    key, names = next(g for g in groups if g[0] == "layers/norm1")
    assert names == [f"layers.{i}.norm1" for i in range(cfg.num_layers)]


# (arch, weight decay, grad clip): hymba's per-block norms, beta_* and SSD
# vectors (and seamless's encoder and decoder norms) are 1-D here and 2-D
# in the reference's stacked trees, so decay that followed the port's
# per-block rank would leave them undecayed; the clip of 1.0 is active on
# these gradients, 100.0 is not.
@pytest.mark.parametrize("arch,wd,clip", [("hymba-1.5b", 0.1, 1.0), ("hymba-1.5b", 0.1, 100.0),
                                          ("qwen3-1.7b", 0.3, 1.0),
                                          ("granite-moe-1b-a400m", 0.1, 1.0),
                                          ("seamless-m4t-medium", 0.1, 1.0)])
def test_opt_update_matches_the_reference_per_leaf(arch, wd, clip):
    cfg, tree, grads = _lm(arch)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=6, weight_decay=wd, grad_clip=clip)
    tc, ref_tc = TrainConfig(**kw), RefTrainConfig(**kw)
    params = lm_from_numpy(cfg, tree, device="cpu")
    state = init_opt(params)
    ref_params = jax.tree.map(jnp.asarray, tree)
    ref_state = ref_init_opt(ref_params)
    clip_err = 0.0  # the clip factors' relative difference, from the norms'
    for step in range(3):
        g = jax.tree.map(lambda a: a * (1.0 + step), grads)
        params, state, metrics = opt_update(params, _port_grads(cfg, g), state, tc)
        ref_params, ref_state, ref_metrics = ref_opt_update(
            ref_params, jax.tree.map(jnp.asarray, g), ref_state, ref_tc)
        assert float(metrics["lr"]) == float(ref_metrics["lr"])
        norm, ref_norm = float(metrics["grad_norm"]), float(ref_metrics["grad_norm"])
        assert abs(norm - _exact_norm(g)) <= TOL * norm
        assert abs(norm - ref_norm) <= REF_NORM_TOL * ref_norm
        if norm > clip:
            clip_err = max(clip_err, abs(ref_norm / norm - 1.0))
    assert int(state.step) == int(ref_state.step) == 3
    mu, nu, _ = opt_to_numpy(state)
    # The weights' update is invariant to the clip factor's scale (Adam
    # divides it out); the moments carry it once (mu) and twice (nu).
    for mine, ref, tol in ((lm_to_numpy(params), ref_params, TOL),
                           (mu, ref_state.mu, TOL + clip_err),
                           (nu, ref_state.nu, TOL + 2 * clip_err)):
        mine, ref = _paths(mine), _paths(jax.tree.map(np.asarray, ref))
        assert mine.keys() == ref.keys()
        for k in ref:
            assert _err(mine[k], ref[k]) <= tol, k
    # The 1-D leaves under layers moved by decay as in the reference.
    if wd and arch == "hymba-1.5b":
        norm1 = _paths(lm_to_numpy(params))["layers/norm1"]
        assert np.abs(norm1 - 1.0).max() > 1e-3
    if wd and arch == "seamless-m4t-medium":
        for key in ("enc_layers/norm1", "dec_layers/norm_x"):
            assert np.abs(_paths(lm_to_numpy(params))[key] - 1.0).max() > 1e-3, key


def test_int8_quantizer_on_jax_noise_one_scale_per_stacked_leaf():
    cfg, _, grads = _lm("qwen3-1.7b")
    key = jax.random.PRNGKey(7)
    ref = _paths(jax.tree.map(np.asarray, ref_compress_int8(jax.tree.map(jnp.asarray, grads), key)))
    # The reference's own noise: one key per leaf, in its leaf order.
    leaves = _paths(grads)
    keys = jax.random.split(key, len(leaves))
    uniform = {k: np.asarray(jax.random.uniform(kk, a.shape, jnp.float32))
               for (k, a), kk in zip(leaves.items(), keys)}
    named = _port_grads(cfg, grads)
    out = compress_int8(named, uniform=uniform)
    mine = _paths(lm_to_numpy(Params.map(lm_from_numpy(cfg, grads, device="cpu"),
                                         lambda n, _: out[n])))
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    # One scale per stacked leaf: layer 1 (a tenth of layer 0's size) is
    # quantized on layer 0's scale, into about a tenth of the levels.
    g = leaves["layers/mlp/w_up"]
    step = np.abs(g).max() / 127.0
    levels = np.round(mine["layers/mlp/w_up"][1] / step)
    assert np.abs(levels).max() <= 14


# tests/test_data_optim.py's optimizer cases on the port.


def _w(values):
    return Params({"w": torch.tensor(values, dtype=torch.float32)})


def test_adamw_converges_on_quadratic():
    params = _w([5.0, -3.0, 2.0])
    tc = TrainConfig(learning_rate=0.2, warmup_steps=0, total_steps=200,
                     weight_decay=0.0, grad_clip=100.0)
    opt = init_opt(params)
    for _ in range(150):
        grads = {"w": 2 * params.w.detach()}
        params, opt, _ = opt_update(params, grads, opt, tc)
    assert float(params.w.abs().max()) < 0.2


def test_grad_clip_applied():
    params = _w([0.0] * 4)
    tc = TrainConfig(learning_rate=1.0, warmup_steps=0, total_steps=10, grad_clip=1.0)
    opt = init_opt(params)
    _, _, metrics = opt_update(params, {"w": torch.full((4,), 100.0)}, opt, tc)
    assert float(metrics["grad_norm"]) > 1.0  # reported pre-clip


def test_cosine_schedule_shape():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(cosine_lr(tc, s)) for s in range(0, 100, 10)]
    assert lrs[0] < lrs[1]  # warmup rises
    assert lrs[-1] < lrs[2]  # decays
    assert all(lr >= 0 for lr in lrs)


def test_int8_compression_error_bounded():
    g = {"w": torch.randn((256, 64), generator=torch.Generator().manual_seed(0)) * 0.01}
    out = compress_int8(g, torch.Generator().manual_seed(1))
    err = float((out["w"] - g["w"]).abs().max())
    scale = float(g["w"].abs().max()) / 127.0
    assert err <= scale * 1.01  # one quantization bucket (+stoch rounding)
    # unbiased-ish: mean error tiny relative to scale
    assert abs(float((out["w"] - g["w"]).mean())) < scale * 0.1


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.full((4,), 2.0)}
    assert abs(float(global_norm(t)) - np.sqrt(3 + 16)) < 1e-5


def test_int8_noise_is_drawn_from_the_generator():
    g = {"w": torch.randn((64, 8), generator=torch.Generator().manual_seed(0))}
    a, b = (compress_int8(g, torch.Generator().manual_seed(3))["w"] for _ in range(2))
    c = compress_int8(g, torch.Generator().manual_seed(4))["w"]
    assert torch.equal(a, b) and not torch.equal(a, c)
