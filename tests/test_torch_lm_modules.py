"""Each module of the port's models against its JAX counterpart on the
same numpy weights and inputs: ``rms_norm``, ``rope``, ``softplus``,
attention (causal, windowed, qk-norm, chunked), decode attention through
a wrapping ring buffer, the MLP, the SSD forward and decode step, and
the weight round trip. float32 results agree to 1e-5 of the largest
magnitude of the reference's result."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attn
import repro.models.common as ref_common
import repro.models.ssm as ref_ssm
import repro.models.transformer as ref_lm
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.config import get_arch as ref_get_arch
from repro_torch.config import get_arch
from repro_torch.models import attention, common, ssm, transformer
from repro_torch.models.interop import lm_from_numpy, lm_to_numpy, params_from_numpy

TOL = 1e-5  # max |port - ref| / max |ref|, float32


def rel_err(mine, ref) -> float:
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    ref = np.asarray(ref, np.float32)
    return float(np.abs(mine - ref).max() / max(np.abs(ref).max(), 1e-30))


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x, s = normal(rng, (3, 7, 64)), normal(rng, (64,))
    assert rel_err(common.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
                   ref_common.rms_norm(jnp.asarray(x), jnp.asarray(s))) < TOL
    # bf16 in, bf16 out, the arithmetic in float32: within one bf16 rounding.
    xb = torch.from_numpy(x).bfloat16()
    out = common.rms_norm(xb, torch.from_numpy(s).bfloat16(), 1e-6)
    ref = ref_common.rms_norm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(s).astype(jnp.bfloat16), 1e-6)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert rel_err(out, ref.astype(jnp.float32)) <= 2.0**-8


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = normal(rng, (2, 9, 4, 16))
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    out = common.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = ref_common.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert out.dtype == torch.float32
    assert rel_err(out, ref) < TOL
    # bf16: the products promote to float32 before the one cast back, so
    # the result is within one bf16 rounding of the reference's.
    xb = torch.from_numpy(x).bfloat16()
    out = common.rope(xb, torch.from_numpy(pos), theta)
    ref = ref_common.rope(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(pos), theta)
    assert out.dtype == torch.bfloat16
    diff = np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert (diff <= 2.0**-8 * np.abs(np.asarray(ref.astype(jnp.float32)))).all()


def test_softplus_is_jax_softplus_above_the_torch_threshold():
    x = np.array([-80.0, -20.5, -1.0, 0.0, 0.7, 19.9, 20.0, 20.1, 25.0, 33.3, 90.0], np.float32)
    out = common.softplus(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=0)


def test_cross_entropy_and_count_params_match():
    rng = np.random.default_rng(2)
    logits, labels = normal(rng, (2, 5, 11)), rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        out = common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        ref = ref_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m))
        assert rel_err(out, ref) < TOL


def _attn_weights(cfg, seed=0):
    tree = tree_np(ref_attn.init_attn(jax.random.PRNGKey(seed), cfg, jnp.float32))
    return tree, params_from_numpy(tree, torch.float32, "cpu")


def _small(arch, **kw):
    return dataclasses.replace(get_arch(arch).reduced(), **kw), \
        dataclasses.replace(ref_get_arch(arch).reduced(), **kw)


@pytest.mark.parametrize("arch,causal,window", [
    ("granite-8b", True, 0), ("granite-8b", False, 0), ("h2o-danube-1.8b", True, 5),
    ("qwen3-1.7b", True, 0), ("granite-20b", True, 3),
])
def test_attention_matches(arch, causal, window):
    cfg, ref_cfg = _small(arch)
    tree, p = _attn_weights(ref_cfg)
    x = normal(np.random.default_rng(3), (2, 12, cfg.d_model))
    out = attention.attention(p, torch.from_numpy(x), cfg, causal=causal, window=window)
    ref = ref_attn.attention(tree, jnp.asarray(x), ref_cfg, causal=causal, window=window)
    assert rel_err(out, ref) < TOL


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("s", [32, 29])
def test_chunked_attention_matches(window, s):
    """``chunked_attn`` with 8-position chunks (S ≥ 2 chunks): the online
    softmax over KV chunks, padded when S is not a multiple of 8."""
    cfg, ref_cfg = _small("qwen3-1.7b", chunked_attn=True, attn_chunk=8)
    tree, p = _attn_weights(ref_cfg, seed=1)
    x = normal(np.random.default_rng(4), (2, s, cfg.d_model))
    out = attention.attention(p, torch.from_numpy(x), cfg, window=window)
    ref = ref_attn.attention(tree, jnp.asarray(x), ref_cfg, window=window)
    assert rel_err(out, ref) < TOL
    # the reference's traced-window path, which the hybrid block takes
    ref = ref_lm._attention_dynwin(tree, jnp.asarray(x), ref_cfg, jnp.int32(window))
    assert rel_err(out, ref) < TOL


def test_mask_matches():
    for s, t, causal, window, off in ((5, 5, True, 0, 0), (4, 9, True, 2, 5), (6, 6, False, 3, 0)):
        np.testing.assert_array_equal(
            attention._mask(s, t, causal, window, off).numpy(),
            np.asarray(ref_attn._mask(s, t, causal, window, off)))


@pytest.mark.parametrize("arch,window,max_len", [
    ("h2o-danube-1.8b", 4, 40),  # ring of 5 slots, wraps after 5 steps
    ("qwen3-1.7b", 0, 12),  # plain cache
    ("hymba-1.5b", 3, 12),  # window on a full-length cache
])
def test_decode_attention_through_a_ring_wrap(arch, window, max_len):
    cfg, ref_cfg = _small(arch, window=window)
    tree, p = _attn_weights(ref_cfg, seed=2)
    t = attention.kv_cache_len(cfg, max_len)
    assert t == ref_attn.kv_cache_len(ref_cfg, max_len)
    steps = 12
    xs = normal(np.random.default_rng(5), (steps, 2, 1, cfg.d_model))
    cache = attention.init_kv_cache(cfg, 2, t, torch.float32)
    ref_cache = ref_attn.init_kv_cache(ref_cfg, 2, t, jnp.float32)
    for i in range(steps):
        out, cache = attention.decode_attention(p, torch.from_numpy(xs[i]), cache, cfg,
                                                window=window)
        ref, ref_cache = ref_attn.decode_attention(tree, jnp.asarray(xs[i]), ref_cache,
                                                   ref_cfg, window=window)
        assert rel_err(out, ref) < TOL, i
        assert cache.length == int(ref_cache.length) == i + 1
    assert rel_err(cache.k, ref_cache.k) < TOL and rel_err(cache.v, ref_cache.v) < TOL
    if window:  # every output also equals full attention with that window
        full = ref_attn.attention(tree, jnp.asarray(xs[:, :, 0].transpose(1, 0, 2)), ref_cfg,
                                  window=window)
        assert rel_err(out[:, 0], full[:, -1]) < TOL


def test_mlp_matches():
    cfg, ref_cfg = _small("granite-8b")
    tree = tree_np(ref_lm.init_mlp(jax.random.PRNGKey(3), ref_cfg, jnp.float32))
    p = params_from_numpy(tree, torch.float32, "cpu")
    x = normal(np.random.default_rng(6), (2, 7, cfg.d_model))
    assert rel_err(transformer.mlp(p, torch.from_numpy(x)), ref_lm.mlp(tree, jnp.asarray(x))) < TOL


def _ssm_weights(ref_cfg, seed=4):
    tree = tree_np(ref_ssm.init_ssm(jax.random.PRNGKey(seed), ref_cfg, jnp.float32))
    # A non-zero bias and conv bias reach every term of the update.
    rng = np.random.default_rng(seed)
    tree["dt_bias"] = normal(rng, tree["dt_bias"].shape)
    tree["conv_b"] = normal(rng, tree["conv_b"].shape, 0.1)
    tree["d_skip"] = normal(rng, tree["d_skip"].shape)
    return tree, params_from_numpy(tree, torch.float32, "cpu")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
@pytest.mark.parametrize("s", [8, 24])
def test_ssm_forward_matches(arch, s):
    cfg, ref_cfg = _small(arch)
    tree, p = _ssm_weights(ref_cfg)
    u = normal(np.random.default_rng(7), (2, s, cfg.d_model))
    assert rel_err(ssm.ssm_forward(p, torch.from_numpy(u), cfg),
                   ref_ssm.ssm_forward(tree, jnp.asarray(u), ref_cfg)) < TOL


def test_ssm_forward_refuses_a_ragged_sequence():
    cfg, ref_cfg = _small("mamba2-2.7b")
    _, p = _ssm_weights(ref_cfg)
    with pytest.raises(ValueError, match="multiple of ssm_chunk"):
        ssm.ssm_forward(p, torch.zeros(1, 12, cfg.d_model), cfg)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_decode_step_matches(arch):
    cfg, ref_cfg = _small(arch)
    tree, p = _ssm_weights(ref_cfg, seed=5)
    us = normal(np.random.default_rng(8), (10, 2, 1, cfg.d_model))
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32)
    ref_cache = ref_ssm.init_ssm_cache(ref_cfg, 2, jnp.float32)
    for i in range(len(us)):
        before = cache.state.clone()
        out, new = ssm.ssm_decode_step(p, torch.from_numpy(us[i]), cache, cfg)
        assert torch.equal(cache.state, before)  # the cache passed in is left as it was
        cache = new
        ref, ref_cache = ref_ssm.ssm_decode_step(tree, jnp.asarray(us[i]), ref_cache, ref_cfg)
        assert rel_err(out, ref) < TOL, i
    assert rel_err(cache.state, ref_cache.state) < TOL
    assert rel_err(cache.conv, ref_cache.conv) < TOL


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b", "hymba-1.5b", "llava-next-34b"])
def test_weights_round_trip_bitwise_and_count(arch):
    cfg, ref_cfg = _small(arch)
    params = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    tree = tree_np(params)
    module = lm_from_numpy(cfg, tree, device="cpu")
    back = lm_to_numpy(module)
    flat, ref_flat = jax.tree_util.tree_flatten_with_path(back)[0], \
        jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [k for k, _ in flat] == [k for k, _ in ref_flat]
    for (k, a), (_, b) in zip(flat, ref_flat):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert common.count_params(module) == ref_common.count_params(params)
    assert len(module.layers) == cfg.num_layers


def test_bf16_weights_carry_across_exactly():
    cfg, ref_cfg = _small("hymba-1.5b", dtype="bfloat16")
    params = ref_lm.init_lm(jax.random.PRNGKey(1), ref_cfg)
    tree = tree_np(params)
    module = lm_from_numpy(cfg, tree, device="cpu")
    assert module.layers[0].attn.wq.dtype == torch.bfloat16
    assert module.layers[0].ssm.a_log.dtype == torch.float32
    back = lm_to_numpy(module)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b.astype(np.float32))


def test_lm_from_numpy_refuses_a_tree_of_another_shape():
    cfg, ref_cfg = _small("qwen3-1.7b")
    tree = tree_np(ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg))
    with pytest.raises(ValueError, match="does not stack 3 layers"):
        lm_from_numpy(dataclasses.replace(cfg, num_layers=3), tree, device="cpu")
    with pytest.raises(ValueError, match="embed"):
        lm_from_numpy(dataclasses.replace(cfg, d_model=32), tree, device="cpu")
