"""The flash-attention entry point on CPU tensors (the plain version)
against the JAX package's Pallas ``flash_attention`` run in interpret
mode — every case of ``tests/test_kernels_attn.py``, plus D = 80, T ≠ S,
``causal=False`` with a window and the tiles of the card's ``wgmma``
variant — and the window-locality test, the
tile count, ``mha`` and the wrapper's checks.

Tolerances are the reference tests': 2e-5 for float32 and 5e-2 for
bfloat16 (rtol and atol): the Pallas kernel's online softmax and the
plain version's full softmax round apart."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn import flash_attention as jx_flash_attention
from repro.kernels.attn import mha as jx_mha
from repro.kernels.attn.ref import attention_ref as jx_attention_ref
from repro_torch.kernels.attn import (
    attention_mask,
    attention_plain,
    attention_variant,
    flash_attention,
    mha,
    visited_tiles,
)

TOL = {"float32": 2e-5, "bfloat16": 5e-2}
JX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(bh, s, t, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, n, d)).astype(np.float32) for n in (s, t, t))


def _both(q, k, v, dtype="float32", **kw):
    """The Pallas kernel (interpret mode) and the port on the same numpy
    inputs, both as float32 numpy."""
    o_jx = jx_flash_attention(*(jnp.asarray(a, JX[dtype]) for a in (q, k, v)),
                              interpret=True, **kw)
    o_pt = flash_attention(*(torch.as_tensor(a).to(PT[dtype]) for a in (q, k, v)), **kw)
    assert o_pt.dtype == PT[dtype] and o_pt.shape == q.shape
    return np.asarray(o_jx, np.float32), o_pt.float().numpy()


@pytest.mark.parametrize("causal,window", [
    (True, 0), (False, 0), (True, 16), (True, 8), (True, 32),
])
@pytest.mark.parametrize("s,bq,bkv", [(64, 16, 16), (128, 32, 16), (64, 64, 64)])
def test_attention_matches_pallas(causal, window, s, bq, bkv):
    q, k, v = _qkv(2, s, s, 16, seed=window + s)
    o_jx, o_pt = _both(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv)
    np.testing.assert_allclose(o_pt, o_jx, rtol=2e-5, atol=2e-5)


def test_attention_bf16_matches_pallas():
    q, k, v = _qkv(2, 64, 64, 32, seed=9)
    o_jx, o_pt = _both(q, k, v, "bfloat16", causal=True, bq=16, bkv=16)
    np.testing.assert_allclose(o_pt, o_jx, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,s,t,bq,bkv", [
    (True, 0, 64, 64, 16, 32),  # D = 80, causal
    (True, 24, 96, 96, 32, 16),  # D = 80, sliding window
    (True, 0, 32, 96, 16, 32),  # T > S: later keys never visible
    (True, 0, 96, 32, 32, 16),  # T < S: the last rows see every key
    (False, 0, 64, 128, 32, 32),  # T > S, no mask
    (False, 16, 64, 64, 16, 16),  # one-sided window, later keys visible
    (False, 8, 64, 96, 32, 32),  # the same with T > S
])
def test_attention_wider_cases_match_pallas(dtype, causal, window, s, t, bq, bkv):
    q, k, v = _qkv(2, s, t, 80, seed=s + t + window)
    o_jx, o_pt = _both(q, k, v, dtype, causal=causal, window=window, bq=bq, bkv=bkv)
    np.testing.assert_allclose(o_pt, o_jx, rtol=TOL[dtype], atol=TOL[dtype])


# T < S with a window: rows from T + window on see no key, and some of
# them no visited tile either (S, T, bq, bkv, causal, window).
NO_KEY_CASES = [(128, 32, 32, 16, True, 8), (64, 32, 16, 16, False, 8),
                (128, 32, 16, 16, True, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,bq,bkv,causal,window", NO_KEY_CASES)
def test_rows_that_see_no_key_match_pallas(dtype, s, t, bq, bkv, causal, window):
    """A row whose visited keys are all masked is the mean of v over them,
    a row with no visited tile is 0: what the tiled kernel computes."""
    q, k, v = _qkv(2, s, t, 80, seed=s + t + window)
    o_jx, o_pt = _both(q, k, v, dtype, causal=causal, window=window, bq=bq, bkv=bkv)
    np.testing.assert_allclose(o_pt, o_jx, rtol=TOL[dtype], atol=TOL[dtype])
    blind = ~attention_mask(s, t, causal=causal, window=window).numpy().any(axis=1)
    assert blind[t + window:].all() and not blind[:t + window].any()


# Tiles the card runs on the wgmma variant (bq a multiple of 64): bkv = 16
# under a 128-key chunk, bq = 256, and T < S with a window, so that the
# last rows see no key (causal, window, s, t, bq, bkv).
WGMMA_TILE_CASES = [(True, 0, 128, 128, 64, 16), (True, 8, 256, 64, 128, 32),
                    (False, 0, 128, 256, 128, 64), (True, 32, 256, 256, 256, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("causal,window,s,t,bq,bkv", WGMMA_TILE_CASES)
def test_wgmma_tiles_match_pallas(dtype, d, causal, window, s, t, bq, bkv):
    q, k, v = _qkv(2, s, t, d, seed=s + t + bkv)
    o_jx, o_pt = _both(q, k, v, dtype, causal=causal, window=window, bq=bq, bkv=bkv)
    np.testing.assert_allclose(o_pt, o_jx, rtol=TOL[dtype], atol=TOL[dtype])


def test_dense_plain_is_still_the_oracle():
    """Without tiles, ``attention_plain`` is the dense oracle ``attention_ref``
    on the same inputs, blind rows included."""
    for s, t, bq, bkv, causal, window in NO_KEY_CASES:
        q, k, v = _qkv(2, s, t, 80, seed=s + t + window)
        o_ref = np.asarray(jx_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                            causal=causal, window=window))
        o_pt = attention_plain(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal,
                               window=window, bq=None, bkv=None).numpy()
        np.testing.assert_allclose(o_pt, o_ref, rtol=2e-5, atol=2e-5)


def test_plain_wants_both_tiles_or_neither():
    q, k, v = (torch.zeros((1, 32, 16)) for _ in range(3))
    with pytest.raises(ValueError, match="both"):
        attention_plain(q, k, v, bq=16)
    with pytest.raises(ValueError, match="multiples"):
        attention_plain(q, k, v, bq=24, bkv=16)


# Every shape the card runs (chip_smoke.py's sweep and [lm kernels],
# tests/test_torch_gpu.py), with the variant it must take:
# (dtype, D, bq, bkv, variant).
VARIANT_CASES = [
    *[(dt, d, bq, bkv, ("wgmma" if bq % 64 == 0 else "mma") if dt == "bfloat16" else
       "regblock" if bq % 64 == 0 and bkv % 64 == 0 else "simt")
      for dt in ("float32", "bfloat16") for d in (16, 64, 80, 128)
      for bq, bkv in ((16, 16), (32, 16), (64, 64), (128, 128), (32, 64), (64, 32))],
    ("bfloat16", 64, 128, 128, "wgmma"),  # granite-moe-1b-a400m causal prefill
    ("bfloat16", 80, 128, 128, "wgmma"),  # h2o-danube-1.8b window prefill
    ("bfloat16", 64, 32, 128, "mma"),  # bq = 32: under a warpgroup's 64 rows
    ("bfloat16", 80, 48, 16, "mma"),  # bq = 48, a multiple of 16 but not of 64
    ("bfloat16", 64, 64, 16, "wgmma"),  # the smallest wgmma tiles
    ("bfloat16", 128, 256, 128, "wgmma"),  # bq = 256: two 128-row blocks a tile
    ("bfloat16", 16, 192, 48, "wgmma"),  # bq = 192: three 64-row blocks a tile
    ("bfloat16", 64, 128, 8, "simt"),  # bkv not a multiple of 16
    ("bfloat16", 24, 128, 128, "simt"),  # D not a multiple of 16
    ("bfloat16", 144, 128, 128, "simt"),  # D past 128
    ("float32", 64, 128, 128, "regblock"),  # granite, float32
    ("float32", 80, 128, 128, "regblock"),  # h2o, float32
    ("float32", 80, 128, 64, "regblock"),  # 64-multiple tiles
    ("float32", 64, 16, 16, "simt"),  # bq not a multiple of 64
    ("float32", 64, 128, 32, "simt"),  # bkv not a multiple of 64
    ("float32", 24, 64, 64, "simt"),  # the sweep's D = 24, not a multiple of 16
    ("float32", 144, 128, 128, "simt"),  # D past 128
    ("bfloat16", 24, 16, 16, "simt"),  # D not a multiple of 16
    ("bfloat16", 64, 8, 16, "simt"),  # bq not a multiple of 16
    ("bfloat16", 64, 16, 8, "simt"),  # bkv not a multiple of 16
    ("bfloat16", 144, 16, 16, "simt"),  # D past 128 (the wrapper refuses it on the card)
]


@pytest.mark.parametrize("dtype,d,bq,bkv,variant", VARIANT_CASES)
def test_attention_variant(dtype, d, bq, bkv, variant):
    assert attention_variant(PT[dtype], d, bq, bkv) == variant


def test_banded_blocks_are_skipped_semantically():
    """With a tiny window, far-past keys and values do not reach the
    output (the banded matrix of ch.1 §2.2 as an attention mask)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 64, 64, 16, seed=11))
    o1 = flash_attention(q, k, v, causal=True, window=4, bq=16, bkv=16)
    rng = np.random.default_rng(99)
    k2, v2 = k.clone(), v.clone()
    k2[:, :16] = torch.as_tensor(rng.standard_normal((1, 16, 16)).astype(np.float32))
    v2[:, :16] = torch.as_tensor(rng.standard_normal((1, 16, 16)).astype(np.float32))
    o2 = flash_attention(q, k2, v2, causal=True, window=4, bq=16, bkv=16)
    torch.testing.assert_close(o1[:, 32:], o2[:, 32:], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(o1[:, :16], o2[:, :16])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 8)])
def test_mha_matches_reference_mha(causal, window):
    q, k, v = _qkv(4, 64, 64, 32, seed=5)
    o_jx = np.asarray(jx_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                             window=window, bq=32, bkv=32))
    o_pt = mha(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal, window=window,
               bq=32, bkv=32).numpy()
    np.testing.assert_allclose(o_pt, o_jx, rtol=2e-5, atol=2e-5)


def test_mask_is_the_models_mask():
    """``repro/models/attention.py::_mask`` at offset 0, written out."""
    s, t, window = 12, 20, 3
    rows, cols = np.arange(s)[:, None], np.arange(t)[None, :]
    expected = (rows >= cols) & (rows - cols <= window)
    got = attention_mask(s, t, causal=True, window=window).numpy()
    np.testing.assert_array_equal(got, expected)


def _visited_brute(s, t, causal, window, bq, bkv):
    n = 0
    for i in range(s // bq):
        for j in range(t // bkv):
            ok = True
            if causal:
                ok = ok and i * bq + bq - 1 >= j * bkv
            if window > 0:
                ok = ok and i * bq <= j * bkv + bkv - 1 + window
            n += ok
    return n


@pytest.mark.parametrize("s,t,causal,window,bq,bkv", [
    (64, 64, True, 0, 16, 16), (128, 128, True, 8, 32, 16), (64, 96, False, 16, 16, 32),
    (256, 256, False, 0, 64, 64), (8192, 8192, True, 4096, 128, 128),
])
def test_visited_tiles_is_the_reference_rule(s, t, causal, window, bq, bkv):
    assert visited_tiles(s, t, causal=causal, window=window, bq=bq, bkv=bkv) == \
        _visited_brute(s, t, causal, window, bq, bkv)


def test_visited_tiles_at_the_h2o_window():
    # h2o-danube-1.8b's prefill: S = 8192, window 4096, 128 × 128 tiles.
    kw = {"bq": 128, "bkv": 128}
    assert visited_tiles(8192, 8192, causal=True, window=4096, **kw) == 1584
    assert visited_tiles(8192, 8192, causal=True, window=0, **kw) == 64 * 65 // 2


def test_flash_attention_is_the_plain_version_on_cpu():
    q, k, v = (torch.as_tensor(a) for a in _qkv(2, 32, 32, 16, seed=3))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=True, window=4, bq=16, bkv=16)
    assert flash_attention.launches == before  # no kernel launched on the CPU
    assert torch.equal(o, attention_plain(q, k, v, causal=True, window=4, bq=16, bkv=16))


@pytest.mark.parametrize("case", [
    "s_not_multiple_of_bq", "t_not_multiple_of_bkv", "k_v_differ", "d_differs",
    "bh_differs", "q_not_3d",
])
def test_flash_attention_refuses_bad_shapes(case):
    q, k, v = (torch.zeros((2, 64, 16)) for _ in range(3))
    kw = {"bq": 16, "bkv": 16}
    if case == "s_not_multiple_of_bq":
        kw["bq"] = 24
    elif case == "t_not_multiple_of_bkv":
        k = v = torch.zeros((2, 40, 16))
    elif case == "k_v_differ":
        v = torch.zeros((2, 48, 16))
    elif case == "d_differs":
        k = v = torch.zeros((2, 64, 32))
    elif case == "bh_differs":
        k = v = torch.zeros((3, 64, 16))
    elif case == "q_not_3d":
        q = torch.zeros((2, 64, 4, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


def test_flash_attention_refuses_mixed_devices_and_types():
    q, k, v = (torch.zeros((2, 64, 16)) for _ in range(3))
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.to("meta"), v, bq=16, bkv=16)
    with pytest.raises(TypeError):
        flash_attention(q, k, v.bfloat16(), bq=16, bkv=16)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), bq=16, bkv=16)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), bq=16, bkv=16)
