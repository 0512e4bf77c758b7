"""The Block-ELL SpMM wrapper on CPU tensors (the plain version) against the
JAX package's oracle for its Pallas ``bell_spmm``, unit by unit — the
sweep of ``tests/test_kernels_spmv.py`` — plus the properties the CUDA
kernel shares: per-column results independent of B, inert padding,
stable row order, and the wrapper's checks.

The Pallas kernel itself does not run here in interpret mode: with the
installed JAX its body fails on ``pl.load`` (the JAX package's own
kernel tests fail the same way), so the comparison is with
``bell_spmm_ref``, the jnp oracle those tests hold the kernel to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nezgt import nezgt_partition
from repro.kernels.spmv import bell_spmm_ref as jx_bell_spmm_ref
from repro.kernels.spmv import pack_inputs as jx_pack_inputs
from repro.kernels.spmv import spmm_shard_ref as jx_spmm_shard_ref
from repro.kernels.spmv import spmv_shard_ref as jx_spmv_shard_ref
from repro.pmvc.plan_device import pack_units as jx_pack_units
from repro.sparse import pack_bell as jx_pack_bell
from repro.sparse import tile_counts
from repro.sparse.generate import banded_coo, grid5_coo, random_coo
from repro_torch.kernels.spmv import (
    bell_spmm,
    bell_spmm_plain,
    bell_tiles,
    pack_inputs,
    row_spans,
    simt_limit,
    spmm_shard,
    spmm_shard_ref,
    spmm_variant,
    spmv_shard,
    spmv_shard_ref,
)
from repro_torch.kernels.spmv.ops import SPAN_OUT_ROWS, SPAN_TILES_PER_ROW
from repro_torch.pmvc.plan_device import pack_units
from repro_torch.sparse.bell import pack_bell, pad_x_blocks
from repro_torch.sparse.formats import COO

UNITS = 3


def _plan(gen, seed, bm, bn, n=192, nnz=1500):
    a = gen(n, nnz, seed=seed)
    elem_unit = np.random.default_rng(seed).integers(0, UNITS, size=a.nnz)
    dp = pack_units(COO(a.shape, a.row, a.col, a.val), elem_unit, UNITS, bm, bn)
    ref = jx_pack_units(a, elem_unit, UNITS, bm, bn)
    np.testing.assert_array_equal(dp.tiles, ref.tiles)
    return dp


def _x_blocks(dp, b, seed):
    x = np.random.default_rng(seed).standard_normal((b, dp.shape[1])).astype(np.float32)
    return pad_x_blocks(x, dp.num_col_blocks, dp.bn)  # [NCB, bn, B]


def _port(dp, xb, dtype=torch.float32):
    bt = bell_tiles(torch.as_tensor(dp.tiles).to(dtype), dp.tile_row, dp.tile_col,
                    dp.real_tiles, dp.num_row_blocks)
    return bell_spmm(bt, torch.as_tensor(xb).to(dtype)[None]).numpy()


@pytest.mark.parametrize("bm,bn", [(8, 8), (8, 16), (16, 16), (8, 128),
                                   (4, 4), (24, 24), (16, 12), (12, 16), (3, 5)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_plain_matches_oracle_per_unit(bm, bn, b):
    dp = _plan(random_coo, 0, bm, bn)
    xb = _x_blocks(dp, b, seed=b)
    y = _port(dp, xb)
    assert y.shape == (UNITS, dp.num_row_blocks, bm, b) and y.dtype == np.float32
    for u in range(UNITS):
        args = (jnp.asarray(dp.tiles[u]), jnp.asarray(dp.tile_row[u]),
                jnp.asarray(dp.tile_col[u]), jnp.asarray(xb))
        y_o = np.asarray(jx_bell_spmm_ref(*args, dp.num_row_blocks))
        np.testing.assert_allclose(y[u], y_o, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gen,seed", [(banded_coo, 1), (grid5_coo, 2)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float16, 2e-2)])
def test_dtype_sweep_matches_oracle(gen, seed, dtype, tol):
    dp = _plan(gen, seed, 8, 8)
    xb = _x_blocks(dp, 8, seed)
    y = _port(dp, xb, torch.float16 if dtype == np.float16 else torch.float32)
    for u in range(UNITS):
        y_o = jx_bell_spmm_ref(
            jnp.asarray(dp.tiles[u].astype(dtype)), jnp.asarray(dp.tile_row[u]),
            jnp.asarray(dp.tile_col[u]), jnp.asarray(xb.astype(dtype)),
            dp.num_row_blocks,
        )
        np.testing.assert_allclose(y[u], np.asarray(y_o), rtol=tol, atol=tol)


def test_columns_bitwise_independent_of_batch_width():
    dp = _plan(banded_coo, 3, 16, 16)
    xb = _x_blocks(dp, 64, seed=3)
    wide = _port(dp, xb)
    for b in (1, 8):
        narrow = _port(dp, np.ascontiguousarray(xb[..., :b]))
        np.testing.assert_array_equal(wide[..., :b], narrow)
    for j in (0, 5, 63):
        one = _port(dp, np.ascontiguousarray(xb[..., j:j + 1]))
        np.testing.assert_array_equal(wide[..., j:j + 1], one)


def test_padding_is_inert_and_never_read():
    """Padding past ``counts`` is not read: garbage there changes nothing."""
    dp = _plan(random_coo, 5, 8, 8, n=64, nnz=300)
    assert (dp.real_tiles < dp.t).any()  # padding present
    xb = _x_blocks(dp, 3, seed=5)
    clean = _port(dp, xb)
    tiles = dp.tiles.copy()
    for u, c in enumerate(dp.real_tiles):
        tiles[u, c:] = 7.0
    bt = bell_tiles(torch.as_tensor(tiles), dp.tile_row, dp.tile_col,
                    dp.real_tiles, dp.num_row_blocks)
    np.testing.assert_array_equal(bell_spmm(bt, torch.as_tensor(xb)[None]).numpy(), clean)


def test_unsorted_tiles_are_sorted_stably_by_row():
    rng = np.random.default_rng(7)
    u_n, t, nrb, bm, bn, s = 2, 9, 5, 8, 8, 6
    tiles = rng.standard_normal((u_n, t, bm, bn)).astype(np.float32)
    rows = rng.integers(0, nrb, size=(u_n, t)).astype(np.int32)
    src = rng.integers(0, s, size=(u_n, t)).astype(np.int32)
    counts = np.array([t, t - 3])
    bt = bell_tiles(torch.as_tensor(tiles), rows, src, counts, nrb)
    for u in range(u_n):
        c = counts[u]
        order = np.argsort(rows[u, :c], kind="stable")
        np.testing.assert_array_equal(bt.tiles[u, :c].numpy(), tiles[u, order])
        np.testing.assert_array_equal(bt.tile_row[u, :c].numpy(), rows[u, order])
        np.testing.assert_array_equal(bt.tile_src[u, :c].numpy(), src[u, order])
        ptr = bt.row_ptr[u].numpy()
        np.testing.assert_array_equal(np.diff(ptr), np.bincount(rows[u, :c], minlength=nrb))
    x = torch.as_tensor(rng.standard_normal((u_n, s, bn, 4)).astype(np.float32))
    y = bell_spmm(bt, x)
    y_raw = bell_spmm_plain(torch.as_tensor(tiles), torch.as_tensor(rows),
                            torch.as_tensor(src), counts, x, nrb)
    np.testing.assert_allclose(y.numpy(), y_raw.numpy(), rtol=1e-6, atol=1e-6)


def test_shared_source_equals_per_unit_copies():
    dp = _plan(random_coo, 8, 8, 16)
    xb = torch.as_tensor(_x_blocks(dp, 4, seed=8))
    bt = bell_tiles(torch.as_tensor(dp.tiles), dp.tile_row, dp.tile_col,
                    dp.real_tiles, dp.num_row_blocks)
    shared = bell_spmm(bt, xb[None])
    copies = bell_spmm(bt, xb[None].expand(UNITS, -1, -1, -1).contiguous())
    np.testing.assert_array_equal(shared.numpy(), copies.numpy())


def test_wrapper_checks_its_inputs():
    dp = _plan(random_coo, 9, 8, 8, n=64, nnz=300)
    t = torch.as_tensor(dp.tiles)
    nrb = dp.num_row_blocks
    with pytest.raises(ValueError, match="at least 1 x 1"):
        bell_tiles(torch.zeros((UNITS, dp.t, 0, 8)), dp.tile_row, dp.tile_col,
                   dp.real_tiles, nrb)
    # Any other shape is taken, as by the JAX package (simt on the card).
    bell_tiles(torch.zeros((UNITS, dp.t, 8, 12)), dp.tile_row, dp.tile_col, dp.real_tiles, nrb)
    with pytest.raises(TypeError, match="float32 or float16"):
        bell_tiles(t.double(), dp.tile_row, dp.tile_col, dp.real_tiles, nrb)
    with pytest.raises(ValueError, match="tile_row of a real tile"):
        bell_tiles(t, dp.tile_row, dp.tile_col, dp.real_tiles, 1)
    with pytest.raises(ValueError, match="counts"):
        bell_tiles(t, dp.tile_row, dp.tile_col, dp.real_tiles + dp.t, nrb)
    bt = bell_tiles(t, dp.tile_row, dp.tile_col, dp.real_tiles, nrb)
    xb = torch.as_tensor(_x_blocks(dp, 2, seed=9))
    with pytest.raises(TypeError, match="float64"):
        bell_spmm(bt, xb[None].double())
    with pytest.raises(ValueError, match="bn=8"):
        bell_spmm(bt, xb[None, :, :4])
    with pytest.raises(ValueError, match="tile_src reaches"):
        bell_spmm(bt, xb[None, :1])
    with pytest.raises(ValueError, match="1 or U"):
        bell_spmm(bt, xb[None].expand(2, -1, -1, -1))


def _row_ptr(per_row):
    per_row = np.asarray(per_row, dtype=np.int64)
    ptr = np.zeros((per_row.shape[0], per_row.shape[1] + 1), np.int64)
    np.cumsum(per_row, axis=1, out=ptr[:, 1:])
    return ptr


# Tiles per (unit, block-row): ragged, with empty rows and whole empty
# units, one long row among short ones, and a single row.
_rng = np.random.default_rng(11)
SPAN_PLANS = {
    "ragged": _rng.integers(0, 7, size=(3, 50)),
    "empty": np.zeros((2, 9), np.int64),
    "empty_unit": np.vstack([np.zeros(20, np.int64), _rng.integers(0, 3, size=20)]),
    "long_row": np.array([[1, 2, 1, 90, 1, 0, 2, 3, 1, 1]]),
    "one_row": np.array([[5], [0]]),
    "banded": np.full((4, 37), 3),
}


@pytest.mark.parametrize("plan", sorted(SPAN_PLANS))
@pytest.mark.parametrize("bm", [8, 16, 32])
def test_row_spans_cover_every_row_once_and_balance_tiles(plan, bm):
    per_row = SPAN_PLANS[plan]
    ptr = _row_ptr(per_row)
    spans = row_spans(ptr, bm)
    assert spans.dtype == np.int32 and spans.shape[1] == 3
    max_rows = SPAN_OUT_ROWS // bm
    max_tiles = SPAN_TILES_PER_ROW * max_rows
    covered = np.zeros(per_row.shape, np.int64)
    for u, r0, r1 in spans:
        assert 0 <= r0 < r1 <= per_row.shape[1]
        covered[u, r0:r1] += 1
        assert r1 - r0 <= max_rows  # the block's threads hold the span's outputs
        held = ptr[u, r1] - ptr[u, r0]  # one contiguous run of tiles
        assert held == per_row[u, r0:r1].sum()
        if r1 - r0 > 1:
            assert held <= max_tiles  # balanced: only a lone row may exceed the budget
        # Maximal: the span stopped at the unit's end, at the row limit, or
        # because the next row would carry it past the budget.
        if r1 < per_row.shape[1] and r1 - r0 < max_rows:
            assert held + per_row[u, r1] > max_tiles
    np.testing.assert_array_equal(covered, 1)  # every (unit, row) exactly once
    # Spans of a unit are in row order, and units in order.
    keys = spans[:, 0].astype(np.int64) * (per_row.shape[1] + 1) + spans[:, 1]
    assert (np.diff(keys) > 0).all()


def test_tile_set_carries_its_spans():
    dp = _plan(banded_coo, 4, 16, 16)
    bt = bell_tiles(torch.as_tensor(dp.tiles), dp.tile_row, dp.tile_col, dp.real_tiles,
                    dp.num_row_blocks)
    assert bt.spans.dtype == torch.int32
    np.testing.assert_array_equal(bt.spans.numpy(), row_spans(bt.row_ptr.numpy(), 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("bm,bn,b,variant", [
    (16, 16, 1, "stream"), (16, 16, 8, "stream"), (16, 16, 64, "stream"),  # the main path
    (8, 8, 3, "stream"), (32, 32, 17, "stream"), (8, 32, 64, "stream"),
    (8, 128, 8, "simt"), (64, 16, 8, "simt"), (128, 128, 1, "simt"), (128, 128, 64, "simt"),
    # stream takes only what csrc/bell_spmm.cu instantiates: bm a multiple
    # of 8 up to 32, bn in {8, 16, 32}; every other shape goes to simt.
    (8, 8, 8, "stream"), (32, 32, 8, "stream"), (24, 16, 8, "stream"),
    (16, 24, 8, "simt"), (12, 16, 8, "simt"), (64, 64, 8, "simt"), (4, 4, 8, "simt"),
    (16, 12, 1, "simt"), (40, 8, 8, "simt"),
])
def test_spmm_variant(dtype, bm, bn, b, variant):
    assert spmm_variant(dtype, bm, bn, b) == variant


def test_spmm_variant_sends_stream_only_its_instantiations():
    """Every shape up to 40 x 40: stream exactly where launch_stream has an
    instantiation, whatever the type and batch width."""
    for dtype in (torch.float32, torch.float16):
        for bm in range(1, 41):
            for bn in range(1, 41):
                want = bm % 8 == 0 and bm <= 32 and bn in (8, 16, 32)
                for b in (1, 8):
                    assert (spmm_variant(dtype, bm, bn, b) == "stream") == want, (bm, bn)


@pytest.mark.parametrize("bm,bn,b,fits", [
    (16, 16, 8, True), (128, 128, 64, True), (16, 24, 8, True), (12, 12, 1, True),
    (1024, 1, 1, True), (1025, 1, 1, False),  # outputs a block holds
    (128, 192, 1, False), (96, 256, 4, False), (8, 2700, 1, True), (8, 2800, 1, False),
])
def test_simt_limit(bm, bn, b, fits):
    """The simt kernel's shared memory (a float32 tile and its x block) and
    outputs a block: the wrapper raises before a launch that would not fit,
    naming the limit."""
    msg = simt_limit(bm, bn, b)
    assert (msg is None) == fits
    if not fits:
        assert "simt" in msg and ("outputs" in msg or "shared memory" in msg)


# -- the single-shard entry points -------------------------------------------


@pytest.mark.parametrize("bm,bn", [(8, 8), (16, 16), (8, 12)])
def test_shard_entry_points_match_jax(bm, bn):
    """``pack_bell`` → ``pack_inputs`` → ``spmm_shard`` / ``spmv_shard``
    (and their ``*_ref``) on CPU tensors against the JAX package's
    ``*_ref`` on the JAX package's own shards, each column against the
    B = 1 call — the counterpart of tests/test_batched.py's kernel case,
    whose Pallas side fails in interpret mode on this JAX."""
    a = random_coo(192, 1500, seed=0)
    owner = nezgt_partition(tile_counts(a, bm, bn), 3).assignment
    bell = pack_bell(COO(a.shape, a.row, a.col, a.val), owner, 3, bm, bn)
    ref = jx_pack_bell(a, owner, 3, bm, bn)
    assert bell.lb_tiles == ref.lb_tiles
    xs = np.random.default_rng(1).standard_normal((8, a.shape[1])).astype(np.float32)
    for shard, jshard in zip(bell.shards, ref.shards, strict=True):
        for f in ("tiles", "tile_row", "tile_col", "row_blocks"):
            np.testing.assert_array_equal(getattr(shard, f), getattr(jshard, f))
        assert shard.num_real == jshard.num_real
        r = len(shard.row_blocks)
        tiles, tr, tc, xb = pack_inputs(shard, xs, bn, device="cpu")
        assert xb.shape[-1] == 8 and tiles.device.type == "cpu"
        y_o = np.asarray(jx_spmm_shard_ref(*jx_pack_inputs(jshard, xs, bn), r))
        y_k = spmm_shard(tiles, tr, tc, xb, r).numpy()
        assert y_k.shape == (r, bm, 8)
        np.testing.assert_allclose(y_k, y_o, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(spmm_shard_ref(tiles, tr, tc, xb, r).numpy(), y_o,
                                   rtol=1e-5, atol=1e-5)
        for i in range(8):
            _, _, _, xb1 = pack_inputs(shard, xs[i], bn, device="cpu")
            y1 = spmv_shard(tiles, tr, tc, xb1, r).numpy()
            np.testing.assert_array_equal(y1, y_k[..., i])  # columns independent of B
            y1_o = np.asarray(jx_spmv_shard_ref(*jx_pack_inputs(jshard, xs[i], bn), r))
            np.testing.assert_allclose(y1, y1_o, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(spmv_shard_ref(tiles, tr, tc, xb1, r).numpy(), y1_o,
                                       rtol=1e-5, atol=1e-5)


def test_pack_inputs_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_coo(64, 300, seed=2)
    bell = pack_bell(COO(a.shape, a.row, a.col, a.val), np.zeros(8, np.int64), 1, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_inputs(bell.shards[0], np.ones(64, np.float32), 8)
