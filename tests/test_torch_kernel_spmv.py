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

from repro.kernels.spmv import bell_spmm_ref as jx_bell_spmm_ref
from repro.pmvc.plan_device import pack_units as jx_pack_units
from repro.sparse.generate import banded_coo, grid5_coo, random_coo
from repro_torch.kernels.spmv import bell_spmm, bell_spmm_plain, bell_tiles
from repro_torch.pmvc.plan_device import pack_units
from repro_torch.sparse.bell import pad_x_blocks
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


@pytest.mark.parametrize("bm,bn", [(8, 8), (8, 16), (16, 16), (8, 128)])
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
    with pytest.raises(ValueError, match="not in"):
        bell_tiles(torch.zeros((UNITS, dp.t, 8, 12)), dp.tile_row, dp.tile_col,
                   dp.real_tiles, nrb)
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
