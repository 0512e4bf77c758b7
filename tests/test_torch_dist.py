"""The port's single-device PMVC executor (``repro_torch.pmvc.dist``)
against the JAX package's ``repro.pmvc.dist`` on the same plans: every
exchange regime at 1e-5, bitwise agreement across wave counts on
integer data, and the layout helpers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pmvc import dist as jx_dist
from repro.pmvc.plan_device import (
    build_overlap_plan as jx_build_overlap_plan,
    build_selective_plan as jx_build_selective_plan,
    pack_units as jx_pack_units,
)
from repro.sparse.bell import pad_x_blocks as jx_pad_x_blocks
from repro.sparse.formats import COO as JxCOO, dense_from_coo
from repro.sparse.generate import banded_coo, random_coo
from repro_torch.pmvc import dist
from repro_torch.pmvc.plan_device import (
    build_overlap_plan,
    build_selective_plan,
    pack_units,
)
from repro_torch.sparse.formats import COO

CPU = torch.device("cpu")
UNITS = 4


def _plans(a, seed, bm=8, bn=8):
    elem_unit = np.random.default_rng(seed).integers(0, UNITS, size=a.nnz)
    pt_a = COO(a.shape, a.row, a.col, a.val)
    pt_dp = pack_units(pt_a, elem_unit, UNITS, bm, bn)
    jx_dp = jx_pack_units(a, elem_unit, UNITS, bm, bn)
    return pt_dp, jx_dp


def _exchange(pt_dp, jx_dp, regime):
    if regime == "replicated":
        return None, None
    if regime == "selective":
        return build_selective_plan(pt_dp), jx_build_selective_plan(jx_dp)
    waves = int(regime.split(":")[1])
    return build_overlap_plan(pt_dp, waves=waves), jx_build_overlap_plan(jx_dp, waves=waves)


@pytest.mark.parametrize("regime", ["replicated", "selective", "overlap:1", "overlap:2"])
@pytest.mark.parametrize("b", [None, 1, 8])
def test_simulate_fn_matches_jax(regime, b):
    a = banded_coo(200, 2400, seed=3)
    pt_dp, jx_dp = _plans(a, 3)
    pt_ex, jx_ex = _exchange(pt_dp, jx_dp, regime)
    rng = np.random.default_rng(4)
    shape = (a.shape[1],) if b is None else (b, a.shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    xb = jx_pad_x_blocks(x, jx_dp.num_col_blocks, jx_dp.bn)
    y_jx = np.asarray(jx_dist.make_simulate_fn(jx_dp, jx_ex)(jnp.asarray(xb)))
    run = dist.make_simulate_fn(pt_dp, pt_ex, device=CPU)
    y_pt = run(torch.as_tensor(xb)).numpy()
    assert y_pt.shape == y_jx.shape
    np.testing.assert_allclose(y_pt, y_jx, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("regime", ["replicated", "selective", "overlap:2"])
def test_pmvc_simulate_entry_points_match_jax(regime):
    a = random_coo(150, 1500, seed=6)
    pt_dp, jx_dp = _plans(a, 6)
    pt_ex, jx_ex = _exchange(pt_dp, jx_dp, regime)
    x = np.random.default_rng(6).standard_normal((3, a.shape[1])).astype(np.float32)
    if regime == "replicated":
        y_pt = dist.pmvc_simulate(pt_dp, x, device=CPU)
        y_jx = jx_dist.pmvc_simulate(jx_dp, x)
    elif regime == "selective":
        y_pt = dist.pmvc_simulate_selective(pt_dp, pt_ex, x, device=CPU)
        y_jx = jx_dist.pmvc_simulate_selective(jx_dp, jx_ex, x)
    else:
        y_pt = dist.pmvc_simulate_overlap(pt_dp, pt_ex, x, device=CPU)
        y_jx = jx_dist.pmvc_simulate_overlap(jx_dp, jx_ex, x)
    np.testing.assert_allclose(y_pt, y_jx, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("waves", [1, 2, 3])
def test_integer_spmm_bitwise_across_waves_and_exchanges(waves):
    """Integer tiles and x: every float32 sum is exact, so every regime
    and wave count agrees bitwise with the dense product — as in the
    JAX package's test_overlap_waves."""
    a = random_coo(160, 1800, seed=waves)
    vals = np.random.default_rng(waves).integers(-3, 4, size=a.nnz).astype(np.float32)
    a_int = JxCOO(a.shape, a.row, a.col, vals)
    pt_dp, jx_dp = _plans(a_int, waves)
    x = np.random.default_rng(10 + waves).integers(-2, 3, size=(4, a.shape[1]))
    x = x.astype(np.float32)
    dense = x @ dense_from_coo(a_int).T.astype(np.float32)
    y_over = dist.pmvc_simulate_overlap(pt_dp, build_overlap_plan(pt_dp, waves=waves), x,
                                        device=CPU)
    y_sel = dist.pmvc_simulate_selective(pt_dp, build_selective_plan(pt_dp), x, device=CPU)
    y_rep = dist.pmvc_simulate(pt_dp, x, device=CPU)
    y_jx = jx_dist.pmvc_simulate_overlap(jx_dp, jx_build_overlap_plan(jx_dp, waves=waves), x)
    for y in (y_over, y_sel, y_rep, y_jx):
        np.testing.assert_array_equal(y, dense)


def test_layout_helpers_match_numpy():
    rng = np.random.default_rng(0)
    ncb, bn = 7, 8
    for shape in ((50,), (3, 50)):
        x = rng.standard_normal(shape).astype(np.float32)
        xb = dist.pad_x(torch.as_tensor(x), ncb, bn)
        np.testing.assert_array_equal(xb.numpy(), jx_pad_x_blocks(x, ncb, bn))
        y = rng.standard_normal((ncb, bn) + shape[:-1][::-1]).astype(np.float32)
        if y.ndim == 3:
            y = np.ascontiguousarray(y)
        np.testing.assert_array_equal(
            dist.unblock_y(torch.as_tensor(y), 50).numpy(), jx_dist.unblock_y(y, 50)
        )
    a = random_coo(120, 900, seed=2)
    pt_dp, jx_dp = _plans(a, 2)
    xb = jx_pad_x_blocks(rng.standard_normal((2, 120)).astype(np.float32), 15, 8)
    np.testing.assert_array_equal(
        dist.scatter_x_owned(build_selective_plan(pt_dp), torch.as_tensor(xb)).numpy(),
        jx_dist.scatter_x_owned(jx_build_selective_plan(jx_dp), xb),
    )


@pytest.mark.parametrize("fn", [None, np.abs, np.negative, np.square, np.sign,
                                lambda t: 2.0 * t])
def test_hoist_tiles_value_views_match_jax(fn):
    tiles = np.random.default_rng(1).standard_normal((2, 3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        dist.hoist_tiles(tiles, fn, device=CPU).numpy(),
        np.asarray(jx_dist.hoist_tiles(tiles, fn)),
    )
