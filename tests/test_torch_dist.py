"""The port's single-device PMVC executor (``repro_torch.pmvc.dist``)
against the JAX package's ``repro.pmvc.dist`` on the same plans: every
exchange regime at 1e-5, bitwise agreement across wave counts on
integer data, and the layout helpers."""
import dataclasses

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
from repro_torch import trace
from repro_torch.api import Topology, distribute
from repro_torch.kernels.spmv.gather import gather_rows
from repro_torch.pmvc import dist
from repro_torch.pmvc.plan_device import (
    build_overlap_plan,
    build_selective_plan,
    pack_units,
)
from repro_torch.sparse.formats import COO
from _torch_one_rank import OneRankChain
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("u", [1, 2, 16])
@pytest.mark.parametrize("b", [1, 8])
def test_unit_sum_is_the_cumsum_it_replaces(u, b):
    """``unit_sum`` is bitwise the last prefix of ``cumsum(dim=0)`` (the
    unit sum before deterministic mode had to accept it) on random
    partials, and column j of any B is bitwise the B = 1 sum of column j.
    It runs under ``torch.use_deterministic_algorithms(True)``."""
    rng = np.random.default_rng(u * 10 + b)
    partials = torch.as_tensor(
        (rng.standard_normal((u, 30, 8, b)) * 10.0 ** rng.integers(-3, 4, (u, 30, 8, b)))
        .astype(np.float32))
    want = partials.cumsum(dim=0)[-1]
    got = dist.unit_sum(partials)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    for j in range(b):
        assert torch.equal(dist.unit_sum(partials[..., j:j + 1].contiguous())[..., 0],
                           got[..., j])
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.equal(dist.unit_sum(partials), want)
    finally:
        torch.use_deterministic_algorithms(before)


def _one_device_plan(kind, regime):
    """A banded matrix under NC-HC (units need different halos, some
    workspace slots are zero blocks) or a random one, elements dealt to
    units at random."""
    if kind == "banded-NC-HC":
        a = banded_coo(192, 2000, seed=11)
        sess = distribute(COO(a.shape, a.row, a.col, a.val), topology=Topology(2, 2),
                          combo="NC-HC", exchange=regime, block=8, device="cpu")
        return sess.device_plan, sess.selective
    pt_dp, _ = _plans(random_coo(150, 1500, seed=6), 6)
    ex = build_selective_plan(pt_dp) if regime == "selective" else build_overlap_plan(pt_dp, waves=2)
    return pt_dp, ex


@pytest.mark.parametrize("kind", ["banded-NC-HC", "random"])
@pytest.mark.parametrize("regime", ["selective", "overlap:2"])
@pytest.mark.parametrize("b", [1, 4])
def test_the_one_device_exchange_is_one_gather_bitwise_the_chain(monkeypatch, kind, regime, b):
    """Over a ``LocalCommunicator`` each exchange is one gather of x into
    the workspaces (−1 a zero block), composed when the step is built:
    its workspaces, then y, are bitwise those of the three-step chain a
    real communicator runs, and the counter ``spmv.exchange_composed``
    counts one a call."""
    dp, ex = _one_device_plan(kind, regime)
    composed = dist.make_pmvc_step(dp, dist.make_unit_mesh(dp.num_units, comm=dist.LocalCommunicator()),
                                   selective=ex, device=CPU)
    chain = dist.make_pmvc_step(dp, dist.make_unit_mesh(dp.num_units, comm=OneRankChain()),
                                selective=ex, device=CPU)
    xb = torch.randn((dp.num_col_blocks, dp.bn, b), generator=torch.Generator().manual_seed(b))

    gathers = {}
    orig = dist._workspace

    def record(name):
        def workspace(*a):
            ws = orig(*a)
            gathers[name].append((a, ws.clone()))
            return ws
        return workspace

    ys = {}
    for name, step in (("composed", composed), ("chain", chain)):
        gathers[name] = []
        monkeypatch.setattr(dist, "_workspace", record(name))
        if name == "composed":  # no send buffer, and owned blocks only for overlap's local set
            monkeypatch.setattr(dist, "_send_buffer", None)
        ys[name] = step(xb)
        monkeypatch.undo()

    waves = 2 if regime == "overlap:2" else 1
    assert len(gathers["composed"]) == len(gathers["chain"]) == waves
    assert len(composed.exchanges) == len(chain.exchanges) == waves
    for (args, ws), (_, want), ex in zip(gathers["composed"], gathers["chain"], composed.exchanges):
        assert args[0] is xb and args[1] is ex.index  # straight from x, by the step's index
        assert ws.shape == want.shape and torch.equal(ws, want)
    filled = [(args[1] < 0, ws) for args, ws in gathers["composed"] if bool((args[1] < 0).any())]
    if kind == "banded-NC-HC":  # zero-block slots are exercised
        assert filled
    for zero, ws in filled:
        assert not ws[zero].any()
    assert torch.equal(ys["composed"], ys["chain"])

    rep = dist.make_simulate_fn(dp, None, device=CPU)
    trace.enable()
    try:
        for _ in range(3):
            composed(xb)
        after_composed = trace.counters().get("spmv.exchange_composed", 0)
        chain(xb)
        rep(xb)
        counted = trace.counters().get("spmv.exchange_composed", 0)
    finally:
        trace.disable()
    assert after_composed == counted == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_gather_rows_takes_rows_and_zero_rows(dtype):
    """The exchange's gather off the card: rows of any element type by an
    int64 index, −1 a zero row; another index type is refused."""
    src = torch.arange(1, 25).to(dtype).reshape(6, 2, 2)
    index = torch.tensor([[5, -1, 0], [-1, 5, 2]])
    out = gather_rows(src, index)
    assert out.shape == (2, 3, 2, 2) and out.dtype == dtype
    want = torch.stack([src[5], torch.zeros(2, 2, dtype=dtype), src[0],
                        torch.zeros(2, 2, dtype=dtype), src[5], src[2]]).reshape(out.shape)
    assert torch.equal(out, want)
    assert torch.equal(gather_rows(src, index.clamp(min=0)), src[index.clamp(min=0)])
    with pytest.raises(ValueError, match="int64"):
        gather_rows(src, index.int())


def test_a_receive_index_past_the_buffer_is_refused():
    """A plan whose receive lanes or source units point past what
    arrives is refused when the step is built, on one device and across
    ranks, before any pointer reaches the kernel."""
    dp, sp = _one_device_plan("random", "selective")
    lane = sp.recv_lane.copy()
    lane[0, 0] = sp.send_idx.shape[-1]
    bad = dataclasses.replace(sp, recv_lane=lane)
    src = sp.recv_src.copy()
    src[-1, -1] = dp.num_units
    for bad in (bad, dataclasses.replace(sp, recv_src=src)):
        for comm in (OneRankChain(), dist.LocalCommunicator()):
            with pytest.raises(ValueError, match="outside the received buffer"):
                dist.make_pmvc_step(dp, dist.make_unit_mesh(dp.num_units, comm=comm),
                                    selective=bad, device=CPU)
