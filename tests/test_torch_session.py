"""The slice end to end on the CPU: ``distribute`` → ``spmv`` → ``solve`` in
the port against the JAX package, both on the port's own plans and on
the JAX package's plan carried over by ``session_from_numpy`` (which
separates executor parity from planning parity), plus the session's
contracts: dtypes, value views, derived sessions, solver bookkeeping."""
import dataclasses

import numpy as np
import pytest

import repro.api as jx
import repro_torch.api as pt
from repro.sparse.formats import coo_from_dense
from repro.sparse.generate import PAPER_SUITE, generate
from repro_torch.sparse.formats import COO as PtCOO

TOPO = (2, 2)
EXCHANGES = ("replicated", "selective", "overlap", "overlap:2")


def _rel(y, y_ref):
    return float(np.abs(y - y_ref).max() / (np.abs(y_ref).max() + 1e-30))


def _pt_coo(a):
    return PtCOO(a.shape, a.row, a.col, a.val)


def _spd(n=128, seed=3):
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((n, n)) < 0.06, rng.standard_normal((n, n)), 0.0)
    return coo_from_dense((m @ m.T + n * np.eye(n)).astype(np.float32))


def _fields(obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in skip}


def _carry_over(j, device="cpu"):
    """The JAX session's matrix and plan, as plain arrays, into the port."""
    a, sp = j.matrix, j.selective
    kw = {}
    if sp is not None:
        if hasattr(sp, "local_tiles"):
            kw["selective"] = _fields(sp.selective)
            kw["overlap"] = _fields(sp, skip=("selective",))
        else:
            kw["selective"] = _fields(sp)
    return pt.session_from_numpy(
        shape=a.shape, row=a.row, col=a.col, val=a.val,
        topology=(j.topology.nodes, j.topology.cores), combo=j.combo,
        elem_unit=j.partition.elem_unit,
        device_plan=_fields(j.device_plan, skip=("shape",)),
        exchange=j.exchange, device=device, **kw,
    )


def _sessions(a, exchange, via, combo="NL-HC"):
    j = jx.distribute(a, topology=jx.Topology(*TOPO), combo=combo, exchange=exchange)
    if via == "interop":
        p = _carry_over(j)
    else:
        p = pt.distribute(_pt_coo(a), topology=pt.Topology(*TOPO), combo=combo,
                          exchange=exchange, device="cpu")
    return j, p


@pytest.fixture(scope="module")
def t2dal():
    return generate(PAPER_SUITE["t2dal"], seed=0)


@pytest.mark.parametrize("via", ["interop", "planned"])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_spmv_matches_jax_and_reference(t2dal, exchange, via):
    j, p = _sessions(t2dal, exchange, via)
    rng = np.random.default_rng(1)
    for shape in ((t2dal.shape[1],), (8, t2dal.shape[1])):
        x = rng.standard_normal(shape).astype(np.float32)
        y = p.spmv(x)
        assert y.shape == x.shape[:-1] + (t2dal.shape[0],) and y.dtype == np.float32
        assert _rel(y, j.spmv(x)) < 1e-5
        y_ref = p.spmv(x, executor="reference")
        np.testing.assert_array_equal(y_ref, j.spmv(x, executor="reference"))
        assert _rel(y, y_ref) < 1e-6  # ~1e-7: float32 against the float64 oracle


@pytest.mark.parametrize("block", [4, 24, (16, 12)], ids=["4", "24", "16x12"])
@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap:2"])
def test_block_shapes_off_the_kernel_grid_match_jax(t2dal, exchange, block):
    """Tile shapes outside BLOCK_SIZES plan and run as in the JAX package
    (on the card they go to the simt kernel)."""
    j = jx.distribute(t2dal, topology=jx.Topology(*TOPO), combo="NL-HC", exchange=exchange,
                      block=block)
    p = pt.distribute(_pt_coo(t2dal), topology=pt.Topology(*TOPO), combo="NL-HC",
                      exchange=exchange, block=block, device="cpu")
    bm, bn = (block, block) if isinstance(block, int) else block
    assert (p.device_plan.bm, p.device_plan.bn) == (bm, bn)
    np.testing.assert_array_equal(p.device_plan.tiles, j.device_plan.tiles)
    x = np.random.default_rng(2).standard_normal((3, t2dal.shape[1])).astype(np.float32)
    y = p.spmv(x)
    assert _rel(y, j.spmv(x)) < 1e-5
    assert _rel(y, p.spmv(x, executor="reference")) < 1e-6


def _solver_cases(n):
    rng = np.random.default_rng(7)
    seeds = (rng.random((3, n)) < 0.05).astype(np.float32)
    seeds[:, 0] = 1.0
    return {
        "power_iteration": {"iters": 12},
        "block_power_iteration": {"iters": 10, "block": 4},
        "jacobi": {"iters": 12, "b": rng.standard_normal(n).astype(np.float32)},
        "jacobi_batched": {"iters": 12, "b": rng.standard_normal((3, n)).astype(np.float32)},
        "pagerank": {"iters": 12},
        "pagerank_multi": {"iters": 12, "seeds": seeds},
        "cg": {"iters": 15, "b": rng.standard_normal(n).astype(np.float32)},
        "cg_batched": {"iters": 15, "b": rng.standard_normal((3, n)).astype(np.float32)},
    }


CASES = list(_solver_cases(1))


@pytest.mark.parametrize("via", ["interop", "planned"])
@pytest.mark.parametrize("device_loop", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_solvers_match_jax(case, device_loop, via):
    a = _spd()
    exchange = "overlap:2" if case.endswith(("batched", "multi")) else "selective"
    j, p = _sessions(a, exchange, via)
    kw = _solver_cases(a.shape[0])[case]
    solver = case.split("_batched")[0].split("_multi")[0]
    # The JAX package's cg has no device loop: hold the port's to its host loop.
    jx_loop = device_loop and solver != "cg"
    r_j = j.solve(solver, device_loop=jx_loop, **kw) if solver != "cg" else j.solve(solver, **kw)
    r_p = p.solve(solver, device_loop=device_loop, **kw)
    assert r_p.solver == r_j.solver
    assert r_p.iters_run == r_j.iters_run
    assert r_p.converged == r_j.converged
    assert len(r_p.residuals) == len(r_j.residuals)
    assert r_p.x.shape == r_j.x.shape and r_p.x.dtype == np.float32
    assert r_p.value == pytest.approx(r_j.value, rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(r_p.residuals, r_j.residuals, rtol=1e-4, atol=1e-6)
    if solver == "block_power_iteration":  # an orthonormal basis, each row up to sign
        assert _rel(np.abs(r_p.x), np.abs(r_j.x)) < 1e-4
    else:
        assert _rel(r_p.x, r_j.x) < 1e-5


@pytest.mark.parametrize("solver,kw", [
    ("power_iteration", {}), ("jacobi", {}), ("pagerank", {}), ("cg", {}),
])
@pytest.mark.parametrize("device_loop", [False, True])
def test_tol_early_stop_bookkeeping_matches_jax(solver, kw, device_loop):
    a = _spd()
    j, p = _sessions(a, "selective", "interop")
    r_j = j.solve(solver, iters=200, tol=1e-3, **kw)
    r_p = p.solve(solver, iters=200, tol=1e-3, device_loop=device_loop, **kw)
    assert r_p.converged and r_j.converged
    assert r_p.iters_run == r_j.iters_run < 200
    assert len(r_p.residuals) == r_p.iters_run + (1 if solver == "cg" else 0)


@pytest.mark.parametrize("device_loop", [False, True])
def test_cg_breakdown_branch(device_loop):
    p = pt.distribute(_pt_coo(_spd()), topology=pt.Topology(*TOPO), combo="NL-HC",
                      device="cpu")
    n = p.matrix.shape[0]
    res = p.solve("cg", iters=30, b=np.zeros(n, np.float32), device_loop=device_loop)
    assert res.iters_run == 1 and not res.converged
    assert res.residuals == [0.0]
    np.testing.assert_array_equal(res.x, np.zeros(n, np.float32))
    batched = p.solve("cg", iters=5, b=np.zeros((2, n), np.float32),
                      device_loop=device_loop)
    assert batched.iters_run == 5 and batched.residuals == [0.0] * 5


@pytest.mark.parametrize("executor", ["simulate", "reference"])
def test_spmv_dtype_contract(t2dal, executor):
    p = pt.distribute(_pt_coo(t2dal), topology=pt.Topology(*TOPO), combo="NL-HC",
                      device="cpu")
    x = np.random.default_rng(2).standard_normal(t2dal.shape[1])
    for xin in (x, np.stack([x, 2 * x])):
        for dtype in (np.float64, np.float16):
            y = p.spmv(xin.astype(dtype), executor=executor)
            assert y.dtype == dtype and y.shape == xin.shape
    y32 = p.spmv(x.astype(np.float32), executor=executor)
    np.testing.assert_allclose(p.spmv(x, executor=executor), y32, rtol=1e-5, atol=1e-4)
    with pytest.raises(TypeError, match="float"):
        p.spmv(np.arange(t2dal.shape[1]), executor=executor)


def test_with_value_map_is_a_view_equal_to_a_copy(t2dal):
    p = pt.distribute(_pt_coo(t2dal), topology=pt.Topology(*TOPO), combo="NL-HC",
                      exchange="overlap", device="cpu")
    x = np.random.default_rng(3).standard_normal(t2dal.shape[1]).astype(np.float32)
    view = p.with_value_map(np.abs)
    assert view.device_plan.tiles is p.device_plan.tiles
    assert view.selective.local_tiles is p.selective.local_tiles
    assert view.tile_transform is np.abs
    np.testing.assert_array_equal(view.matrix.val, np.abs(t2dal.val))
    copy = p.with_value_map(np.abs, materialize=True)
    assert copy.device_plan.tiles is not p.device_plan.tiles
    for ex in ("simulate", "reference"):
        np.testing.assert_array_equal(view.spmv(x, executor=ex), copy.spmv(x, executor=ex))
    twice = view.with_value_map(np.negative).with_value_map(np.abs)
    assert twice.device_plan.tiles is p.device_plan.tiles
    np.testing.assert_array_equal(twice.spmv(x), view.spmv(x))
    odd = p.with_value_map(lambda t: 0.5 * t)  # no device twin: mapped on the host
    np.testing.assert_allclose(odd.spmv(x), 0.5 * p.spmv(x), rtol=1e-6, atol=1e-6)
    j = jx.distribute(t2dal, topology=jx.Topology(*TOPO), combo="NL-HC", exchange="overlap")
    assert _rel(view.spmv(x), j.with_value_map(np.abs).spmv(x)) < 1e-5
    res = p.solve("pagerank", iters=8)
    assert np.isclose(res.x.sum(), 1.0, atol=1e-4)
    assert p._abs_link[0].device_plan.tiles is p.device_plan.tiles


def test_derived_sessions_share_or_rebuild_state(t2dal):
    p = pt.distribute(_pt_coo(t2dal), topology=pt.Topology(*TOPO), combo="NL-HC",
                      device="cpu")
    x = np.random.default_rng(4).standard_normal(t2dal.shape[1]).astype(np.float32)
    y = p.spmv(x)
    ref = p.with_executor("reference")
    assert ref.executor == "reference" and ref.device_plan is p.device_plan
    assert ref._spmv_cache is p._spmv_cache
    assert ref.device_spmm() is p.device_spmm()
    with pytest.raises(KeyError, match="unknown executor"):
        p.with_executor("nope")
    for ex in ("replicated", "overlap:2"):
        other = p.with_exchange(ex)
        assert other.exchange == ex and other._spmv_cache == {}
        assert _rel(other.spmv(x), y) < 1e-5
    c_j = jx.distribute(t2dal, topology=jx.Topology(*TOPO), combo="NL-HC").costs(batch=4)
    assert p.costs(batch=4) == c_j
    assert "device='cpu'" in repr(p)
