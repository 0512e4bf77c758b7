"""The port's tracer (``repro_torch.trace``): nothing recorded and no
clock read while it is off; on, the spans of a device-loop CG solve nest
solve → iteration → product → phases under one root, the exchange's
bytes are counted from shapes, ``distribute``'s phases fit inside its
wall time, and the buffer stops at its capacity."""
import ast
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.api import Topology, distribute
from repro_torch.api.session import LOCALITY_GRID
from repro_torch.pmvc import dist
from repro_torch.sparse.formats import COO
from _torch_one_rank import OneRankChain
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

EXCHANGES = ("replicated", "selective", "overlap:2")
PHASES = ("spmv.pad_x", "spmv.kernel", "spmv.unit_sum", "spmv.unblock_y")
TRACE_PY = os.path.join(os.path.dirname(__file__), os.pardir, "src", "repro_torch", "trace.py")


def _spd(n=96, seed=5):
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((n, n)) < 0.08, rng.standard_normal((n, n)), 0.0)
    d = (m @ m.T + n * np.eye(n)).astype(np.float32)
    row, col = np.nonzero(d)
    return COO(d.shape, row.astype(np.int32), col.astype(np.int32), d[row, col])


def _session(exchange):
    return distribute(_spd(), topology=Topology(2, 2), combo="NL-HC", exchange=exchange,
                      block=8, device="cpu")


def _rhs(batch, n=96):
    """``[batch, n]``, or one ``[n]`` vector for ``batch=0``."""
    b = np.random.default_rng(7).standard_normal((max(batch, 1), n)).astype(np.float32)
    return b if batch else b[0]


@pytest.fixture(autouse=True)
def cleared():
    """Each test starts and ends with the tracer off and empty."""
    trace.enable()
    trace.disable()
    yield
    trace.enable()
    trace.disable()


@pytest.fixture
def clock_reads(monkeypatch):
    """How often ``repro_torch.trace`` reads ``time.perf_counter_ns``."""
    reads = Counter()
    real = time.perf_counter_ns

    def counting():
        reads[sys._getframe(1).f_globals.get("__name__")] += 1
        return real()

    monkeypatch.setattr(time, "perf_counter_ns", counting)
    return reads


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_off_records_nothing_and_reads_no_clock(exchange, clock_reads):
    sess = _session(exchange)
    sess.solve("cg", b=_rhs(1), iters=4, tol=0.0, device_loop=True)
    sess.solve("cg", b=_rhs(0), iters=4, tol=0.0, device_loop=True)
    assert trace.on is False
    assert trace.spans() == [] and trace.counters() == {}
    assert clock_reads["repro_torch.trace"] == 0
    trace.enable()  # the same calls, on, do read it: the count above is live
    sess.solve("cg", b=_rhs(1), iters=1, tol=0.0, device_loop=True)
    assert clock_reads["repro_torch.trace"] > 0


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("batch", [0, 1, 3])
def test_spans_of_a_solve_nest_under_one_root(exchange, batch):
    iters = 5
    sess = _session(exchange)
    trace.enable()
    res = sess.solve("cg", b=_rhs(batch), iters=iters, tol=0.0, device_loop=True)
    trace.disable()
    assert res.iters_run == iters
    recs = trace.spans()
    by_id = {r[3]: r for r in recs}
    names = Counter(r[0] for r in recs)
    (solve,) = [r for r in recs if r[0] == "solve.cg"]
    assert all(r[5] == solve[3] for r in recs)  # one root: the solve
    assert solve[4] == 0
    iters_ = [r for r in recs if r[0] == "cg.iter"]
    assert len(iters_) == iters and all(r[4] == solve[3] for r in iters_)
    calls = [r for r in recs if r[0] == "spmv.call"]
    assert len(calls) == iters + 1
    parents = Counter(by_id[r[4]][0] for r in calls)
    assert parents == {"cg.iter": iters, "solve.cg": 1}  # the initial residual's product
    waves = int(exchange.split(":")[1]) if ":" in exchange else 0
    for phase in PHASES + ("spmv.exchange",):
        spans = [r for r in recs if r[0] == phase]
        assert all(by_id[r[4]][0] == "spmv.call" for r in spans), phase
    assert names["spmv.kernel"] == len(calls) * (1 + waves)
    expected_exchanges = {"replicated": 0, "selective": 1}.get(exchange, 1 + waves)
    assert names["spmv.exchange"] == len(calls) * expected_exchanges
    for phase in ("spmv.pad_x", "spmv.unit_sum", "spmv.unblock_y"):
        assert names[phase] == len(calls), phase
    for r in recs:  # each span inside its parent
        assert r[1] <= r[2]
        if r[4]:
            parent = by_id[r[4]]
            assert parent[1] <= r[1] and r[2] <= parent[2]


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_the_exchange_counts_the_bytes_its_gathers_write(exchange):
    batch = 3
    sess = _session(exchange)
    trace.enable()
    sess.solve("cg", b=_rhs(batch), iters=2, tol=0.0, device_loop=True)
    trace.disable()
    counted = trace.counters().get("spmv.exchange_bytes", 0)
    sp = sess.selective
    if sp is None:
        assert counted == 0
        return
    # One device: each exchange is composed into one gather, which
    # writes the workspaces alone (every wave's, under overlap).
    slots = sp.wave_recv_src.size if hasattr(sp, "wave_recv_src") else sp.recv_src.size
    calls = sum(1 for r in trace.spans() if r[0] == "spmv.call")
    assert counted == calls * slots * sess.device_plan.bn * batch * 4


@pytest.mark.parametrize("exchange", EXCHANGES[1:])
def test_the_exchange_across_ranks_counts_its_send_buffers_and_workspaces(exchange):
    """A step over a real communicator keeps the three steps: its
    gathers write the send buffers and the workspaces (every wave's,
    under overlap), and no product counts as composed."""
    batch, calls = 3, 2
    sess = _session(exchange)
    dp, sp = sess.device_plan, sess.selective
    step = dist.make_pmvc_step(dp, dist.make_unit_mesh(dp.num_units, comm=OneRankChain()),
                               selective=sp, device="cpu")
    xb = torch.ones((dp.num_col_blocks, dp.bn, batch))
    trace.enable()
    for _ in range(calls):
        step(xb)
    trace.disable()
    counters = trace.counters()
    if hasattr(sp, "wave_send_idx"):
        slots = sp.wave_send_idx.size + sp.wave_recv_src.size
    else:
        slots = sp.send_idx.size + sp.recv_src.size
    assert counters.get("spmv.exchange_bytes", 0) == calls * slots * dp.bn * batch * 4
    assert counters.get("spmv.exchange_composed", 0) == 0


@pytest.mark.parametrize("batch", [0, 2])
def test_the_solution_is_bitwise_the_same_on_and_off(batch):
    sess = _session("selective")
    off = sess.solve("cg", b=_rhs(batch), iters=6, tol=0.0, device_loop=True)
    trace.enable()
    on = sess.solve("cg", b=_rhs(batch), iters=6, tol=0.0, device_loop=True)
    trace.disable()
    assert np.array_equal(off.x, on.x) and off.residuals == on.residuals


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_plan_phases_fit_inside_distribute(exchange):
    trace.enable()
    t0 = time.perf_counter_ns()
    _session(exchange)
    t1 = time.perf_counter_ns()
    trace.disable()
    recs = trace.spans()
    names = Counter(r[0] for r in recs)
    # An overlap exchange screens every locality weight, then plans the winner.
    plans = len(LOCALITY_GRID) + 1 if exchange.startswith("overlap") else 1
    assert names == {"plan.partition": plans, "plan.pack": plans, "plan.exchange": plans}
    assert all(t0 <= r[1] <= r[2] <= t1 and r[4] == 0 for r in recs)
    assert sum(r[2] - r[1] for r in recs) <= t1 - t0


def test_the_buffer_stops_at_its_capacity():
    trace.enable(capacity=3)
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    trace.count("n", 2)
    trace.count("n", 3)
    trace.disable()
    with trace.span("after"):  # off: nothing recorded, nothing dropped
        pass
    trace.count("n", 100)
    assert [r[0] for r in trace.spans()] == ["s0", "s1", "s2"]
    assert trace.counters() == {"n": 5, "trace.dropped": 2}
    trace.enable()  # a fresh buffer, counters at zero
    assert trace.spans() == [] and trace.counters() == {}
    with pytest.raises(ValueError):
        trace.enable(capacity=0)


def test_each_thread_nests_its_own_spans():
    trace.enable()
    with trace.span("outer"):
        worker = threading.Thread(target=_one_span, args=("other",))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with trace.span("inner"):
            pass
    trace.disable()
    by_name = {r[0]: r for r in trace.spans()}
    assert by_name["inner"][4] == by_name["outer"][3] == by_name["inner"][5]
    assert by_name["other"][4] == 0 and by_name["other"][5] == by_name["other"][3]


def _one_span(name):
    with trace.span(name):
        pass


def test_the_tracer_imports_only_the_standard_library():
    tree = ast.parse(open(TRACE_PY).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names and names <= set(sys.stdlib_module_names) | {"__future__"}, names
