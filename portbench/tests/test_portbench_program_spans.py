"""The program's own spans in traced runs (``repro_torch.trace``): the
harness turns its tracer on in a ``--trace 1`` run only and copies its
spans into the run, and the readers of those spans, by hand on a
synthetic trace and as None wherever the spans are not there."""
import os
import time

import pytest
from repro_torch import trace as program_trace

import portbench.trace
from portbench import harness, loops
from portbench.harness import reader
from portbench.loops import Context, Run
from portbench.matrices import make_graphs
from portbench.tests.pb_tiny import run, tiny
from portbench.trace import DeviceOp, DeviceTrace, Spans

READERS = ("cg_iter_host_ms", "device_ops_per_cg_iter", "spmv_exchange_ms", "unit_sum_ms",
           "plan_partition_s", "plan_pack_s")
PROGRAM = ("solve.cg", "cg.iter", "spmv.call", "plan.partition")


def _capture(monkeypatch) -> list:
    """The ``Run`` each reader is handed, kept as the harness reads it."""
    seen = []
    real = harness.reader

    def spy(name, root=harness.ROOT):
        read = real(name, root)

        def call(r):
            seen.append(r)
            return read(r)

        return call

    monkeypatch.setattr(harness, "reader", spy)
    return seen


def test_a_traced_run_carries_the_programs_spans(monkeypatch):
    seen = _capture(monkeypatch)
    out = run("hpcg64-cg-b1", trace=True)
    assert out["correct"] is True
    r = seen[0]
    names = {name for name, _, _ in r.spans.items}
    assert set(PROGRAM) <= names and {"solve", "spmv"} <= names
    assert r.program_counters is not None and "trace.dropped" not in r.program_counters
    assert r.program_counters["spmv.exchange_bytes"] > 0
    assert program_trace.on is False
    # The host's readers report on the CPU; the plan's phases fit in it.
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert {"cg_iter_host_ms", "plan_partition_s", "plan_pack_s"} <= set(m)
    assert 0 < m["plan_partition_s"] + m["plan_pack_s"] <= m["plan_s"]
    iters = r.spans.of("cg.iter", *r.window_ns)
    assert len(iters) == 50 * r.attempted


def test_an_untraced_run_leaves_the_programs_tracer_off(monkeypatch):
    seen = _capture(monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("an untraced run turned the program's tracer on")

    monkeypatch.setattr(program_trace, "enable", refuse)
    out = run("hpcg64-cg-b1")
    assert out["correct"] is True
    assert seen[0].spans is None and seen[0].program_counters is None


def test_an_overflowing_buffer_reads_nothing(monkeypatch):
    monkeypatch.setattr(harness, "PROGRAM_SPANS_SETUP", 8)
    monkeypatch.setattr(harness, "PROGRAM_SPANS_PER_S", 0)
    seen = _capture(monkeypatch)
    out = run("hpcg64-cg-b1", trace=True)
    assert out["correct"] is True
    assert seen[0].program_counters["trace.dropped"] > 0
    assert not set(READERS) & set(out["metrics"]) and "plan_s" in out["metrics"]


def test_the_buffer_holds_a_window():
    """Seven spans an iteration at 1,000 iterations a second, over the
    window, the profiler's start and the slice after it, and set-up."""
    seconds = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))["run_seconds"]
    spans = 7 * 1000 * (seconds + 2 * portbench.trace.SLICE_S)
    assert harness.PROGRAM_SPANS_SETUP + seconds * harness.PROGRAM_SPANS_PER_S > 4 * spans


# A synthetic trace (ns): two CG iterations, each one product with its
# exchange, kernel launch and unit sum. The first kernel's launch lands
# 1 ns inside its exchange span, as the trace's clock can put it.
SPANS = [("cg.iter", 1000, 1900), ("cg.iter", 2000, 2850),
         ("spmv.call", 1100, 1800), ("spmv.call", 2100, 2800),
         ("spmv.exchange", 1200, 1300), ("spmv.exchange", 2200, 2300),
         ("spmv.kernel", 1300, 1310), ("spmv.kernel", 2300, 2310),
         ("spmv.unit_sum", 1400, 1500), ("spmv.unit_sum", 2400, 2500),
         ("plan.partition", 10, 110), ("plan.partition", 200, 260), ("plan.pack", 110, 150),
         ("solve", 990, 2990), ("spmv", 1100, 1800), ("spmv", 2100, 2800)]
OPS = [DeviceOp("gather", 1500, 1540, 1250), DeviceOp("gather", 2500, 2560, 2250),
       DeviceOp("bell_spmm_ring_kernel", 1550, 1750, 1299),
       DeviceOp("bell_spmm_ring_kernel", 2570, 2770, 2305),
       DeviceOp("sum", 1760, 1780, 1450), DeviceOp("sum", 2780, 2790, 2450),
       DeviceOp("dot", 1800, 1810, 1890), DeviceOp("unlinked", 1850, 1860, None)]


def synthetic(counters=None, device=True, spans=SPANS) -> Run:
    s = Spans()
    s.extend(spans)
    dt = DeviceTrace(list(OPS), 1000, 3000, s) if device else None
    return Run(loop="solve", spans=s, device_trace=dt, window_ns=(1000, 3000),
               program_counters={} if counters is None else counters)


def test_the_readers_by_hand():
    r = synthetic()
    # The kernel launched in the exchange's span is the kernel's, not the exchange's.
    assert reader("spmv_exchange_ms")(r) == pytest.approx((40 + 60) / 2 / 1e6)
    assert reader("unit_sum_ms")(r) == pytest.approx((20 + 10) / 2 / 1e6)
    # Seven operations launched inside the two iterations; the unlinked one in none.
    assert reader("device_ops_per_cg_iter")(r) == pytest.approx(3.5)
    assert reader("plan_partition_s")(r) == pytest.approx(160e-9)
    assert reader("plan_pack_s")(r) == pytest.approx(40e-9)
    # The host's iterations before the profiled slice: none here; without
    # a device trace, both; with the slice from 1950, the first.
    assert reader("cg_iter_host_ms")(r) is None
    assert reader("cg_iter_host_ms")(synthetic(device=False)) == pytest.approx(875 / 1e6)
    r.device_trace.lo = 1950
    assert reader("cg_iter_host_ms")(r) == pytest.approx(900 / 1e6)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_returns_none_without_the_programs_spans(name):
    read = reader(name)
    assert read(Run(loop="solve")) is None  # untraced
    benchmark_only = [s for s in SPANS if "." not in s[0]]
    assert read(synthetic(spans=benchmark_only)) is None  # the program's spans absent
    parent = synthetic()
    parent.program_counters = None  # a program without the tracer
    assert read(parent) is None
    assert read(synthetic({"trace.dropped": 1})) is None  # the buffer overflowed
    assert read(synthetic()) is not None or name == "cg_iter_host_ms"


class FakeProfiler:
    """Stands in for ``torch.profiler`` on the CPU: records when the
    loop starts and stops it."""

    def __init__(self, spans):
        self.lo, self.hi = 0, 0

    def start(self):
        self.lo = time.perf_counter_ns()

    def stop(self):
        self.hi = time.perf_counter_ns()
        return self


def test_the_profiled_slice_follows_the_window(monkeypatch):
    """The device is profiled over ``SLICE_S`` seconds of solves after
    the window has closed, so the window's host spans run without the
    profiler, and its start and slice add nothing to the window."""
    monkeypatch.setattr(portbench.trace, "SLICE_S", 0.3)
    monkeypatch.setattr(portbench.trace, "Profiler", FakeProfiler)
    cell = tiny("hpcg64-cg-b1")
    graphs = make_graphs(cell.config, 3)
    sessions, _, _ = harness.plan(cell.config, graphs, "cpu")
    ctx = Context(config=cell.config, traffic=cell.traffic, cell=cell.cell, seed=3, seconds=1.0,
                  device="cpu", graphs=graphs, sessions=sessions, t_start=time.perf_counter(),
                  spans=Spans(), profile=True)
    r = loops.find("solve").run(ctx)
    t0, te = r.window_ns
    p = r.profiler
    # The window's 1 s to its last solve's end, then 0.3 s of solves.
    assert te - t0 >= 1e9 and r.window_s == pytest.approx((te - t0) / 1e9)
    assert te <= p.lo and p.hi - p.lo >= 0.3e9
    window = ctx.spans.of("solve", t0, te)
    assert len(window) == r.attempted and all(b <= te for _, b in window)
    assert len(ctx.spans.of("solve", p.lo, p.hi)) >= 1  # the slice's solves, not counted
