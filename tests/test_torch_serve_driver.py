"""Driver tier of the port: the self-driving tick loop under real
concurrency, on CPU tensors — the eight cases of
``tests/test_serve_driver.py`` without its fault-injection cells, which
wait for the runtime.

What the caller-ticked suites cannot cover: ``submit()`` racing a
driver thread mid-tick, ``drain()`` vs ``stop()`` ordering, restart and
the context-manager shutdown path — all while the engine's bitwise
parity contract keeps holding. Results must never depend on who owns
the tick cadence.
"""
import threading

import numpy as np
import pytest

from repro_torch.api import Topology, distribute
from repro_torch.serve import ServeDriver, SparseServeEngine, Status
from repro_torch.sparse.formats import COO

N = 96
TOPO = Topology(2, 2)
WAIT = 60.0  # generous per-ticket wall-clock bound; normal runs take ms


def _diag_heavy_coo(seed, n=N, nnz=700):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    val = rng.standard_normal(nnz).astype(np.float32)
    d = np.arange(n, dtype=np.int32)
    row = np.concatenate([row, d])
    col = np.concatenate([col, d])
    val = np.concatenate([val, np.full(n, 8.0, np.float32)])
    order = np.argsort(row, kind="stable")
    return COO((n, n), row[order], col[order], val[order])


@pytest.fixture(scope="module")
def session():
    return distribute(_diag_heavy_coo(1), topology=TOPO, block=16, device="cpu")


def _engine(session, **kw):
    kw.setdefault("batch_slots", 4)
    kw.setdefault("max_queue", 64)
    kw.setdefault("default_iters", 6)
    eng = SparseServeEngine(**kw)
    eng.register_graph("g", session)
    return eng


# ---------------------------------------------------------------------------
# Lifecycle


def test_driver_completes_submissions_with_parity(session):
    eng = _engine(session)
    rng = np.random.default_rng(2)
    driver = ServeDriver(eng).start()
    try:
        cases = []
        for _ in range(5):
            seeds = rng.random(N).astype(np.float32)
            cases.append((eng.submit("g", "pagerank", payload={"seeds": seeds}), seeds))
        for t, _ in cases:
            assert t.wait(WAIT), "driver never finished the ticket"
        for t, seeds in cases:
            assert t.status is Status.DONE
            ref = session.solve("pagerank", seeds=seeds[None], iters=6)
            assert np.array_equal(t.result.x, ref.x[0])
    finally:
        driver.stop()
    assert not driver.running


def test_double_start_raises_and_stop_is_safe_when_stopped(session):
    driver = ServeDriver(_engine(session))
    driver.stop()  # never started: no-op
    driver.start()
    with pytest.raises(RuntimeError, match="already running"):
        driver.start()
    driver.stop()
    driver.stop()  # idempotent


def test_driver_restart_after_stop(session):
    eng = _engine(session)
    rng = np.random.default_rng(3)
    driver = ServeDriver(eng)
    driver.start()
    t1 = eng.submit("g", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)})
    assert t1.wait(WAIT)
    driver.stop()
    # Submitted while stopped: admitted but nobody ticks.
    t2 = eng.submit("g", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)})
    assert not t2.wait(0.05)
    assert t2.status is Status.QUEUED
    driver.start()  # restartable over the same engine
    assert t2.wait(WAIT) and t2.status is Status.DONE
    driver.stop()


# ---------------------------------------------------------------------------
# drain() vs stop()


def test_drain_requires_running_driver(session):
    eng = _engine(session)
    driver = ServeDriver(eng)
    eng.submit("g", "pagerank", payload={"seeds": np.ones(N, np.float32)})
    with pytest.raises(RuntimeError, match="not running"):
        driver.drain(timeout=1.0)


def test_drain_then_stop_finishes_everything(session):
    eng = _engine(session)
    rng = np.random.default_rng(4)
    driver = ServeDriver(eng).start()
    tickets = [
        eng.submit("g", "jacobi", payload={"b": rng.random(N).astype(np.float32)})
        for _ in range(10)
    ]
    driver.drain(timeout=WAIT)
    assert eng.pending() == 0
    assert all(t.status is Status.DONE for t in tickets)
    driver.stop()


def test_stop_without_drain_leaves_queue_intact(session):
    """stop() halts after the in-flight tick; it must not throw away
    queued work — the asymmetry that makes drain();stop() the graceful
    order."""
    eng = _engine(session, batch_slots=1, default_iters=200)
    rng = np.random.default_rng(5)
    # Slow lane (200 iters, 1 slot) + backlog, so a stop lands mid-queue.
    tickets = [
        eng.submit("g", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)})
        for _ in range(6)
    ]
    driver = ServeDriver(eng).start()
    driver.stop()
    statuses = {t.status for t in tickets}
    assert statuses <= {Status.QUEUED, Status.RUNNING, Status.DONE}
    assert eng.pending() + sum(t.status is Status.DONE for t in tickets) == 6
    # Nothing was lost: a restarted driver drains the remainder.
    driver.start()
    driver.drain(timeout=WAIT)
    driver.stop()
    assert all(t.status is Status.DONE for t in tickets)


def test_context_manager_drains_then_stops(session):
    eng = _engine(session)
    rng = np.random.default_rng(6)
    with ServeDriver(eng) as driver:
        tickets = [
            eng.submit("g", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)})
            for _ in range(4)
        ]
    assert not driver.running
    assert all(t.status is Status.DONE for t in tickets)


# ---------------------------------------------------------------------------
# Races: submit while the driver is mid-tick


def test_submit_while_ticking_from_many_threads(session):
    """4 submitter threads race the driver's tick loop; every ticket
    completes exactly once, counters balance, and spot-checked results
    still match the direct solve bitwise."""
    eng = _engine(session, max_queue=256, default_iters=5)
    results = [[] for _ in range(4)]
    with ServeDriver(eng):
        def submitter(idx):
            rng = np.random.default_rng(100 + idx)
            for _ in range(10):
                seeds = rng.random(N).astype(np.float32)
                t = eng.submit(
                    "g", "pagerank", payload={"seeds": seeds},
                    tenant=f"t{idx}",
                )
                results[idx].append((t, seeds))

        threads = [
            threading.Thread(target=submitter, args=(i,)) for i in range(4)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for bucket in results:
            for t, _ in bucket:
                assert t.wait(WAIT)
    m = eng.metrics
    assert m.submitted == 40 and m.completed == 40
    assert m.rejected == m.failed == m.expired == 0
    for idx, bucket in enumerate(results):
        assert eng.metrics.tenant(f"t{idx}").completed == 10
        t, seeds = bucket[0]
        ref = session.solve("pagerank", seeds=seeds[None], iters=5)
        assert np.array_equal(t.result.x, ref.x[0])
