"""Chaos tier of the port: the serving engine under unit loss, on CPU
tensors.

The case-for-case port of ``tests/test_elastic_recovery.py``, on its own
data (``N = 160``, ``Topology(2, 2)``, ``NL-HL``, selective, block 32),
holding the contract *recovered ≡ uninterrupted*: a
:class:`~repro_torch.runtime.fault.FaultInjector` kills a unit at a
parametrized engine fault point — after refill, after a lane's batched
iteration, before/after an incremental update is computed, and between a
generation archive's write and its marker commit — and every run drains
to results bitwise equal to the run that never failed, with no ticket
lost, duplicated or double-counted; :class:`Heartbeat` timeouts and
:class:`StragglerMonitor` demotion take the same recovery path.

Then what the JAX tier has no counterpart for:

* *stale lanes*: ``update_graph`` with requests in flight, then a kill
  while the old lane drains — the old lane is rebuilt around the matrix
  it started on, so the run is bitwise a never-failed port engine, with
  and without a ``recovery_dir`` (and after a checkpoint that pruned the
  journal the old lane's matrix came from);
* *both engines under one schedule*: the JAX package's engine and the
  port's, on the same graphs, updates and ``FaultInjector`` schedule,
  fire the same kills, count the same recoveries and dead units and
  finish every ticket at the same tick, with results within the 1e-5
  of ``tests/test_torch_serve_sparse.py``.
"""
import time

import numpy as np
import pytest

import repro.api as jx_api
import repro.runtime.fault as jx_fault
import repro.serve as jx_serve
import repro_torch.runtime.fault as FAULT
import repro_torch.serve as SERVE
from repro.sparse.formats import COO as JxCOO
from repro_torch.api import SparseDelta, Topology, distribute, plancache
from repro_torch.runtime.fault import FaultInjector, Heartbeat
from repro_torch.serve.sparse import SparseServeEngine, Status
from repro_torch.sparse.formats import COO
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

N = 160
TOPO = Topology(2, 2)
CPU = "cpu"


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _diag_heavy_coo(seed, n=N, nnz=1400):
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


PLAN_KW = {"combo": "NL-HL", "exchange": "selective", "block": 32, "seed": 0}


@pytest.fixture(scope="module")
def session():
    return distribute(_diag_heavy_coo(1), topology=TOPO, device=CPU, **PLAN_KW)


@pytest.fixture(scope="module")
def payloads():
    rng = np.random.default_rng(9)
    return {
        "seeds": rng.random(N).astype(np.float32),
        "b": rng.random(N).astype(np.float32),
    }


def _engine(**kw):
    return SparseServeEngine(batch_slots=4, executor="simulate", clock=FakeClock(),
                             device=CPU, **kw)


def _serve(session, payloads, *, injector=None, recovery_dir=None, heartbeat=None,
           latency_probe=None, **engine_kw):
    eng = _engine(fault_injector=injector, recovery_dir=recovery_dir,
                  heartbeat=heartbeat, latency_probe=latency_probe, **engine_kw)
    eng.register_graph("g", session)
    tickets = [
        eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10),
        eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=6),
        eng.submit("g", "jacobi", payload={"b": payloads["b"]}, iters=8),
    ]
    eng.run_until_drained()
    return eng, tickets


@pytest.fixture(scope="module")
def uninterrupted(session, payloads):
    _, tickets = _serve(session, payloads)
    assert all(t.status is Status.DONE for t in tickets)
    return tickets


def _assert_recovered_equals(base, got):
    for t0, t1 in zip(base, got, strict=True):
        assert t1.status is Status.DONE, (t1.status, t1.error)
        assert np.array_equal(t0.result.x, t1.result.x)
        assert t0.result.residuals == t1.result.residuals
        assert t0.result.iters_run == t1.result.iters_run


# ---------------------------------------------------------------------------
# Every kill point inside step(): refill boundaries and mid-solve


@pytest.mark.parametrize("kill_at", range(12))
def test_kill_point_matrix_is_bitwise(session, payloads, uninterrupted, tmp_path, kill_at):
    """Kill unit 1 at engine fault point ``kill_at`` (post-refill, then
    after each lane's batched iteration): the drained results are
    bitwise those of the run that never failed, every ticket terminal
    exactly once, and the recovery is logged by part."""
    injector = FaultInjector(schedule={kill_at: 1})
    eng, got = _serve(session, payloads, injector=injector, recovery_dir=str(tmp_path))
    assert injector.fired == [kill_at]
    assert eng.recoveries == 1 and eng.dead_units == {1}
    _assert_recovered_equals(uninterrupted, got)
    assert eng.metrics.completed == len(got)  # nothing lost or re-finished
    (record,) = eng.recovery_log
    assert record["unit"] == 1
    assert record["total_s"] >= record["load_s"] + record["remap_s"] >= 0.0


def test_two_sequential_failures(session, payloads, uninterrupted, tmp_path):
    injector = FaultInjector(schedule={2: 1, 9: 3})
    eng, got = _serve(session, payloads, injector=injector, recovery_dir=str(tmp_path))
    assert eng.recoveries == 2 and eng.dead_units == {1, 3}
    _assert_recovered_equals(uninterrupted, got)


def test_no_ticket_lost_or_duplicated_under_churn(tmp_path):
    """Overloaded queue + mid-tick kill: the terminal counts still add
    up to exactly one outcome per admitted ticket."""
    rng = np.random.default_rng(2)
    eng = SparseServeEngine(
        batch_slots=2, executor="simulate", clock=FakeClock(), device=CPU,
        fault_injector=FaultInjector(schedule={5: 0}), recovery_dir=str(tmp_path),
    )
    eng.register_graph("g", distribute(_diag_heavy_coo(3), topology=TOPO, block=32, seed=0,
                                       device=CPU))
    tickets = [
        eng.submit("g", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)},
                   iters=4)
        for _ in range(9)
    ]
    eng.run_until_drained()
    assert all(t.status is Status.DONE for t in tickets)
    assert eng.metrics.completed == len(tickets)
    assert eng.metrics.submitted == len(tickets)
    tids = [t.tid for t in tickets]
    assert len(set(tids)) == len(tids)


# ---------------------------------------------------------------------------
# Kill points inside update_graph / checkpoint_graph (mid-plan, mid-save)


def _one_upsert(session):
    return SparseDelta.upserts(session.matrix.shape, np.array([3]), np.array([5]),
                               np.array([0.625], dtype=np.float32))


@pytest.mark.parametrize("kill_at", range(4))
def test_update_and_checkpoint_kill_points(session, payloads, tmp_path, kill_at):
    """Fault points 0/1 hit checkpoint_graph (pre-archive, between
    archive write and marker commit); 2/3 hit update_graph (before and
    after the incremental update is computed). All four recover to the
    same bits as the uninterrupted update."""
    delta = _one_upsert(session)
    injector = FaultInjector(schedule={kill_at: 2})
    eng = _engine(fault_injector=injector, recovery_dir=str(tmp_path))
    eng.register_graph("g", session)
    gen = eng.checkpoint_graph("g")
    report = eng.update_graph("g", delta)
    assert injector.fired == [kill_at]
    assert eng.recoveries == 1
    assert report.action in ("patched", "replanned")
    t = eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=8)
    eng.run_until_drained()
    assert t.status is Status.DONE

    ref_eng = _engine()
    ref_eng.register_graph("g", session.update(delta))
    t_ref = ref_eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=8)
    ref_eng.run_until_drained()
    assert np.array_equal(t.result.x, t_ref.result.x)
    # the delta was journaled exactly once against the committed gen
    assert len(plancache.load_journal(str(tmp_path), "g", gen)) == 1


def test_kill_during_plan_store_save_keeps_last_good(session, tmp_path):
    """A crash between archive write and marker commit must leave the
    *previous* generation committed; the engine's retry then commits a
    fresh one — the marker never points at a torn write."""
    eng = _engine(fault_injector=FaultInjector(schedule={3: 1}),  # 2nd ckpt, pre-commit
                  recovery_dir=str(tmp_path))
    eng.register_graph("g", session)
    gen0 = eng.checkpoint_graph("g")
    assert plancache.last_good_generation(str(tmp_path), "g") == gen0
    gen1 = eng.checkpoint_graph("g")  # killed mid-commit, recovers, retries
    assert eng.recoveries == 1
    assert gen1 > gen0
    assert plancache.last_good_generation(str(tmp_path), "g") == gen1
    loaded = plancache.load_last_good(str(tmp_path), "g", executor="simulate", device=CPU)
    assert loaded is not None and loaded[1] == gen1


def test_recovery_replays_journal_from_disk(session, payloads, tmp_path):
    """Checkpoint → two journaled updates → kill mid-solve: the rebuilt
    lanes must serve the *updated* matrix (last good + journal replay),
    bitwise equal to a never-failed engine over the same update chain."""
    a = session.matrix
    d1 = SparseDelta.upserts(a.shape, np.array([10]), np.array([12]),
                             np.array([1.5], dtype=np.float32))
    d2 = SparseDelta.upserts(a.shape, np.array([40]), np.array([44]),
                             np.array([-2.0], dtype=np.float32))

    def drive(injector, recovery_dir):
        eng = _engine(fault_injector=injector, recovery_dir=recovery_dir)
        eng.register_graph("g", session)
        eng.checkpoint_graph("g")
        eng.update_graph("g", d1)
        eng.update_graph("g", d2)
        t = eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10)
        eng.run_until_drained()
        return eng, t

    _, t_base = drive(None, str(tmp_path / "base"))
    # Fault points 0..5 are consumed by checkpoint+updates, 6-7 by the
    # first tick. 9 lands after the second tick's lane step — mid-solve,
    # with the lane in the tick's snapshot, so recovery rebuilds it from
    # disk. (At 7, the JAX test's point, the lane is created inside the
    # failed tick: the rollback drops it and nothing is rebuilt.)
    eng, t_chaos = drive(FaultInjector(schedule={9: 1}), str(tmp_path / "chaos"))
    assert eng.recoveries == 1
    assert t_chaos.status is Status.DONE
    assert np.array_equal(t_base.result.x, t_chaos.result.x)
    assert t_base.result.residuals == t_chaos.result.residuals
    assert eng.recovery_log[0]["replay_s"] > 0.0  # two deltas replayed


# ---------------------------------------------------------------------------
# Heartbeat: death between ticks


def test_heartbeat_detects_silent_unit(session, payloads, uninterrupted):
    hb = Heartbeat(num_workers=TOPO.units, timeout=0.005)
    eng = _engine(heartbeat=hb)
    eng.register_graph("g", session)
    tickets = [
        eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10),
        eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=6),
        eng.submit("g", "jacobi", payload={"b": payloads["b"]}, iters=8),
    ]
    eng.step()
    eng.mark_unit_silent(3)
    time.sleep(0.02)  # real clock: Heartbeat is monotonic-based
    eng.run_until_drained()
    assert eng.dead_units == {3} and eng.recoveries == 1
    _assert_recovered_equals(uninterrupted, tickets)


# ---------------------------------------------------------------------------
# Straggler demotion: slow is the new dead


def test_straggler_demotion(session, payloads, uninterrupted):
    latency = {u: 1.0 for u in range(TOPO.units)}
    eng = _engine(latency_probe=lambda: dict(latency), straggler_factor=3.0,
                  straggler_patience=3)
    eng.register_graph("g", session)
    tickets = [
        eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10),
        eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=6),
        eng.submit("g", "jacobi", payload={"b": payloads["b"]}, iters=8),
    ]
    eng.step()
    eng.step()  # EWMA warmed on healthy latencies
    latency[2] = 25.0  # synthetic straggler: 25x the fleet
    eng.run_until_drained()
    assert eng.dead_units == {2} and eng.recoveries == 1
    _assert_recovered_equals(uninterrupted, tickets)


def test_transient_blip_is_not_demoted(session, payloads):
    """One slow tick is a blip, not a straggler — patience requires
    *consecutive* flags before demotion."""
    latency = {u: 1.0 for u in range(TOPO.units)}
    eng = _engine(latency_probe=lambda: dict(latency), straggler_factor=3.0,
                  straggler_patience=3)
    eng.register_graph("g", session)
    eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10)
    eng.step()
    eng.step()
    latency[2] = 25.0
    eng.step()  # one flagged tick...
    latency[2] = 1.0  # ...then healthy again
    eng.run_until_drained()
    assert eng.dead_units == set() and eng.recoveries == 0


# ---------------------------------------------------------------------------
# Guard rails


def test_max_recoveries_bounds_a_wedged_cluster(session, payloads, tmp_path):
    """An injector that kills at every fault point must end in a loud
    RuntimeError, not an infinite recover-retry loop."""
    injector = FaultInjector(schedule={k: k % TOPO.units for k in range(200)})
    eng = _engine(fault_injector=injector, recovery_dir=str(tmp_path), max_recoveries=3)
    eng.register_graph("g", session)
    eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=4)
    with pytest.raises(RuntimeError, match="recoveries"):
        eng.run_until_drained()


# ---------------------------------------------------------------------------
# Stale lanes: recovery keeps snapshot isolation


def _stale_run(session, payloads, delta, *, injector=None, recovery_dir=None,
               checkpoint_after=False):
    """Two requests in flight, ``update_graph`` after two ticks, two
    requests after it, drained (a kill, if scheduled, lands while the
    old lane drains). Returns the engine, the tickets, and the old lane's
    source before and after the drain."""
    eng = _engine(fault_injector=injector, recovery_dir=recovery_dir)
    eng.register_graph("g", session)
    early = [eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10),
             eng.submit("g", "pagerank", payload={"seeds": payloads["b"]}, iters=7)]
    eng.step()
    eng.step()
    eng.update_graph("g", delta)
    if checkpoint_after:
        eng.checkpoint_graph("g")
    late = [eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10),
            eng.submit("g", "pagerank", payload={"seeds": payloads["b"]}, iters=7)]
    eng.run_until_drained()
    return eng, early + late


@pytest.mark.parametrize("store", ["none", "journal", "checkpointed"])
def test_kill_while_a_stale_lane_drains_is_bitwise(session, payloads, tmp_path, store):
    """The kill lands while the lane built before ``update_graph`` still
    drains: its requests finish on the matrix they started on — rebuilt
    from the lane's own source without a ``recovery_dir``, from the last
    good generation and the journal prefix its source had seen with one,
    and from its own source again once a checkpoint pruned that journal
    — bitwise a never-failed engine; requests after the update run on
    the new matrix."""
    delta = SparseDelta.upserts(session.matrix.shape, np.arange(0, N, 7),
                                np.arange(0, N, 7)[::-1].copy(),
                                np.full(len(range(0, N, 7)), 3.0, np.float32))
    kw = {"recovery_dir": None if store == "none" else str(tmp_path / "base"),
          "checkpoint_after": store == "checkpointed"}
    _, base = _stale_run(session, payloads, delta, **kw)
    # Points 0-3 are the two ticks before the update, 4-5 update_graph's,
    # (6-7 the checkpoint's); the next tick's refill admits nothing (the
    # old lane is full of old requests) and its lane step is the kill.
    kill_at = 9 if store == "checkpointed" else 7
    injector = FaultInjector(schedule={kill_at: 1})
    if kw["recovery_dir"] is not None:
        kw["recovery_dir"] = str(tmp_path / "chaos")
    eng, got = _stale_run(session, payloads, delta, injector=injector, **kw)
    assert injector.fired == [kill_at] and eng.recoveries == 1
    _assert_recovered_equals(base, got)
    # Old requests on the old matrix, new ones on the new: the delta shows.
    assert not np.array_equal(got[0].result.x, got[2].result.x)
    assert eng.metrics.completed == 4


def test_stale_lane_after_recovery_still_takes_no_ticket(session, payloads, tmp_path):
    """After a recovery the rebuilt old lane stays stale (a new request
    waits for it to drain) and the current graph is the recovered
    session, which a lane built on it counts as current."""
    delta = _one_upsert(session)
    eng = _engine(fault_injector=FaultInjector(schedule={7: 1}), recovery_dir=str(tmp_path))
    eng.register_graph("g", session)
    eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10)
    eng.step()
    eng.step()
    eng.update_graph("g", delta)
    late = eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=3)
    eng.step()  # the kill: recovered, rerun
    assert eng.recoveries == 1
    (key,) = eng._lanes
    lane = eng._lanes[key]
    assert lane.source is not eng._graphs["g"] and lane.lineage == (0, 0)
    assert late.status is Status.QUEUED  # waits for the old lane
    eng.run_until_drained()
    assert late.status is Status.DONE
    assert eng._lanes[key].source is eng._graphs["g"]


def test_current_lane_stays_current_after_recovery(session, payloads, tmp_path):
    """A lane over the graph's current session is rebuilt around the
    recovered session, which becomes the graph's: it still takes new
    tickets at once, as it would have without the fault."""
    eng = _engine(fault_injector=FaultInjector(schedule={5: 1}), recovery_dir=str(tmp_path))
    eng.register_graph("g", session)
    first = eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10)
    for _ in range(3):
        eng.step()  # the third tick's lane step is the kill
    assert eng.recoveries == 1
    (lane,) = eng._lanes.values()
    assert lane.source is eng._graphs["g"] and lane.source is not session
    later = eng.submit("g", "pagerank", payload={"seeds": payloads["b"]}, iters=3)
    eng.step()
    assert later.status is Status.RUNNING and lane.occupied == 2
    eng.run_until_drained()
    assert first.status is later.status is Status.DONE


# ---------------------------------------------------------------------------
# Both engines under one schedule


@pytest.fixture(scope="module")
def both():
    a = _diag_heavy_coo(1)
    jx = jx_api.distribute(JxCOO(a.shape, a.row, a.col, a.val), topology=jx_api.Topology(2, 2),
                           **PLAN_KW)
    return {"jax": jx, "port": distribute(a, topology=TOPO, device=CPU, **PLAN_KW)}


def _drive_both(pkg, session, payloads, schedule, recovery_dir):
    """The same calls through ``pkg``'s engine: a checkpoint, a journaled
    update, three requests, ticks of a FakeClock advancing 1.0 each."""
    serve, fault = pkg
    kw = {} if serve is jx_serve else {"device": CPU}
    clk = FakeClock()
    injector = fault.FaultInjector(schedule=dict(schedule))
    eng = serve.SparseServeEngine(batch_slots=4, executor="simulate", clock=clk,
                                  fault_injector=injector, recovery_dir=recovery_dir, **kw)
    eng.register_graph("g", session)
    eng.checkpoint_graph("g")
    delta_cls = jx_api.SparseDelta if serve is jx_serve else SparseDelta
    eng.update_graph("g", delta_cls.upserts(
        (N, N), np.array([3, 50]), np.array([5, 51]), np.array([0.625, -1.5], np.float32)))
    tickets = [
        eng.submit("g", "pagerank", payload={"seeds": payloads["seeds"]}, iters=10),
        eng.submit("g", "pagerank", payload={"seeds": payloads["b"]}, iters=6),
        eng.submit("g", "jacobi", payload={"b": payloads["b"]}, iters=8),
    ]
    while eng.pending():
        eng.step()
        clk.advance(1.0)
    return eng, injector, tickets


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("schedule", [{1: 2}, {3: 0}, {6: 1}, {9: 3, 17: 0}],
                         ids=["mid-checkpoint", "mid-update", "post-refill", "two-kills"])
def test_both_engines_fail_and_recover_alike(both, payloads, tmp_path, schedule):
    eng_j, inj_j, got_j = _drive_both((jx_serve, jx_fault), both["jax"], payloads, schedule,
                                      str(tmp_path / "jax"))
    eng_p, inj_p, got_p = _drive_both((SERVE, FAULT), both["port"], payloads, schedule,
                                      str(tmp_path / "port"))
    assert inj_p.fired == inj_j.fired == sorted(schedule)
    assert (eng_p.recoveries, eng_p.dead_units) == (eng_j.recoveries, eng_j.dead_units)
    assert eng_p.metrics.snapshot() == eng_j.metrics.snapshot()
    for tj, tp in zip(got_j, got_p, strict=True):
        assert tp.status.value == tj.status.value == "done"
        assert (tp.t_start, tp.t_finish) == (tj.t_start, tj.t_finish)
        assert tp.result.iters_run == tj.result.iters_run
        assert _rel(tp.result.x, tj.result.x) <= 1e-5
        assert _rel(tp.result.residuals, tj.result.residuals) <= 1e-5
