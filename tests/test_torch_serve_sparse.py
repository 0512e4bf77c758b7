"""Serving tier for :mod:`repro_torch.serve.sparse`, on CPU tensors.

The case-for-case port of ``tests/test_serve_sparse.py`` (less its three
plan-store hydration cases, which wait for the plan cache): serving
through the engine changes *scheduling*, never *results* — every
registered batch stepper is pinned bitwise against direct batched-of-1
``SparseSession.solve`` calls within the port, under mixed lanes,
continuous slot refill, tol early-stops, overload and deadline churn,
plus the admission-control contract.

Then the cross-package cases: the same graphs, built from the same
numpy COO in both packages, and the same submissions under one
``FakeClock`` schedule through the JAX package's engine and the port's.
Ticket statuses, iteration counts, ``converged``, every lane's slot
occupancy tick by tick and ``metrics.snapshot()`` must be equal
exactly; results and residuals agree within 1e-5 relative (the
reference's kernel-vs-oracle tolerance).
"""
import numpy as np
import pytest

import repro.api as jx_api
import repro.serve as jx_serve
import repro_torch.serve as SERVE
from repro.sparse.formats import COO as JxCOO
from repro_torch.api import STEPPERS, Topology, distribute
from repro_torch.serve import (
    QueueFullError,
    SparseServeEngine,
    Status,
    TenantQuotaError,
    percentile,
)
from repro_torch.sparse.formats import COO

N = 96
TOPO = Topology(2, 2)


class FakeClock:
    """Deterministic injectable clock for deadline tests."""

    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _diag_heavy_coo(seed, n=N, nnz=700):
    """Random square COO with a dominant full diagonal (Jacobi-safe)."""
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
def sessions():
    return {
        "g1": distribute(_diag_heavy_coo(1), topology=TOPO, block=16, device="cpu"),
        "g2": distribute(_diag_heavy_coo(2), topology=TOPO, block=16, device="cpu"),
    }


@pytest.fixture()
def engine(sessions):
    eng = SparseServeEngine(batch_slots=4, max_queue=64, default_iters=8)
    for name, sess in sessions.items():
        eng.register_graph(name, sess)
    return eng


def _direct(sess, solver, payload, *, iters, tol=0.0):
    """The parity reference: a direct batched-of-1 solve / spmv."""
    if solver == "spmv":
        return sess.spmv(payload["x"][None])[0]
    kw = {k: v[None] for k, v in payload.items()}
    return sess.solve(solver, iters=iters, tol=tol, **kw)


# ---------------------------------------------------------------------------
# Parity: engine-served == direct, for every registered stepper


def test_every_registered_stepper_has_parity(engine, sessions):
    """Every solver in STEPPERS round-trips through the engine bitwise
    equal to the direct call — the registry is the contract, so a new
    stepper entry is automatically held to it."""
    rng = np.random.default_rng(3)
    payload_of = {
        "pagerank": lambda: {"seeds": rng.random(N).astype(np.float32)},
        "jacobi": lambda: {"b": rng.random(N).astype(np.float32)},
        "spmv": lambda: {"x": rng.random(N).astype(np.float32)},
        "cg": lambda: {"b": rng.random(N).astype(np.float32)},
    }
    assert set(payload_of) == set(STEPPERS.names()), (
        "new stepper registered without a parity payload here"
    )
    submitted = []
    for solver in sorted(STEPPERS.names()):
        for _ in range(3):
            payload = payload_of[solver]()
            t = engine.submit("g1", solver, payload=payload, iters=6)
            submitted.append((t, solver, payload))
    engine.run_until_drained()
    for t, solver, payload in submitted:
        assert t.status is Status.DONE
        if solver == "spmv":
            ref = _direct(sessions["g1"], solver, payload, iters=6)
            assert np.array_equal(t.result.x, ref)
            assert t.result.iters_run == 1
        else:
            ref = _direct(sessions["g1"], solver, payload, iters=6)
            assert np.array_equal(t.result.x, ref.x[0]), solver
            assert t.result.residuals == ref.residuals, solver
            assert t.result.iters_run == ref.iters_run
            assert t.result.value == ref.value
            assert t.result.converged == ref.converged


def test_continuous_refill_keeps_parity(engine, sessions):
    """More requests than slots, unequal budgets, two graphs and three
    solvers interleaved: slots retire and refill mid-flight, each
    ticket still bitwise matches its direct solve."""
    rng = np.random.default_rng(4)
    cases = []
    for i in range(9):
        seeds = rng.random(N).astype(np.float32)
        t = engine.submit("g1", "pagerank", payload={"seeds": seeds}, iters=3 + i)
        cases.append((t, "g1", "pagerank", {"seeds": seeds}, 3 + i))
    for _ in range(5):
        b = rng.random(N).astype(np.float32)
        t = engine.submit("g2", "jacobi", payload={"b": b}, iters=7)
        cases.append((t, "g2", "jacobi", {"b": b}, 7))
    for _ in range(3):
        x = rng.random(N).astype(np.float32)
        t = engine.submit("g2", "spmv", payload={"x": x})
        cases.append((t, "g2", "spmv", {"x": x}, 1))
    engine.run_until_drained()
    for t, g, solver, payload, iters in cases:
        assert t.status is Status.DONE
        ref = _direct(engine._session(g), solver, payload, iters=iters)
        ref_x = ref if solver == "spmv" else ref.x[0]
        assert np.array_equal(t.result.x, ref_x), (solver, t.tid)
    # Continuous batching actually shared work: 17 requests, but far
    # fewer batched lane steps than sequential iterations.
    m = engine.metrics
    assert m.completed == 17
    assert m.lane_steps < m.slot_iters


def test_tol_early_stop_frozen_slot_parity(engine, sessions):
    """A converged slot freezes bitwise while its lane keeps stepping
    neighbours — iters_run/converged match the direct tol solve."""
    rng = np.random.default_rng(5)
    fast = {"seeds": rng.random(N).astype(np.float32)}
    slow = {"seeds": rng.random(N).astype(np.float32)}
    t_fast = engine.submit("g1", "pagerank", payload=fast, iters=40, tol=1e-3)
    t_slow = engine.submit("g1", "pagerank", payload=slow, iters=40, tol=1e-7)
    engine.run_until_drained()
    for t, payload, tol in ((t_fast, fast, 1e-3), (t_slow, slow, 1e-7)):
        ref = _direct(sessions["g1"], "pagerank", payload, iters=40, tol=tol)
        assert np.array_equal(t.result.x, ref.x[0])
        assert t.result.iters_run == ref.iters_run
        assert t.result.converged == ref.converged
    assert t_fast.result.iters_run < t_slow.result.iters_run


def test_per_lane_config_isolation(engine, sessions):
    """Different solver configs (damping) land in different lanes and
    keep their own arithmetic."""
    rng = np.random.default_rng(6)
    seeds = rng.random(N).astype(np.float32)
    t_a = engine.submit("g1", "pagerank", payload={"seeds": seeds}, iters=6, damping=0.85)
    t_b = engine.submit("g1", "pagerank", payload={"seeds": seeds}, iters=6, damping=0.5)
    engine.run_until_drained()
    for t, damping in ((t_a, 0.85), (t_b, 0.5)):
        ref = sessions["g1"].solve(
            "pagerank", seeds=seeds[None], iters=6, damping=damping
        )
        assert np.array_equal(t.result.x, ref.x[0])
    assert not np.array_equal(t_a.result.x, t_b.result.x)


def test_solve_batch_matches_direct(sessions):
    """The session-level batch API (no engine): solve_batch == direct
    batched-of-1, including per-request tol freeze."""
    sess = sessions["g1"]
    rng = np.random.default_rng(8)
    seeds = [rng.random(N).astype(np.float32) for _ in range(4)]
    batch = sess.solve_batch(
        "pagerank", [{"seeds": s} for s in seeds], iters=30, tol=1e-4
    )
    for got, s in zip(batch, seeds):
        ref = sess.solve("pagerank", seeds=s[None], iters=30, tol=1e-4)
        assert np.array_equal(got.x, ref.x[0])
        assert got.residuals == ref.residuals
        assert got.iters_run == ref.iters_run
        assert got.converged == ref.converged


# ---------------------------------------------------------------------------
# Admission control


def test_queue_full_typed_rejection(sessions):
    eng = SparseServeEngine(batch_slots=2, max_queue=3, default_iters=4)
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(9)
    accepted = [
        eng.submit("g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)})
        for _ in range(3)
    ]
    with pytest.raises(QueueFullError) as exc:
        eng.submit(
            "g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)}
        )
    assert exc.value.max_queue == 3
    assert eng.metrics.rejected == 1
    # Shedding didn't poison the accepted work: drain + parity.
    eng.run_until_drained()
    assert all(t.status is Status.DONE for t in accepted)
    assert eng.metrics.completed == 3


def test_overload_drains_and_accepted_keep_parity(sessions):
    """Sustained overload: submit bursts between ticks, shedding the
    excess; the engine never deadlocks and every accepted ticket still
    matches its direct solve bitwise."""
    eng = SparseServeEngine(batch_slots=2, max_queue=4, default_iters=5)
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(10)
    accepted, shed = [], 0
    for _ in range(6):  # bursts of 4 against a queue of 4
        for _ in range(4):
            seeds = rng.random(N).astype(np.float32)
            try:
                accepted.append((eng.submit("g1", "pagerank", payload={"seeds": seeds}), seeds))
            except QueueFullError:
                shed += 1
        eng.step()
    eng.run_until_drained()
    assert shed > 0 and eng.metrics.rejected == shed
    assert eng.pending() == 0
    for t, seeds in accepted:
        assert t.status is Status.DONE
        ref = sessions["g1"].solve("pagerank", seeds=seeds[None], iters=5)
        assert np.array_equal(t.result.x, ref.x[0])


def test_deadline_expiry_queued_and_running(sessions):
    clk = FakeClock()
    eng = SparseServeEngine(
        batch_slots=1, max_queue=8, default_iters=1000, clock=clk
    )
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(11)
    t_run = eng.submit(
        "g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)},
        timeout=5.0,
    )
    eng.step()  # t_run occupies the only slot
    assert t_run.status is Status.RUNNING
    # Submitted after t_run started: even with EDF refill (its deadline
    # is earlier) it can only wait — the lone slot is taken.
    t_queued = eng.submit(
        "g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)},
        timeout=1.0,
    )
    clk.advance(2.0)
    eng.step()  # queued deadline passed -> expired without ever running
    assert t_queued.status is Status.EXPIRED
    assert t_queued.t_start is None
    clk.advance(4.0)
    eng.step()  # running deadline passed -> expired mid-run, slot freed
    assert t_run.status is Status.EXPIRED
    eng.run_until_drained()
    assert eng.pending() == 0
    assert eng.metrics.expired == 2
    # The freed slot is reusable: a fresh request completes normally.
    t_new = eng.submit(
        "g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)},
        iters=3,
    )
    eng.run_until_drained()
    assert t_new.status is Status.DONE


def test_failed_tickets_do_not_poison_the_lane(engine, sessions):
    rng = np.random.default_rng(12)
    bad_shape = engine.submit(
        "g1", "pagerank", payload={"seeds": np.ones(7, np.float32)}
    )
    zero_mass = engine.submit(
        "g1", "pagerank", payload={"seeds": np.zeros(N, np.float32)}
    )
    seeds = rng.random(N).astype(np.float32)
    good = engine.submit("g1", "pagerank", payload={"seeds": seeds}, iters=5)
    engine.run_until_drained()
    assert bad_shape.status is Status.FAILED and "seeds" in bad_shape.error
    assert zero_mass.status is Status.FAILED and "mass" in zero_mass.error
    assert good.status is Status.DONE
    ref = sessions["g1"].solve("pagerank", seeds=seeds[None], iters=5)
    assert np.array_equal(good.result.x, ref.x[0])
    assert engine.metrics.failed == 2


def test_admission_time_errors_raise(engine):
    rng = np.random.default_rng(13)
    with pytest.raises(KeyError, match="unknown graph"):
        engine.submit("nope", "pagerank", payload={"seeds": rng.random(N)})
    with pytest.raises(KeyError, match="no batch stepper"):
        engine.submit("g1", "power_iteration")
    with pytest.raises(ValueError, match="iters"):
        engine.submit("g1", "pagerank", payload={"seeds": rng.random(N)}, iters=0)


def test_run_until_drained_guard(engine):
    rng = np.random.default_rng(14)
    engine.submit(
        "g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)},
        iters=50,
    )
    with pytest.raises(RuntimeError, match="did not drain"):
        engine.run_until_drained(max_ticks=3)
    engine.run_until_drained()  # and it can still finish afterwards
    assert engine.pending() == 0


def test_idle_step_is_noop(engine):
    assert engine.step() is False
    assert engine.metrics.ticks == 0


# ---------------------------------------------------------------------------
# Metrics


def test_metrics_snapshot_consistency(engine):
    rng = np.random.default_rng(17)
    for _ in range(5):
        engine.submit(
            "g1", "pagerank",
            payload={"seeds": rng.random(N).astype(np.float32)}, iters=4,
        )
    engine.run_until_drained()
    snap = engine.metrics.snapshot()
    assert snap["submitted"] == 5
    assert snap["completed"] == 5
    assert snap["rejected"] == snap["expired"] == snap["failed"] == 0
    assert snap["slot_iters"] == 5 * 4
    assert 0.0 < snap["occupancy"] <= 1.0
    assert snap["total_p50_s"] >= snap["wait_p50_s"] >= 0.0
    assert snap["total_p99_s"] >= snap["total_p50_s"]


def test_percentile_nearest_rank():
    assert percentile([], 99) == 0.0
    assert percentile([5.0], 50) == 5.0
    xs = [float(i) for i in range(1, 101)]
    assert percentile(xs, 50) == 50.0
    assert percentile(xs, 99) == 99.0
    assert percentile(xs, 100) == 100.0
    with pytest.raises(ValueError):
        percentile(xs, 101)


def _probe_step_order(eng):
    """Wrap every lane's stepper to record the order ``step`` visits
    lanes on subsequent ticks."""
    calls = []
    for key, lane in eng._lanes.items():
        orig = lane.stepper.step

        def wrapped(active, _k=key, _orig=orig):
            calls.append(_k)
            return _orig(active)

        lane.stepper.step = wrapped
    return calls


def test_step_demand_order_busiest_lane_first(sessions):
    """Demand = occupied slots + still-queued tickets: a lane with the
    same occupancy but a deeper backlog must step before one created
    earlier, and an outright busier lane always goes first."""
    eng = SparseServeEngine(batch_slots=2, max_queue=64, default_iters=6)
    for name, sess in sessions.items():
        eng.register_graph(name, sess)
    b = np.ones(N, np.float32)
    # g1 lane first (creation order), 2 tickets -> occupied 2, queued 0.
    for _ in range(2):
        eng.submit("g1", "jacobi", payload={"b": b}, iters=6)
    # g2 lane second, 5 tickets -> occupied 2, queued 3: higher demand.
    for _ in range(5):
        eng.submit("g2", "jacobi", payload={"b": b}, iters=6)
    eng.step()  # creates both lanes (order unobserved on this tick)
    g1 = next(k for k in eng._lanes if k[0] == "g1")
    g2 = next(k for k in eng._lanes if k[0] == "g2")
    calls = _probe_step_order(eng)
    eng.step()
    assert calls == [g2, g1]  # backlog outranks creation order


# ---------------------------------------------------------------------------
# Admission regressions


def test_expired_backlog_does_not_trip_queue_full(sessions):
    """Regression: ``submit`` used to count already-expired queued
    tickets toward ``max_queue``, so a burst of short-timeout requests
    shed fresh work off an effectively empty queue. Expired tickets
    must be swept at admission, before the bound check."""
    clk = FakeClock()
    eng = SparseServeEngine(
        batch_slots=1, max_queue=3, default_iters=4, clock=clk
    )
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(40)
    stale = [
        eng.submit(
            "g1", "pagerank",
            payload={"seeds": rng.random(N).astype(np.float32)}, timeout=1.0,
        )
        for _ in range(3)
    ]
    clk.advance(2.0)  # every queued ticket is now past its deadline
    fresh = eng.submit(  # failed before the fix: spurious QueueFullError
        "g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)},
    )
    assert all(t.status is Status.EXPIRED for t in stale)
    assert all(t.t_start is None for t in stale)
    assert eng.metrics.expired == 3 and eng.metrics.rejected == 0
    eng.run_until_drained()
    assert fresh.status is Status.DONE


def test_tol_none_vs_zero_semantics(sessions):
    """Regression: falsy checks silently treated ``tol=0.0`` as "no
    tolerance". The explicit contract: ``tol=None`` never stops early
    (and never reports ``converged``); ``tol=0.0`` stops on an
    exact-zero residual, converged."""
    eng = SparseServeEngine(batch_slots=4, max_queue=8, default_iters=64)
    eng.register_graph("g1", sessions["g1"])
    zero = np.zeros(N, np.float32)
    rng = np.random.default_rng(41)
    # b=0 drives Jacobi's residual to exactly 0.0 on the first sweep.
    t_exact = eng.submit("g1", "jacobi", payload={"b": zero}, iters=64, tol=0.0)
    t_off = eng.submit("g1", "jacobi", payload={"b": zero}, iters=64, tol=None)
    # A generic rhs never hits exactly zero: tol=0.0 must NOT mean
    # "stop immediately" either — it runs the full budget unconverged.
    b = rng.random(N).astype(np.float32)
    t_real = eng.submit("g1", "jacobi", payload={"b": b}, iters=8, tol=0.0)
    eng.run_until_drained()
    assert t_exact.result.iters_run == 1  # was 64 before the fix
    assert t_exact.result.converged is True
    assert t_exact.result.residuals == [0.0]
    assert t_off.result.iters_run == 64
    assert t_off.result.converged is False
    assert t_real.result.iters_run == 8
    assert t_real.result.converged is False
    with pytest.raises(ValueError, match="tol"):
        eng.submit("g1", "jacobi", payload={"b": b}, tol=-1e-3)


def test_ticks_count_only_stepping_ticks(sessions):
    """Regression: ``metrics.ticks`` used to increment on ticks where
    no lane stepped (e.g. the cleanup tick that drops an idle lane)
    while ``slot_ticks``/``slot_capacity`` didn't, skewing occupancy
    and per-tick rates. Now all three accumulate for exactly the ticks
    that stepped a lane."""
    eng = SparseServeEngine(batch_slots=2, max_queue=8, default_iters=3)
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(42)
    eng.submit(
        "g1", "pagerank", payload={"seeds": rng.random(N).astype(np.float32)},
        iters=3,
    )
    eng.run_until_drained()
    assert eng.metrics.ticks == 3
    assert eng.metrics.slot_capacity == 3 * eng.batch_slots  # same ticks
    assert eng._lanes  # the drained lane sticks around until...
    assert eng.step() is False  # ...this cleanup tick, which must not count
    assert not eng._lanes
    assert eng.metrics.ticks == 3  # was 4 before the fix
    assert eng.metrics.slot_capacity == 3 * eng.batch_slots
    assert eng.step() is False  # fully idle tick: still nothing
    assert eng.metrics.ticks == 3


def test_lane_retire_is_idempotent(sessions):
    """Regression companion: the failed-``lane.load`` path retires a
    slot that was never loaded; retire must be a provable no-op on a
    vacant slot and safe to repeat."""
    eng = SparseServeEngine(batch_slots=2, max_queue=4, default_iters=5)
    eng.register_graph("g1", sessions["g1"])
    t = eng.submit("g1", "jacobi", payload={"b": np.ones(N, np.float32)})
    eng.step()
    lane = next(iter(eng._lanes.values()))

    def vacant(slot):
        return (
            lane.tickets[slot] is None
            and not lane.active[slot]
            and lane.iters_done[slot] == 0
            and lane.budget[slot] == 0
            and lane.residuals[slot] == []
        )

    assert vacant(1)
    lane.retire(1)  # never loaded: must stay vacant, not crash
    assert vacant(1) and lane.free_slot() == 1
    slot = lane.tickets.index(t)
    lane.retire(slot)
    lane.retire(slot)  # double retire: same vacant state
    assert vacant(slot)
    assert lane.free_slot() is not None


# ---------------------------------------------------------------------------
# Multi-tenant fairness + SLA-aware refill


def test_tenant_quota_typed_rejection(sessions):
    eng = SparseServeEngine(
        batch_slots=1, max_queue=16, tenant_quota=2, default_iters=3
    )
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(43)

    def sub(tenant):
        return eng.submit(
            "g1", "pagerank",
            payload={"seeds": rng.random(N).astype(np.float32)}, tenant=tenant,
        )

    sub("ana"), sub("ana")
    with pytest.raises(TenantQuotaError) as exc:
        sub("ana")
    assert exc.value.tenant == "ana" and exc.value.quota == 2
    # The quota is per tenant: the engine still has room for others.
    t_other = sub("bob")
    assert t_other.status is Status.QUEUED
    assert eng.metrics.rejected == 1
    assert eng.metrics.tenant("ana").rejected == 1
    assert eng.metrics.tenant("bob").rejected == 0
    eng.run_until_drained()
    assert eng.metrics.completed == 3


def test_fair_refill_round_robins_across_tenants(sessions):
    """One flooding tenant vs two one-shot victims on the same lane,
    one slot: deficit round-robin admits the victims on the next free
    slots instead of burning through the flood FIFO-style."""
    clk = FakeClock()
    eng = SparseServeEngine(
        batch_slots=1, max_queue=64, default_iters=1, clock=clk
    )
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(44)

    def sub(tenant):
        return eng.submit(
            "g1", "pagerank",
            payload={"seeds": rng.random(N).astype(np.float32)}, tenant=tenant,
        )

    flood = [sub("flood") for _ in range(6)]
    victims = [sub("v1"), sub("v2")]
    starts = []
    while eng.pending():
        eng.step()
        clk.advance(1.0)
    for t in flood + victims:
        assert t.status is Status.DONE
        starts.append((t.t_start, t.tenant))
    order = [tenant for _, tenant in sorted(starts)]
    # First slot goes to the flood (it rotated in first), but both
    # victims are served on the immediately following slots — under the
    # old global FIFO they'd have waited behind all six flood tickets.
    assert order[:3] == ["flood", "v1", "v2"]
    assert order[3:] == ["flood"] * 5


def test_tenant_weights_skew_admission(sessions):
    """A weight-2 tenant gets two admissions per rotation of a weight-1
    tenant when both have backlog."""
    clk = FakeClock()
    eng = SparseServeEngine(
        batch_slots=1, max_queue=64, default_iters=1, clock=clk,
        tenant_weights={"heavy": 2.0},
    )
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(45)

    def sub(tenant):
        return eng.submit(
            "g1", "pagerank",
            payload={"seeds": rng.random(N).astype(np.float32)}, tenant=tenant,
        )

    heavy = [sub("heavy") for _ in range(6)]
    light = [sub("light") for _ in range(6)]
    while eng.pending():
        eng.step()
        clk.advance(1.0)
    order = [
        t.tenant for t in sorted(heavy + light, key=lambda t: t.t_start)
    ]
    # Over the contested prefix, heavy holds a ~2:1 admission ratio.
    prefix = order[:9]
    assert prefix.count("heavy") == 6
    assert prefix.count("light") == 3


def test_edf_orders_within_tenant(sessions):
    """Within one tenant's share: earliest deadline dispatches first;
    deadline-less tickets keep FIFO order behind every deadlined one."""
    clk = FakeClock()
    eng = SparseServeEngine(
        batch_slots=1, max_queue=16, default_iters=1, clock=clk
    )
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(46)

    def sub(timeout):
        return eng.submit(
            "g1", "pagerank",
            payload={"seeds": rng.random(N).astype(np.float32)},
            timeout=timeout,
        )

    t_lax = sub(100.0)
    t_none_first = sub(None)
    t_tight = sub(25.0)
    t_none_second = sub(None)
    t_mid = sub(50.0)
    expect = [t_tight, t_mid, t_lax, t_none_first, t_none_second]
    while eng.pending():
        eng.step()
        clk.advance(1.0)
    assert all(t.status is Status.DONE for t in expect)
    starts = [t.t_start for t in expect]
    assert starts == sorted(starts)  # EDF, then FIFO for the deadline-less
    m = eng.metrics.snapshot()
    assert m["goodput"] == 5  # everyone beat (or had no) deadline
    assert m["tenants"]["default"]["goodput"] == 5


def test_per_tenant_metrics_in_snapshot(sessions):
    eng = SparseServeEngine(batch_slots=2, max_queue=16, default_iters=2)
    eng.register_graph("g1", sessions["g1"])
    rng = np.random.default_rng(47)
    for tenant, count in (("ana", 3), ("bob", 1)):
        for _ in range(count):
            eng.submit(
                "g1", "pagerank",
                payload={"seeds": rng.random(N).astype(np.float32)},
                tenant=tenant,
            )
    eng.run_until_drained()
    snap = eng.metrics.snapshot()
    assert set(snap["tenants"]) == {"ana", "bob"}
    ana, bob = snap["tenants"]["ana"], snap["tenants"]["bob"]
    assert ana["submitted"] == ana["completed"] == 3
    assert bob["submitted"] == bob["completed"] == 1
    assert ana["goodput"] == 3 and bob["goodput"] == 1  # deadline-less
    assert ana["total_p99_s"] >= ana["wait_p99_s"] >= 0.0
    assert snap["completed"] == 4 and snap["goodput"] == 4


def test_cg_engine_parity_across_executors(sessions):
    """CG through the engine == direct batched-of-1 CG, bitwise, on
    both the simulate and reference executors."""
    rng = np.random.default_rng(48)
    payloads = [rng.random(N).astype(np.float32) for _ in range(3)]
    for executor in ("simulate", "reference"):
        eng = SparseServeEngine(
            batch_slots=2, max_queue=8, default_iters=6, executor=executor
        )
        eng.register_graph("g1", sessions["g1"])
        tickets = [
            eng.submit("g1", "cg", payload={"b": b}, iters=6) for b in payloads
        ]
        eng.run_until_drained()
        sess = eng._session("g1")
        assert sess.executor == executor
        for t, b in zip(tickets, payloads):
            assert t.status is Status.DONE
            ref = sess.solve("cg", b=b[None], iters=6)
            assert np.array_equal(t.result.x, ref.x[0]), executor
            assert t.result.residuals == ref.residuals, executor


def test_step_demand_order_stable_ties(sessions):
    """Equal demand falls back to lane creation order (stable sort)."""
    eng = SparseServeEngine(batch_slots=4, max_queue=64, default_iters=6)
    for name, sess in sessions.items():
        eng.register_graph(name, sess)
    b = np.ones(N, np.float32)
    eng.submit("g2", "jacobi", payload={"b": b}, iters=6)
    eng.submit("g1", "jacobi", payload={"b": b}, iters=6)
    eng.step()
    g1 = next(k for k in eng._lanes if k[0] == "g1")
    g2 = next(k for k in eng._lanes if k[0] == "g2")
    calls = _probe_step_order(eng)
    eng.step()
    assert calls == [g2, g1]  # g2 admitted (and created) first
    # Results are untouched by scheduling order: both finish cleanly.
    eng.run_until_drained()
    assert eng.metrics.snapshot()["completed"] == 2


# ---------------------------------------------------------------------------
# Cross-package: the JAX package's engine and the port's, one schedule

EXCHANGES = ("replicated", "selective", "overlap:2")


@pytest.fixture(scope="module", params=EXCHANGES)
def both(request):
    """The same two graphs planned by both packages from the same numpy
    COO, under one exchange: ``{"jax": {...}, "port": {...}}``."""
    out = {"jax": {}, "port": {}}
    for name, seed in (("g1", 1), ("g2", 2)):
        a = _diag_heavy_coo(seed)
        out["jax"][name] = jx_api.distribute(
            JxCOO(a.shape, a.row, a.col, a.val), topology=jx_api.Topology(2, 2),
            block=16, exchange=request.param,
        )
        out["port"][name] = distribute(a, topology=TOPO, block=16, exchange=request.param,
                                       device="cpu")
    return out


def _drive(serve, sessions, schedule, **engine_kw):
    """Run ``schedule`` (per tick, the submissions made before that tick's
    ``step``) through one engine of the ``serve`` package under a
    ``FakeClock`` that advances 1.0 a tick, until drained. Returns the
    engine, the tickets (None where a submission was shed), the shed
    errors' names, and every lane's slot occupancy (ticket ids) after
    each tick."""
    clk = FakeClock()
    eng = serve.SparseServeEngine(clock=clk, **engine_kw)
    for name, sess in sessions.items():
        eng.register_graph(name, sess)
    tickets, shed, lanes = [], [], []
    tick = 0
    while tick < len(schedule) or eng.pending():
        assert tick < 500, "engine did not drain"
        for graph, solver, payload, kw in schedule[tick] if tick < len(schedule) else ():
            try:
                tickets.append(eng.submit(graph, solver, payload=payload, **kw))
            except (serve.QueueFullError, serve.TenantQuotaError) as err:
                tickets.append(None)
                shed.append(type(err).__name__)
        eng.step()
        lanes.append({key: [None if t is None else t.tid for t in lane.tickets]
                      for key, lane in eng._lanes.items()})
        clk.advance(1.0)
        tick += 1
    return eng, tickets, shed, lanes


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30)) if b.size else 0.0


def _assert_same_serving(both, schedule, **engine_kw):
    got_j = _drive(jx_serve, both["jax"], schedule, **engine_kw)
    got_p = _drive(SERVE, both["port"], schedule, **engine_kw)
    (eng_j, tickets_j, shed_j, lanes_j), (eng_p, tickets_p, shed_p, lanes_p) = got_j, got_p
    assert shed_p == shed_j
    assert lanes_p == lanes_j  # admission order and slot of every ticket, tick by tick
    assert eng_p.metrics.snapshot() == eng_j.metrics.snapshot()
    for tj, tp in zip(tickets_j, tickets_p, strict=True):
        assert (tj is None) == (tp is None)
        if tj is None:
            continue
        assert tp.status.value == tj.status.value, (tj.tid, tj.error, tp.error)
        assert (tp.error, tp.t_start, tp.t_finish) == (tj.error, tj.t_start, tj.t_finish)
        if tj.status.value != "done":
            continue
        rj, rp = tj.result, tp.result
        assert (rp.iters_run, rp.converged) == (rj.iters_run, rj.converged)
        assert _rel(rp.x, rj.x) <= 1e-5
        assert _rel(rp.residuals, rj.residuals) <= 1e-5
        if tj.tol is not None and tj.tol > 0.0:
            # The tolerances are chosen far from every residual of the run,
            # so float32 rounding apart cannot make the packages stop on
            # different iterations; hold that here.
            assert all(abs(r / tj.tol - 1.0) > 1e-3 for r in rj.residuals), tj.tid
    return got_p


def _seeds(rng, mass_at=None):
    s = rng.random(N).astype(np.float32)
    return s if mass_at is None else np.where(np.arange(N) == mass_at, 1.0, 0.0).astype(
        np.float32)


def test_engine_matches_jax_under_one_schedule(both):
    """Four tenants (one weighted 2:1), a quota and a queue bound that
    shed, every stepper, two configs of pagerank, tol None / 0.0 / > 0,
    a bad payload and deadlines that expire queued and running tickets."""
    rng = np.random.default_rng(60)
    schedule = [[] for _ in range(8)]

    def sub(tick, graph, solver, payload, **kw):
        schedule[tick].append((graph, solver, payload, kw))

    for i in range(5):
        sub(0, "g1", "pagerank", {"seeds": _seeds(rng)}, tenant="heavy", iters=4 + i)
    for i in range(4):
        sub(0, "g1", "pagerank", {"seeds": _seeds(rng, mass_at=i)}, tenant="light",
            damping=0.5, iters=9, tol=1e-2)
    sub(0, "g1", "pagerank", {"seeds": np.zeros(N, np.float32)}, tenant="light")  # FAILED
    for _ in range(3):
        sub(1, "g2", "jacobi", {"b": rng.random(N).astype(np.float32)}, tenant="solver",
            iters=30, tol=2.6e-4)
    sub(1, "g2", "jacobi", {"b": np.zeros(N, np.float32)}, tenant="solver", tol=0.0)
    for _ in range(3):
        sub(2, "g1", "cg", {"b": rng.random(N).astype(np.float32)}, tenant="solver",
            iters=12, tol=None)
    for _ in range(4):
        sub(2, "g2", "spmv", {"x": rng.random(N).astype(np.float32)}, tenant="raw")
    sub(3, "g2", "jacobi", {"b": rng.random(N).astype(np.float32)}, tenant="raw",
        iters=40, timeout=2.5)  # expires mid-run
    for tenant in ("heavy", "raw"):  # bursts past the quota and the queue bound
        for _ in range(7):
            sub(4, "g1", "pagerank", {"seeds": _seeds(rng)}, tenant=tenant, iters=3,
                timeout=1.5)
    for _ in range(3):
        sub(7, "g2", "cg", {"b": rng.random(N).astype(np.float32)}, tenant="light", iters=5)
    eng, tickets, shed, _ = _assert_same_serving(
        both, schedule, batch_slots=3, max_queue=12, tenant_quota=6,
        tenant_weights={"heavy": 2.0}, default_iters=6,
    )
    statuses = {t.status for t in tickets if t is not None}
    assert statuses == {Status.DONE, Status.EXPIRED, Status.FAILED}
    assert shed and eng.metrics.rejected == len(shed)
    assert any(t.result.converged for t in tickets if t is not None and t.result)


def test_engine_matches_jax_on_deadlines_and_edf(both):
    """One slot, deadlines in every order: EDF within a tenant, FIFO for
    the deadline-less, expiry while queued, goodput in the metrics."""
    rng = np.random.default_rng(61)
    schedule = [[] for _ in range(3)]
    for timeout, iters in ((100.0, 2), (None, 2), (25.0, 2), (None, 2), (50.0, 2), (0.5, 5)):
        schedule[0].append(("g1", "pagerank", {"seeds": _seeds(rng)},
                            {"timeout": timeout, "iters": iters}))  # the last expires mid-run
    for timeout in (3.0, None):
        schedule[2].append(("g2", "jacobi", {"b": rng.random(N).astype(np.float32)},
                            {"timeout": timeout, "iters": 3, "tenant": "other"}))
    _, tickets, _, _ = _assert_same_serving(both, schedule, batch_slots=1, max_queue=16)
    assert {t.status for t in tickets} == {Status.DONE, Status.EXPIRED}
