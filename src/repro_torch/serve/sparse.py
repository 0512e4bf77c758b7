"""Multi-tenant sparse-solve serving with continuous slot batching.

The port of the JAX package's ``repro/serve/sparse.py``. Tenants submit
solves (``pagerank(seeds=...)`` per user, ``jacobi``/``cg`` right-hand
sides, raw ``spmv``) against *named registered graphs*; the engine packs
requests that share a ``(graph, solver, config)`` key onto one
slot-batched stepper (:class:`repro_torch.api.BatchStepper`) so B
tenants ride a single B-wide SpMM per iteration — one launch of the
Block-ELL kernel per exchange regime — applied across users instead of
within one.

**Continuous batching.** A solve's iteration count varies per request —
tol early-stops, different budgets — so slots free *individually*: each
tick, every converged / exhausted / expired slot is retired and refilled
from the queue before the lane steps again. The slot never goes cold
while demand exists, and a long solve never blocks a short one behind a
wave barrier.

**Trust.** A slot's trajectory is bitwise equal to a direct
batched-of-1 ``session.solve`` with the same payload (the stepper
contract: per-row host arithmetic + per-column-stable SpMM + ``np.where``
freezing), so serving through the engine changes *scheduling*, never
*results*. A lane always steps at B = ``batch_slots``, whatever its
occupancy; the SpMM's column j at that B is bitwise its B = 1 result on
every exchange, on the CPU and on the card.

**Admission control.** Requests carry a ``tenant`` id. The queue is
bounded two ways: past ``max_queue`` total waiting requests ``submit``
raises :class:`QueueFullError`, and past ``tenant_quota`` waiting
requests *from one tenant* it raises :class:`TenantQuotaError` — typed
load shedding either way, but the caller can tell "the engine is full"
from "you are over your share". Already-expired queued tickets are
swept before either bound is checked, so a burst of short-timeout
requests can never fill the queue with corpses. Each request may carry
a ``timeout``; its deadline is enforced while queued and between
iterations, moving the ticket to ``EXPIRED`` cleanly (slot freed,
engine keeps running). Bad payloads (wrong shape, zero seed mass, zero
diagonal) fail only their own ticket (``FAILED`` + ``ticket.error``),
never the engine.

**Fair, SLA-aware refill.** Free slots are granted by deficit-weighted
fair queueing *across tenants*: each admission charges the tenant
``1/weight`` of normalized service (``tenant_weights``, default 1.0)
and every free slot goes to the least-served backlogged tenant, ties
rotating past the last tenant granted a slot — so one flooding tenant
cannot starve the rest, and a weight-2 tenant really gets twice the
slots even when they free one at a time. *Within* a tenant's share,
candidates go earliest-deadline-first; deadline-less tickets keep FIFO
order behind deadlined ones. A candidate whose lane is full is skipped
without blocking candidates bound for other lanes (no head-of-line
blocking). With :class:`~repro_torch.serve.driver.ServeDriver`, a
driver thread owns :meth:`SparseServeEngine.step` so clients just
``submit()`` and ``Ticket.wait()``. All engine entry points take an
internal lock, so submissions may race the driver's ticks freely;
ticket completion events fire only after a tick body commits.

**Tolerance semantics** are explicit: ``tol=None`` (the default) means
no early exit — the budget runs out; ``tol=0.0`` means *exact-zero
residual*; ``tol>0`` stops at the first iteration whose residual drops
strictly below it (matching the host drivers). The ``converged`` flag
follows the same rule.

**Plan-store graphs and live updates.** A graph registered by the path
of a saved plan hydrates lazily, per request, through the plan store's
memo (:func:`repro_torch.api.plancache.hydrate_session`) on the
engine's ``device``, so a cold graph costs nothing until it is asked
for and an evicted one is re-read from disk.
:meth:`SparseServeEngine.update_graph` applies a
:class:`~repro_torch.sparse.delta.SparseDelta` to a registered graph
with snapshot isolation: lanes in flight finish against the session
they started on, and requests for the graph wait until those lanes
drain, then run against the updated one. With a ``recovery_dir`` the
delta is journaled against the graph's last committed generation
(checkpointing one first when none exists), so a crash replays exactly
the live update chain.

**Fault tolerance.** Wire in the :mod:`repro_torch.runtime.fault`
scaffolding and the engine survives unit loss mid-anything: a
``fault_injector`` raises :class:`~repro_torch.runtime.fault.WorkerFailure`
at scheduled kill points (inside ``step``, ``update_graph``, and — via
``save_generation``'s ``before_commit`` — mid-checkpoint), at the same
points as the JAX engine, so one schedule kills at the same place in
both packages; every guarded body runs against a snapshot of all
mutable scheduler state (stepper arrays, slot occupancy, each lane's
source, ticket lifecycle fields, queue order, tenant deficits,
metrics), so recovery = restore snapshot → reload each laned graph from
its last good generation + journal → remap the plan's per-unit shards
onto the survivor mesh (:func:`repro_torch.runtime.elastic.elastic_restart`)
→ rebind steppers with their saved state → rerun the body. Steppers are
deterministic, so the recovered trajectory is bitwise the uninterrupted
one — no ticket is lost, duplicated, or double-counted. A ``heartbeat``
detects units that die *between* ticks, and a ``latency_probe`` +
per-unit :class:`~repro_torch.runtime.fault.StragglerMonitor` demotes
persistently slow units through the same recovery path.

Unlike the JAX engine, recovery keeps snapshot isolation: a lane that an
``update_graph`` left stale is rebuilt around the matrix it started on
(its own source, or with a ``recovery_dir`` the last good generation
plus the part of the journal its source had seen), never around the
updated graph, so a half-done solve is not moved onto the new matrix.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.plancache import (
    hydrate_session,
    journal_delta,
    last_good_generation,
    load_journal,
    load_last_good,
    replay_journal,
    save_generation,
)
from repro_torch.api.session import SparseSession, UpdateReport
from repro_torch.api.solvers import STEPPERS, BatchStepper, SolveResult
from repro_torch.runtime.elastic import P, elastic_restart, local_devices, make_mesh_any
from repro_torch.runtime.fault import (
    FaultInjector,
    Heartbeat,
    StragglerMonitor,
    WorkerFailure,
)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.sparse.delta import SparseDelta

__all__ = [
    "QueueFullError",
    "SparseServeEngine",
    "Status",
    "TenantQuotaError",
    "Ticket",
]

# submit(tol=...) default marker: distinguishes "use the engine default"
# from an explicit tol=None ("no early exit").
_UNSET = object()


def _hit_tol(tol: Optional[float], res: float) -> bool:
    """The engine's explicit tolerance contract: ``None`` never stops
    early, ``0.0`` stops on an exact-zero residual, positive stops
    strictly below (the host drivers' convention)."""
    if tol is None:
        return False
    return res < tol if tol > 0.0 else res == 0.0


def _edf_key(ticket: "Ticket") -> Tuple[bool, float, int]:
    """Within-tenant dispatch order: earliest deadline first;
    deadline-less tickets keep submission (FIFO) order behind every
    deadlined one."""
    has_none = ticket.deadline is None
    return (has_none, 0.0 if has_none else ticket.deadline, ticket.tid)


class QueueFullError(RuntimeError):
    """Typed load-shed signal: the admission queue is at ``max_queue``.

    Carries ``max_queue`` so callers can log/backoff without parsing the
    message."""

    def __init__(self, max_queue: int):
        super().__init__(
            f"serve queue full ({max_queue} waiting requests); shed or retry"
        )
        self.max_queue = max_queue


class TenantQuotaError(RuntimeError):
    """Typed per-tenant load-shed: ``tenant`` already has ``quota``
    waiting requests. Distinct from :class:`QueueFullError` so a caller
    can tell "the engine is full" (back off globally) from "you are
    over your share" (the engine still has room for everyone else)."""

    def __init__(self, tenant: str, quota: int):
        super().__init__(
            f"tenant {tenant!r} is at its queue quota "
            f"({quota} waiting requests); shed or retry"
        )
        self.tenant = tenant
        self.quota = quota


class Status(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    EXPIRED = "expired"  # deadline passed, queued or mid-run
    FAILED = "failed"  # per-ticket error (bad payload / solver config)


@dataclasses.dataclass(eq=False)
class Ticket:
    """One request's handle; the engine mutates it through the lifecycle.

    ``result`` is a :class:`SolveResult` once ``status is Status.DONE``
    — field-for-field what the direct ``session.solve`` call would have
    returned. ``error`` carries the failure text for ``FAILED``
    tickets. ``wait()`` blocks until the ticket reaches a terminal
    status (how a client sleeps on a driver-run engine; the event fires
    only after the tick that finished it commits). Identity
    semantics (``eq=False``): two tickets are never "equal", they are
    the same request or not."""

    tid: int
    graph: str
    solver: str
    payload: Dict[str, np.ndarray]
    config: Tuple[Tuple[str, object], ...]
    iters: int
    tol: Optional[float]
    deadline: Optional[float]
    tenant: str = "default"
    status: Status = Status.QUEUED
    result: Optional[SolveResult] = None
    error: Optional[str] = None
    t_submit: float = 0.0
    t_start: Optional[float] = None
    t_finish: Optional[float] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False
    )

    @property
    def lane_key(self) -> Tuple[str, str, Tuple]:
        return (self.graph, self.solver, self.config)

    @property
    def terminal(self) -> bool:
        return self.status not in (Status.QUEUED, Status.RUNNING)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the ticket is terminal (DONE/EXPIRED/FAILED);
        returns ``False`` on timeout. Requires something to be ticking
        the engine — a :class:`~repro_torch.serve.driver.ServeDriver` or a
        caller-driven loop on another thread."""
        return self._event.wait(timeout)


class _Lane:
    """One live stepper: fixed ``[slots, N]`` state for one
    (graph, solver, config) key, with per-slot occupancy. ``source`` is
    the graph's registered source when the lane was built; once
    :meth:`SparseServeEngine.update_graph` replaces it, the lane is
    stale: it finishes what it holds and takes no new ticket.
    ``lineage`` is set then, under a ``recovery_dir``: the committed
    generation and the number of its journaled deltas that the lane's
    source is, which is how recovery rebuilds that matrix from disk."""

    def __init__(self, stepper: BatchStepper, source):
        self.stepper = stepper
        self.source = source
        self.lineage: Optional[Tuple[int, int]] = None
        self.slots = stepper.slots
        self.tickets: List[Optional[Ticket]] = [None] * self.slots
        self.active = np.zeros(self.slots, dtype=bool)
        self.iters_done = np.zeros(self.slots, dtype=np.int64)
        self.budget = np.zeros(self.slots, dtype=np.int64)
        self.residuals: List[List[float]] = [[] for _ in range(self.slots)]

    @property
    def occupied(self) -> int:
        return int(self.active.sum())

    def free_slot(self) -> Optional[int]:
        idle = np.nonzero(~self.active)[0]
        return int(idle[0]) if idle.shape[0] else None

    def load(self, slot: int, ticket: Ticket) -> None:
        self.stepper.load(slot, **ticket.payload)
        self.tickets[slot] = ticket
        self.active[slot] = True
        self.iters_done[slot] = 0
        fixed = self.stepper.fixed_iters
        self.budget[slot] = ticket.iters if fixed is None else fixed
        self.residuals[slot] = []

    def retire(self, slot: int) -> None:
        """Return ``slot`` to the free pool, resetting every per-slot
        bookkeeping field to its vacant state. Idempotent by
        construction — retiring a never-loaded (or already-retired)
        slot rewrites the vacant state it already has — so the failed
        ``load`` path may call it unconditionally."""
        self.tickets[slot] = None
        self.active[slot] = False
        self.iters_done[slot] = 0
        self.budget[slot] = 0
        self.residuals[slot] = []


class SparseServeEngine:
    """Continuous-batching scheduler over registered sparse sessions.

    ``batch_slots`` sizes every lane's stepper (the B of the shared
    SpMM); ``max_queue`` bounds *waiting* admissions (running slots
    don't count) and ``tenant_quota`` bounds one tenant's share of them;
    ``tenant_weights`` skews the refill round-robin (default weight
    1.0). ``default_iters`` / ``default_tol`` apply when a request
    doesn't override them (``default_tol=None``: no early exit).
    ``executor`` overrides the executor of registered sessions;
    ``device`` is where graphs registered by path are hydrated and where
    a recovery rebuilds sessions (the card when omitted; a registered
    session keeps its own device until then);
    ``clock`` is injectable (tests drive deadlines with a fake clock;
    production uses ``time.monotonic``).

    Thread-safe by locking: every public entry point (``submit``,
    :meth:`step`, ``pending``) takes one internal RLock, so a
    :class:`~repro_torch.serve.driver.ServeDriver` thread can own the
    tick cadence while request threads ``submit()`` and ``wait()`` on
    tickets. The engine itself never blocks beyond one tick.

    Fault-tolerance wiring (all optional, zero overhead when absent):
    ``fault_injector`` schedules :class:`WorkerFailure` at engine fault
    points (a global counter ticks at each one — see :meth:`_fault_tick`
    for the ordering); ``heartbeat`` detects units dead between ticks;
    ``recovery_dir`` enables generation checkpoints + delta journaling
    (:meth:`checkpoint_graph`, :meth:`update_graph`) and makes recovery
    reload from disk instead of the live session; ``latency_probe``
    (``() -> {unit: latency}``) feeds per-unit straggler monitors —
    ``straggler_patience`` consecutive flags demote the unit through
    the unit-loss path. ``max_recoveries`` bounds recovery attempts per
    guarded call so a hard-wedged cluster fails loudly. ``recovery_log``
    holds one record per recovery: the lost unit and its seconds by part
    (see :meth:`_recover_unit_loss`).
    """

    def __init__(
        self,
        *,
        batch_slots: int = 8,
        max_queue: int = 64,
        tenant_quota: Optional[int] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        default_iters: int = 50,
        default_tol: Optional[float] = None,
        executor: Optional[str] = None,
        device=None,
        clock=time.monotonic,
        fault_injector: Optional[FaultInjector] = None,
        heartbeat: Optional[Heartbeat] = None,
        recovery_dir: Optional[str] = None,
        latency_probe: Optional[Callable[[], Dict[int, float]]] = None,
        straggler_factor: float = 3.0,
        straggler_patience: int = 3,
        max_recoveries: int = 8,
    ):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(f"tenant_quota must be >= 1, got {tenant_quota}")
        if tenant_weights and any(w <= 0.0 for w in tenant_weights.values()):
            raise ValueError("tenant_weights must all be > 0")
        if default_tol is not None and default_tol < 0.0:
            raise ValueError(f"default_tol must be >= 0 or None, got {default_tol}")
        self.batch_slots = int(batch_slots)
        self.max_queue = int(max_queue)
        self.tenant_quota = None if tenant_quota is None else int(tenant_quota)
        self.tenant_weights = dict(tenant_weights or {})
        self.default_iters = int(default_iters)
        self.default_tol = None if default_tol is None else float(default_tol)
        self.executor = executor
        self.device = device
        self.clock = clock
        self.metrics = ServeMetrics()
        self._graphs: Dict[str, Union[str, SparseSession]] = {}
        # Admission state: one FIFO deque per tenant (only tenants with
        # waiting work have an entry), normalized-service counters for
        # the deficit scheduler (each admission charges 1/weight; the
        # largest-deficit = least-served tenant admits first), and the
        # rotation cursor that breaks exact ties (last tenant granted a
        # slot goes to the back of the line).
        self._queues: Dict[str, "collections.deque[Ticket]"] = {}
        self._served: Dict[str, float] = {}
        self._rr_last: Optional[str] = None
        self._lanes: Dict[Tuple, _Lane] = {}
        self._next_tid = 0
        # -- threading: one lock for all scheduler state; an event the
        # driver sleeps on when idle (set by submit); completion events
        # deferred until the tick body commits.
        self._lock = threading.RLock()
        self._work_event = threading.Event()
        self._pending_events: List[Ticket] = []
        # -- fault tolerance state
        self.fault_injector = fault_injector
        self.heartbeat = heartbeat
        self.recovery_dir = recovery_dir
        self.latency_probe = latency_probe
        self.straggler_patience = int(straggler_patience)
        self.max_recoveries = int(max_recoveries)
        self.dead_units: set = set()
        self.recoveries = 0
        self.recovery_log: List[Dict[str, float]] = []
        self._fault_steps = 0
        self._silent_units: set = set()
        # (committed generation, journaled deltas) of each graph's
        # registered source, once a recovery_dir holds one.
        self._lineage: Dict[str, Tuple[int, int]] = {}
        self._straggler_monitors: Dict[int, StragglerMonitor] = (
            collections.defaultdict(lambda: StragglerMonitor(factor=straggler_factor))
        )
        self._straggler_strikes: Dict[int, int] = collections.defaultdict(int)
        self._probe_count = 0

    # -- registration ------------------------------------------------------

    def register_graph(
        self, name: str, source: Union[str, SparseSession]
    ) -> None:
        """Expose a graph to tenants. ``source`` is a live
        :class:`~repro_torch.api.SparseSession` or a path to a saved plan
        (``.npz`` from :meth:`SparseSession.save`, written by either
        package); paths hydrate lazily per request through the plan-store
        memo on the engine's ``device``, so registering ten thousand
        graphs costs nothing until they're asked for."""
        if not isinstance(source, (str, SparseSession)):
            raise TypeError(
                f"source must be a SparseSession or a plan path, got "
                f"{type(source).__name__}"
            )
        with self._lock:
            self._graphs[name] = source

    def graphs(self) -> List[str]:
        return sorted(self._graphs)

    def _session(self, name: str) -> SparseSession:
        return self._source_session(self._graphs[name])

    def _source_session(self, source) -> SparseSession:
        """The session a registered ``source`` (session or plan path)
        stands for, as :meth:`_session` resolves it."""
        if isinstance(source, str):
            return hydrate_session(source, executor=self.executor, device=self.device)
        if self.executor is not None and source.executor != self.executor:
            return source.with_executor(self.executor)
        return source

    # -- streaming updates + checkpoints -----------------------------------

    def update_graph(
        self, name: str, delta: SparseDelta, *, force: Optional[str] = None
    ) -> UpdateReport:
        """Apply ``delta`` to registered graph ``name`` in place.

        Runs :meth:`SparseSession.update` (patch-or-replan), journals the
        delta against the graph's committed generation when the engine
        has a ``recovery_dir`` (checkpointing a base generation first if
        none exists yet), then swaps the registered source to the
        mutated session. Lanes already running keep their old session
        until they drain — snapshot isolation, so an in-flight solve is
        never answered half against each matrix — and requests for the
        graph are admitted to a lane over the new session once the old
        lane has drained. Returns the update's
        :class:`~repro_torch.api.session.UpdateReport`.

        Fault points: one before the update is computed, one after it
        but before any side effect — a kill at either leaves the engine
        unchanged, recovery reruns the whole method.
        """
        if name not in self._graphs:
            known = ", ".join(sorted(self._graphs)) or "<none>"
            raise KeyError(f"unknown graph {name!r}; registered: {known}")

        def body():
            sess = self._session(name)
            self._fault_tick()  # kill point: before the update
            new = sess.update(delta, force=force)
            self._fault_tick()  # kill point: computed, nothing swapped yet
            # All side effects live below the last fault point, so a
            # recovery rerun can never journal or swap twice.
            if self.recovery_dir is not None:
                gen, seen = self._lineage.get(name, (None, 0))
                if gen is None:
                    gen = last_good_generation(self.recovery_dir, name)
                    if gen is not None:
                        seen = len(load_journal(self.recovery_dir, name, gen))
                if gen is None:
                    _, gen = save_generation(sess, self.recovery_dir, name)
                for key, lane in self._lanes.items():
                    if key[0] == name and lane.source is self._graphs[name]:
                        lane.lineage = (gen, seen)  # the lane goes stale here
                journal_delta(self.recovery_dir, name, gen, delta)
                self._lineage[name] = (gen, seen + 1)
            self._graphs[name] = new
            return new.update_report

        with self._lock:
            return self._guard(body)

    def checkpoint_graph(self, name: str) -> int:
        """Commit graph ``name``'s current plan as a new generation.

        Requires ``recovery_dir``. The commit is crash-safe end to end
        (:func:`repro_torch.api.plancache.save_generation`): the
        last-good marker advances only after the archive is complete,
        and this engine's mid-checkpoint fault point fires *between*
        archive write and marker advance — the worst possible moment —
        leaving the previous generation committed. Returns the
        generation number.
        """
        if self.recovery_dir is None:
            raise RuntimeError("checkpoint_graph requires recovery_dir")
        if name not in self._graphs:
            known = ", ".join(sorted(self._graphs)) or "<none>"
            raise KeyError(f"unknown graph {name!r}; registered: {known}")

        def body():
            sess = self._session(name)
            self._fault_tick()  # kill point: before the archive write
            _, gen = save_generation(
                sess, self.recovery_dir, name, before_commit=self._fault_tick
            )
            self._lineage[name] = (gen, 0)
            return gen

        with self._lock:
            return self._guard(body)

    # -- fault handling ----------------------------------------------------

    def mark_unit_silent(self, unit: int) -> None:
        """Test hook: stop beating ``unit``'s heartbeat so it times out
        and is declared dead at a later tick."""
        self._silent_units.add(int(unit))

    def _fault_tick(self) -> None:
        """One engine fault point. The injector's schedule is keyed on a
        global counter over *all* fault points the engine passes, in
        deterministic order — the JAX engine's: for each ``step()``
        tick, one after refill then one after each lane's batched
        iteration (demand order); in ``update_graph``, before and after
        computing the update; in ``checkpoint_graph``, before the
        archive write and between the write and the marker commit."""
        self._fault_steps += 1
        if self.fault_injector is not None:
            self.fault_injector.check(self._fault_steps - 1)

    def _guard(self, body):
        """Run ``body`` with unit-loss recovery: snapshot all mutable
        scheduler state, and on :class:`WorkerFailure` restore it,
        recover the lost unit, and rerun. Free when no injector is
        wired (heartbeat-detected deaths happen *between* ticks and
        need no rollback)."""
        if self.fault_injector is None:
            return body()
        for _ in range(self.max_recoveries + 1):
            snap = self._snapshot()
            try:
                return body()
            except WorkerFailure as failure:
                self._restore(snap)
                self._recover_unit_loss(failure.worker)
        raise RuntimeError(
            f"gave up after {self.max_recoveries} recoveries in one call"
        )

    def _snapshot(self) -> dict:
        """Capture every piece of state a guarded body may mutate.

        Tickets are captured by identity (they are mutable dataclasses
        shared between the queues, lanes, and callers' hands — callers
        must observe the rolled-back lifecycle, so we restore fields in
        place rather than swap objects)."""
        tickets: Dict[int, tuple] = {}

        def cap(t: Optional[Ticket]) -> None:
            if t is not None and id(t) not in tickets:
                tickets[id(t)] = (
                    t, t.status, t.result, t.error, t.t_start, t.t_finish
                )

        lanes = {}
        for key, lane in self._lanes.items():
            for t in lane.tickets:
                cap(t)
            lanes[key] = (
                lane,
                lane.stepper.snapshot(),
                list(lane.tickets),
                lane.active.copy(),
                lane.iters_done.copy(),
                lane.budget.copy(),
                [list(r) for r in lane.residuals],
                lane.source,
                lane.lineage,
            )
        for q in self._queues.values():
            for t in q:
                cap(t)
        return {
            "queues": {tenant: list(q) for tenant, q in self._queues.items()},
            "served": dict(self._served),
            "rr_last": self._rr_last,
            "pending_events": list(self._pending_events),
            "tickets": tickets,
            "lanes": lanes,
            "metrics": copy.deepcopy(self.metrics),
            "next_tid": self._next_tid,
        }

    def _restore(self, snap: dict) -> None:
        self._queues = {
            tenant: collections.deque(q) for tenant, q in snap["queues"].items()
        }
        self._served = dict(snap["served"])
        self._rr_last = snap["rr_last"]
        self._pending_events = list(snap["pending_events"])
        for t, status, result, error, t_start, t_finish in snap["tickets"].values():
            t.status = status
            t.result = result
            t.error = error
            t.t_start = t_start
            t.t_finish = t_finish
        self._lanes = {}
        for key, (lane, state, tickets, active, iters, budget, residuals, source,
                  lineage) in snap["lanes"].items():
            lane.stepper.restore(state)
            lane.tickets = list(tickets)
            lane.active = active.copy()
            lane.iters_done = iters.copy()
            lane.budget = budget.copy()
            lane.residuals = [list(r) for r in residuals]
            lane.source = source
            lane.lineage = lineage
            self._lanes[key] = lane
        self.metrics = snap["metrics"]
        self._next_tid = snap["next_tid"]

    def _load_last_good(self, name: str, record: dict):
        """``(session, gen)`` of graph ``name``'s last good generation on
        the engine's device, its plan materialized, or ``None``."""
        t0 = time.perf_counter()
        got = load_last_good(
            self.recovery_dir, name, executor=self.executor, device=self.device
        )
        if got is not None:
            got[0].materialize()
        record["load_s"] += time.perf_counter() - t0
        return got

    def _replay(self, sess, name: str, gen: int, count, record: dict) -> SparseSession:
        t0 = time.perf_counter()
        sess = replay_journal(sess, self.recovery_dir, name, gen, count=count)
        record["replay_s"] += time.perf_counter() - t0
        return sess

    def _recovered_session(self, name: str, record: dict) -> SparseSession:
        """The session recovery rebuilds a graph's current lanes from:
        last good archive + journal replay when this engine persists
        generations (replay is deterministic, so it reproduces the live
        update chain bitwise), else the live registered session."""
        if self.recovery_dir is not None:
            got = self._load_last_good(name, record)
            if got is not None:
                return self._replay(got[0], name, got[1], None, record)
        return self._session(name)

    def _stale_session(self, lane: _Lane, name: str, record: dict) -> SparseSession:
        """The matrix a stale lane started on: the last good generation
        plus the journal prefix its source had seen, while that
        generation is still the last good one; else (no ``recovery_dir``,
        or a checkpoint since, which prunes the journal) the lane's own
        source."""
        if self.recovery_dir is not None and lane.lineage is not None:
            got = self._load_last_good(name, record)
            if got is not None and got[1] == lane.lineage[0]:
                return self._replay(got[0], name, got[1], lane.lineage[1], record)
        return self._source_session(lane.source)

    def _remap_onto_survivors(self, sess: SparseSession, record: dict) -> SparseSession:
        """Re-place the plan's per-unit shard arrays on a mesh sized to
        the surviving units via the elastic runtime
        (:func:`make_mesh_any` → :func:`elastic_restart`), over at most
        as many devices of the engine's kind as this process has, and
        back to the host. The logical plan is mesh-agnostic, so the round
        trip is value-preserving — results after recovery stay bitwise —
        while exercising the placement path a multi-card deployment
        would take. The rebuilt session computes on the engine's
        ``device``."""
        if not self.dead_units:
            return sess
        t0 = time.perf_counter()
        dp = sess.device_plan
        survivors = max(1, sess.topology.units - len(self.dead_units))
        width = min(survivors, len(local_devices(self.device)))
        mesh = make_mesh_any((width,), ("units",), device=self.device)
        tree = {"tiles": dp.tiles, "tile_row": dp.tile_row, "tile_col": dp.tile_col}

        class _TreeRestore:
            def restore(self, template, step):
                return tree, 0

        placed, _ = elastic_restart(_TreeRestore(), None, mesh, lambda key, leaf: P())
        dp2 = dataclasses.replace(
            dp,
            tiles=np.asarray(placed["tiles"]),
            tile_row=np.asarray(placed["tile_row"]),
            tile_col=np.asarray(placed["tile_col"]),
        )
        out = SparseSession(
            sess.matrix,
            sess.topology,
            sess.partition,
            dp2,
            exchange=sess.exchange,
            selective=sess._selective,
            executor=sess.executor,
            device=resolve_device(self.device),
            tile_transform=sess.tile_transform,
        )
        for attr in ("_plan_config", "_t_iter_model"):
            if hasattr(sess, attr):
                setattr(out, attr, getattr(sess, attr))
        record["remap_s"] += time.perf_counter() - t0
        return out

    def _recover_unit_loss(self, unit: int) -> None:
        """Unit ``unit`` is gone: rebuild every lane's session, remap it
        onto the survivors, and rebind the lane's stepper around it with
        its in-flight state intact (generic numpy snapshot/restore — the
        stepper contract). A current lane gets its graph's recovered
        session, which future lanes plan against too; a stale lane gets
        the matrix it started on (:meth:`_stale_session`) and stays
        stale. Appends ``{"unit", "load_s", "replay_s", "remap_s",
        "rebind_s", "total_s"}`` to ``recovery_log``: the last good
        generation's load, the journal replay, the remap round trip, the
        steppers' rebuild (a first spmv for some), and all of it."""
        t0 = time.perf_counter()
        self.dead_units.add(int(unit))
        record = dict.fromkeys(("load_s", "replay_s", "remap_s", "rebind_s"), 0.0)
        current: Dict[str, SparseSession] = {}
        stale: Dict[int, SparseSession] = {}
        for key, lane in self._lanes.items():
            graph, solver, config = key
            if lane.source is self._graphs[graph]:
                if graph not in current:
                    current[graph] = self._remap_onto_survivors(
                        self._recovered_session(graph, record), record
                    )
                sess = current[graph]
            else:
                if id(lane.source) not in stale:
                    stale[id(lane.source)] = self._remap_onto_survivors(
                        self._stale_session(lane, graph, record), record
                    )
                sess = stale[id(lane.source)]
            t1 = time.perf_counter()
            state = lane.stepper.snapshot()
            stepper = STEPPERS.get(solver)(sess, self.batch_slots, **dict(config))
            stepper.restore(state)
            lane.stepper = stepper
            lane.source = sess
            record["rebind_s"] += time.perf_counter() - t1
        # Future lanes plan against the recovered session too.
        for graph, sess in current.items():
            self._graphs[graph] = sess
        self.recoveries += 1
        self.recovery_log.append(
            {"unit": int(unit), **record, "total_s": time.perf_counter() - t0}
        )

    def _probe_stragglers(self) -> None:
        """Feed the per-unit straggler monitors one latency sample per
        live unit; ``straggler_patience`` consecutive flags demote the
        unit through the unit-loss recovery path (its shards move to
        the survivors, its monitor stops being consulted)."""
        if self.latency_probe is None:
            return
        sample = self.latency_probe()
        self._probe_count += 1
        demote = []
        for unit, latency in sorted(sample.items()):
            if unit in self.dead_units:
                continue
            if self._straggler_monitors[unit].observe(self._probe_count, latency):
                self._straggler_strikes[unit] += 1
                if self._straggler_strikes[unit] >= self.straggler_patience:
                    demote.append(unit)
            else:
                self._straggler_strikes[unit] = 0
        for unit in demote:
            self._recover_unit_loss(unit)

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        graph: str,
        solver: str = "pagerank",
        *,
        payload: Optional[Dict[str, np.ndarray]] = None,
        iters: Optional[int] = None,
        tol=_UNSET,
        timeout: Optional[float] = None,
        tenant: str = "default",
        **config,
    ) -> Ticket:
        """Admit one request for ``tenant``; returns its :class:`Ticket`.

        Raises :class:`QueueFullError` when ``max_queue`` requests are
        already waiting, :class:`TenantQuotaError` when this tenant
        alone holds ``tenant_quota`` of them (both typed load shedding
        — and both checked only after already-expired queued tickets
        are swept, so dead backlog never counts against live
        admissions), ``KeyError`` for an unregistered graph or solver
        without a batch stepper — admission-time errors raise, because
        the caller is still on the line; errors only detectable at load
        time (payload shape, zero diagonal) surface later as ``FAILED``
        tickets.

        ``tol`` semantics: omitted → the engine's ``default_tol``;
        ``None`` → no early exit; ``0.0`` → stop on an exact-zero
        residual; positive → stop strictly below it.
        """
        with self._lock:
            if graph not in self._graphs:
                known = ", ".join(sorted(self._graphs)) or "<none>"
                raise KeyError(f"unknown graph {graph!r}; registered: {known}")
            if solver not in STEPPERS:
                raise KeyError(
                    f"solver {solver!r} has no batch stepper; steppable: "
                    f"{', '.join(sorted(STEPPERS.names()))}"
                )
            if iters is not None and iters < 1:
                raise ValueError(f"iters must be >= 1, got {iters}")
            if tol is _UNSET:
                tol = self.default_tol
            if tol is not None and float(tol) < 0.0:
                raise ValueError(f"tol must be >= 0 or None, got {tol}")
            now = self.clock()
            # Prune expired queued tickets *before* the bound checks — a
            # burst of short-timeout requests must not trip
            # QueueFullError on an effectively empty queue.
            self._sweep_expired(now)
            self._fire_events()
            if sum(len(q) for q in self._queues.values()) >= self.max_queue:
                self.metrics.rejected += 1
                self.metrics.tenant(tenant).rejected += 1
                raise QueueFullError(self.max_queue)
            if (
                self.tenant_quota is not None
                and len(self._queues.get(tenant, ())) >= self.tenant_quota
            ):
                self.metrics.rejected += 1
                self.metrics.tenant(tenant).rejected += 1
                raise TenantQuotaError(tenant, self.tenant_quota)
            ticket = Ticket(
                tid=self._next_tid,
                graph=graph,
                solver=solver,
                payload=dict(payload or {}),
                config=tuple(sorted(config.items())),
                iters=self.default_iters if iters is None else int(iters),
                tol=None if tol is None else float(tol),
                deadline=None if timeout is None else now + float(timeout),
                tenant=str(tenant),
                t_submit=now,
            )
            self._next_tid += 1
            self._queues.setdefault(ticket.tenant, collections.deque()).append(ticket)
            self.metrics.submitted += 1
            self.metrics.tenant(ticket.tenant).submitted += 1
            self._work_event.set()
            return ticket

    # -- scheduling --------------------------------------------------------

    def pending(self) -> int:
        """Waiting + running request count."""
        with self._lock:
            running = sum(lane.occupied for lane in self._lanes.values())
            return sum(len(q) for q in self._queues.values()) + running

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Driver support: block until a submission arrives (or work is
        already pending), at most ``timeout`` seconds. Returns whether
        there is (probably) work. Deliberately *not* under the engine
        lock — an idle driver sleeping here must never block
        submitters."""
        self._work_event.clear()
        if self.pending():
            return True
        return self._work_event.wait(timeout)

    def _queued_tickets(self) -> List[Ticket]:
        return [t for q in self._queues.values() for t in q]

    def _fail(self, ticket: Ticket, err: Exception, now: float) -> None:
        ticket.status = Status.FAILED
        ticket.error = f"{type(err).__name__}: {err}"
        ticket.t_finish = now
        self.metrics.failed += 1
        self.metrics.tenant(ticket.tenant).failed += 1
        self._pending_events.append(ticket)

    def _expire(self, ticket: Ticket, now: float) -> None:
        ticket.status = Status.EXPIRED
        ticket.t_finish = now
        self.metrics.expired += 1
        self.metrics.tenant(ticket.tenant).expired += 1
        self._pending_events.append(ticket)

    def _finish(self, lane: _Lane, slot: int, now: float) -> None:
        ticket = lane.tickets[slot]
        hist = lane.residuals[slot]
        ticket.result = SolveResult(
            solver=ticket.solver,
            x=lane.stepper.extract(slot),
            value=hist[-1] if hist else 0.0,
            residuals=list(hist),
            iters_run=len(hist),
            converged=bool(hist) and _hit_tol(ticket.tol, hist[-1]),
        )
        ticket.status = Status.DONE
        ticket.t_finish = now
        self.metrics.completed += 1
        tm = self.metrics.tenant(ticket.tenant)
        tm.completed += 1
        if ticket.deadline is None or now <= ticket.deadline:
            self.metrics.goodput += 1
            tm.goodput += 1
        self.metrics.record_latency(
            wait=ticket.t_start - ticket.t_submit,
            run=now - ticket.t_start,
            total=now - ticket.t_submit,
            tenant=ticket.tenant,
        )
        self._pending_events.append(ticket)
        lane.retire(slot)

    def _fire_events(self) -> None:
        """Release waiters on tickets that reached a terminal status.
        Called only after a tick body commits (or from admission
        paths)."""
        done, self._pending_events = self._pending_events, []
        for t in done:
            t._event.set()

    def _sweep_expired(self, now: float) -> None:
        """Expire every queued ticket whose deadline has passed, and
        drop tenants whose queue emptied (their service counter resets
        — no carrying credit or debt while idle)."""
        for tenant, q in list(self._queues.items()):
            if any(t.deadline is not None and now > t.deadline for t in q):
                keep = collections.deque()
                for t in q:
                    if t.deadline is not None and now > t.deadline:
                        self._expire(t, now)
                    else:
                        keep.append(t)
                self._queues[tenant] = keep
        for tenant in [t for t, q in self._queues.items() if not q]:
            del self._queues[tenant]
            self._served.pop(tenant, None)

    def _dequeue(self, ticket: Ticket) -> None:
        q = self._queues.get(ticket.tenant)
        if q is not None:
            try:
                q.remove(ticket)  # identity match: Ticket has eq=False
            except ValueError:
                pass
            if not q:
                del self._queues[ticket.tenant]
                self._served.pop(ticket.tenant, None)

    def _admit_one(self, cand: List[Ticket], now: float) -> bool:
        """Place one tenant's best admissible candidate into a free
        slot; candidates whose lane is full are skipped (no head-of-line
        blocking across lanes), candidates that fail lane creation or
        load are FAILED and removed without consuming the tenant's
        turn. Returns whether a slot was filled."""
        i = 0
        while i < len(cand):
            ticket = cand[i]
            key = ticket.lane_key
            lane = self._lanes.get(key)
            source = self._graphs[ticket.graph]
            if lane is not None and lane.source is not source:
                # The graph was updated under this lane: the lane drains
                # against the old session, then gives way to a new one.
                if lane.occupied:
                    i += 1
                    continue
                del self._lanes[key]
                lane = None
            if lane is None:
                try:
                    session = self._session(ticket.graph)
                    stepper = STEPPERS.get(ticket.solver)(
                        session, self.batch_slots, **dict(ticket.config)
                    )
                except Exception as err:  # bad config (e.g. zero diagonal)
                    self._dequeue(ticket)
                    cand.pop(i)
                    self._fail(ticket, err, now)
                    continue
                lane = self._lanes[key] = _Lane(stepper, source)
            slot = lane.free_slot()
            if slot is None:
                i += 1
                continue
            try:
                lane.load(slot, ticket)
            except Exception as err:  # bad payload; slot stays free
                lane.retire(slot)  # idempotent no-op on the vacant slot
                self._dequeue(ticket)
                cand.pop(i)
                self._fail(ticket, err, now)
                continue
            ticket.status = Status.RUNNING
            ticket.t_start = now
            self._dequeue(ticket)
            cand.pop(i)
            return True
        return False

    def _refill(self, now: float) -> None:
        """Move queued tickets into free slots by deficit-weighted fair
        queueing across tenants, earliest-deadline-first within each
        tenant (deadline-less tickets keep FIFO order behind deadlined
        ones).

        Each admission charges the tenant ``1/weight`` of normalized
        service; every free slot goes to the *least-served* (largest
        deficit) backlogged tenant, with exact ties broken by rotating
        past the last tenant granted a slot. Because selection is by
        outstanding deficit — not queue-visit order — the weighted
        shares hold even when slots free one at a time (pure
        visit-order round-robin degrades to 1:1 there, whatever the
        weights). Counters persist while a tenant stays backlogged and
        reset when its queue drains; a newly backlogged tenant starts
        at the current backlogged minimum, so it competes from "now"
        rather than replaying history in a burst. Expired queued
        tickets are swept first."""
        self._sweep_expired(now)
        if not self._queues:
            return
        cand = {
            tenant: sorted(q, key=_edf_key) for tenant, q in self._queues.items()
        }
        floor = min(
            (self._served[t] for t in cand if t in self._served), default=0.0
        )
        for tenant in cand:
            self._served.setdefault(tenant, floor)
        while True:
            live = sorted(t for t in cand if cand[t])
            if not live:
                return
            if self._rr_last in live:
                pivot = live.index(self._rr_last) + 1
                live = live[pivot:] + live[:pivot]
            live.sort(key=lambda t: self._served[t])  # stable: ties keep rotation
            admitted = False
            for tenant in live:
                if self._admit_one(cand[tenant], now):
                    # _dequeue may have dropped the counter (queue
                    # drained); charge only a still-backlogged tenant.
                    if tenant in self._served:
                        self._served[tenant] += 1.0 / self.tenant_weights.get(
                            tenant, 1.0
                        )
                    self._rr_last = tenant
                    admitted = True
                    break  # re-rank: the next slot goes to the new minimum
            if not admitted:
                return

    def step(self) -> bool:
        """One scheduling tick: expire/refill from the queues, then
        advance every occupied lane by exactly one solver iteration
        (one batched SpMM per lane). Returns whether any lane actually
        stepped — ``False`` means idle, the signal a driver uses to
        back off.

        Fault-tolerant engines do three more things per tick: units the
        heartbeat declared dead since the last tick are recovered up
        front (between-tick loss mutates nothing mid-flight, so no
        rollback is needed); the tick body runs under :meth:`_guard`
        (mid-tick :class:`WorkerFailure` → restore + recover + rerun,
        bitwise-identical because steppers are deterministic); and
        afterwards the straggler probe may demote a persistently slow
        unit. Surviving units then heartbeat. Ticket completion events
        fire only after the guarded body commits."""
        with self._lock:
            if self.heartbeat is not None:
                # Live units check in first (a long gap between ticks must
                # not read as fleet-wide death); only units that stopped
                # reporting — killed or marked silent — stay stale and trip
                # the timeout.
                for unit in self.heartbeat.last_seen:
                    if unit not in self.dead_units and unit not in self._silent_units:
                        self.heartbeat.beat(unit)
                for unit in self.heartbeat.dead_workers():
                    if unit not in self.dead_units:
                        self._recover_unit_loss(unit)
            worked = self._guard(self._step_inner)
            self._probe_stragglers()
            self._fire_events()
            return worked

    def _step_inner(self) -> bool:
        """The tick body (see :meth:`step` for scheduling semantics).

        Lanes step in **demand order** — occupied slots plus tickets
        still queued for the lane, busiest first (ties keep lane
        creation order; the sort is stable). Within one tick every lane
        still advances exactly once, but the heavily loaded lanes run
        earliest, so their deadline checks see the least wall-clock
        drift and their slots free up first for the next refill.

        Metrics contract: ``ticks`` counts ticks where at least one
        lane stepped, and ``slot_ticks``/``slot_capacity`` accumulate
        for exactly those lanes — so ``occupancy`` and per-tick rates
        always agree (queue-only or cleanup-only ticks count nothing)."""
        now = self.clock()
        self._refill(now)
        self._fault_tick()  # kill point: slots loaded, nothing stepped
        queued = collections.Counter(t.lane_key for t in self._queued_tickets())
        order = sorted(
            self._lanes,
            key=lambda k: self._lanes[k].occupied + queued[k],
            reverse=True,
        )
        stepped = 0
        for key in order:
            lane = self._lanes[key]
            if lane.occupied == 0:
                # Idle lane with nothing queued for it: drop, releasing
                # the session reference so memo eviction can reclaim it.
                if not any(t.lane_key == key for t in self._queued_tickets()):
                    del self._lanes[key]
                continue
            active = lane.active.copy()
            res = lane.stepper.step(active)
            self._fault_tick()  # kill point: mid-tick, one lane advanced
            stepped += 1
            self.metrics.lane_steps += 1
            self.metrics.slot_iters += int(active.sum())
            after = self.clock()
            for slot in np.nonzero(active)[0]:
                ticket = lane.tickets[slot]
                lane.residuals[slot].append(float(res[slot]))
                lane.iters_done[slot] += 1
                hit_tol = _hit_tol(ticket.tol, float(res[slot]))
                exhausted = lane.iters_done[slot] >= lane.budget[slot]
                if hit_tol or exhausted:
                    self._finish(lane, slot, after)
                elif ticket.deadline is not None and after > ticket.deadline:
                    lane.retire(slot)
                    self._expire(ticket, after)
            self.metrics.slot_ticks += int(active.sum())
            self.metrics.slot_capacity += lane.slots
        if stepped:
            self.metrics.ticks += 1
        return stepped > 0

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        """Tick until every admitted request reached a terminal status.

        Raises ``RuntimeError`` if ``max_ticks`` elapse first — the
        guard that turns a scheduling bug into a loud failure instead
        of a hang (same contract as the LM engine)."""
        for _ in range(max_ticks):
            if self.pending() == 0:
                return
            self.step()
        raise RuntimeError(
            f"serve engine did not drain within {max_ticks} ticks "
            f"({self.pending()} requests outstanding)"
        )
