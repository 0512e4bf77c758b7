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

**Not ported yet** (ROADMAP.md, Queue 1): graphs registered by path and
their lazy hydration wait for the plan cache (item 3);
:meth:`SparseServeEngine.update_graph` and
:meth:`SparseServeEngine.checkpoint_graph` wait for the plan cache and
the runtime (items 3 and 4); the fault-tolerance wiring — a
``fault_injector``, ``heartbeat``, ``recovery_dir`` or ``latency_probe``
and :meth:`SparseServeEngine.mark_unit_silent` — waits for the runtime
(item 4). Each raises ``NotImplementedError`` naming its item. The
engine's fault points (:meth:`SparseServeEngine._fault_tick`) are
counted already, in the JAX package's order.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.session import SparseSession
from repro_torch.api.solvers import STEPPERS, BatchStepper, SolveResult
from repro_torch.serve.metrics import ServeMetrics

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

# Where ROADMAP.md lists what this module leaves out.
_PLAN_CACHE = "the plan cache (ROADMAP.md, Queue 1, item 3)"
_RUNTIME = "the fault-tolerance runtime (ROADMAP.md, Queue 1, item 4)"


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
    (graph, solver, config) key, with per-slot occupancy."""

    def __init__(self, stepper: BatchStepper):
        self.stepper = stepper
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
    ``clock`` is injectable (tests drive deadlines with a fake clock;
    production uses ``time.monotonic``).

    Thread-safe by locking: every public entry point (``submit``,
    :meth:`step`, ``pending``) takes one internal RLock, so a
    :class:`~repro_torch.serve.driver.ServeDriver` thread can own the
    tick cadence while request threads ``submit()`` and ``wait()`` on
    tickets. The engine itself never blocks beyond one tick.

    ``fault_injector``, ``heartbeat``, ``recovery_dir`` and
    ``latency_probe`` are the JAX package's fault-tolerance wiring; they
    are not ported yet, and giving any of them raises
    ``NotImplementedError``.
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
        clock=time.monotonic,
        fault_injector=None,
        heartbeat=None,
        recovery_dir: Optional[str] = None,
        latency_probe=None,
    ):
        wired = [name for name, value in (
            ("fault_injector", fault_injector), ("heartbeat", heartbeat),
            ("recovery_dir", recovery_dir), ("latency_probe", latency_probe),
        ) if value is not None]
        if wired:
            raise NotImplementedError(
                f"{', '.join(wired)}: {_RUNTIME} is not ported yet"
            )
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
        self.clock = clock
        self.metrics = ServeMetrics()
        self._graphs: Dict[str, SparseSession] = {}
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
        # Fault points passed so far (see _fault_tick).
        self._fault_steps = 0

    # -- registration ------------------------------------------------------

    def register_graph(self, name: str, source: SparseSession) -> None:
        """Expose a graph to tenants. ``source`` is a live
        :class:`~repro_torch.api.SparseSession`; a path to a saved plan
        waits for the plan cache and raises ``NotImplementedError``."""
        if isinstance(source, str):
            raise NotImplementedError(
                f"registering a graph by path needs {_PLAN_CACHE}, not ported yet; "
                "register a SparseSession"
            )
        if not isinstance(source, SparseSession):
            raise TypeError(
                f"source must be a SparseSession, got {type(source).__name__}"
            )
        with self._lock:
            self._graphs[name] = source

    def graphs(self) -> List[str]:
        return sorted(self._graphs)

    def _session(self, name: str) -> SparseSession:
        src = self._graphs[name]
        if self.executor is not None and src.executor != self.executor:
            return src.with_executor(self.executor)
        return src

    # -- streaming updates, checkpoints, fault handling (not ported yet) ----

    def update_graph(self, name: str, delta, *, force=None):
        """Apply a sparse delta to a registered graph: needs
        ``SparseSession.update`` and the delta journal, not ported yet."""
        raise NotImplementedError(
            f"update_graph needs {_PLAN_CACHE} and {_RUNTIME}, not ported yet"
        )

    def checkpoint_graph(self, name: str) -> int:
        """Commit a graph's plan as a new generation: needs the
        generation store, not ported yet."""
        raise NotImplementedError(
            f"checkpoint_graph needs {_PLAN_CACHE} and {_RUNTIME}, not ported yet"
        )

    def mark_unit_silent(self, unit: int) -> None:
        """Heartbeat test hook: needs the runtime, not ported yet."""
        raise NotImplementedError(f"mark_unit_silent needs {_RUNTIME}, not ported yet")

    def _fault_tick(self) -> None:
        """One engine fault point. The JAX package keys its fault
        injector's schedule on a global counter over *all* fault points
        the engine passes, in deterministic order: for each ``step()``
        tick, one after refill then one after each lane's batched
        iteration (demand order). The port counts them the same way, so
        the runtime, once ported, finds the same order."""
        self._fault_steps += 1

    def _guard(self, body):
        """Run ``body``. With the runtime (not ported yet) this is where
        a failed unit is recovered and the body rerun."""
        return body()

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
                lane = self._lanes[key] = _Lane(stepper)
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
        back off. Ticket completion events fire after the tick body
        commits."""
        with self._lock:
            worked = self._guard(self._step_inner)
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
