"""The :class:`SparseSession` façade and :func:`distribute` entry point.

The port of the JAX package's ``repro/api/session.py``. One call chains
the whole paper pipeline — two-level partition, per-unit BELL packing,
exchange planning — and hands back a session whose ``spmv`` / ``solve``
/ ``costs`` methods run it under any registered executor, on the
session's device (the card unless the caller asks for the CPU).

The serving engine's unit, :meth:`SparseSession.batch_stepper`, and
:meth:`SparseSession.solve_batch` are here too, and so are the plan
store's hooks (``save`` / ``load``, ``distribute(cache_dir=...)``, lazy
planning artifacts), streaming updates (:meth:`SparseSession.update`)
and the static plan linter (``verify`` / ``validate=``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device, trace
from repro_torch.api.exchange import resolve_exchange
from repro_torch.api.executors import EXECUTORS, SpmvFn
from repro_torch.api.partitioners import PartitionResult, resolve_partitioner
from repro_torch.api.solvers import SOLVERS, STEPPERS, BatchStepper, SolveResult
from repro_torch.api.topology import Topology
from repro_torch.pmvc.dist import make_simulate_fn, pad_x, phase_costs, unblock_y
from repro_torch.pmvc.plan_device import (
    DevicePlan,
    ExchangePlan,
    OverlapPlan,
    build_overlap_plan,
    pack_units,
    patch_device_plan,
)
from repro_torch.sparse.bell import x_block_owner
from repro_torch.sparse.delta import SparseDelta
from repro_torch.sparse.formats import COO

__all__ = ["SparseSession", "UpdateReport", "distribute"]

# ---------------------------------------------------------------------------
# Streaming-update policy (DESIGN.md §14).
#
# PATCH_TOUCH_LIMIT: if a delta touches more than this fraction of the plan's
# real tiles, patching approaches the cost of a cold pack while inheriting a
# stale partition — replan instead.
# PATCH_DRIFT_LIMIT: patched plans keep the original partition; when the
# phase-cost model says the patched plan's iteration time has drifted past
# this factor of the baseline (the modeled t_iter when the partition was last
# computed), the stale partition is no longer paying for itself — replan.
# REPLAN_FM_KW: replans triggered by update() lighten the FM refinement
# budget — the previous plan is already a good warm start for the cost model,
# and update latency matters more than the last percent of cut quality.
PATCH_TOUCH_LIMIT = 0.25
PATCH_DRIFT_LIMIT = 1.25
REPLAN_FM_KW = {"fm_passes": 2, "fm_kicks": 1}


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What :meth:`SparseSession.update` decided and why.

    ``action`` is ``"patched"`` or ``"replanned"``; ``t_model_patched`` /
    ``t_model_baseline`` are the §9/§13 modeled iteration times that fed the
    drift rule (``None`` when the decision never reached the cost model)."""

    action: str
    reason: str
    structural: bool
    touched_tiles: int
    total_tiles: int
    t_model_patched: Optional[float] = None
    t_model_baseline: Optional[float] = None

    @property
    def touched_fraction(self) -> float:
        return self.touched_tiles / max(self.total_tiles, 1)


def _inherit_units(
    a: COO,
    elem_unit: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    *,
    ncb: int,
    bn: int,
    num_units: int,
) -> np.ndarray:
    """Deterministic unit assignment for elements inserted by a delta.

    Rule (documented in DESIGN.md §14): an inserted element at ``(r, c)``
    inherits the unit of the nearest existing element in row ``r`` (by
    ``|col - c|``, ties toward the smaller column); if row ``r`` is empty,
    the nearest existing element in column ``c`` (by ``|row - r|``, ties
    toward the smaller row); if both are empty, the x-ownership fallback
    ``x_block_owner(ncb, U)[c // bn]``.  The rule is a pure function of the
    old matrix + old assignment, so patched plans are reproducible and the
    property suite can rebuild them cold."""
    d = rows.shape[0]
    out = np.full(d, -1, dtype=np.int64)
    if d == 0:
        return out

    def nearest(sort_major, sort_minor, q_major, q_minor, stride):
        """Unit of the nearest old element sharing ``major`` with the query
        (minor-distance, ties toward the smaller minor); -1 if none."""
        stride = np.int64(stride)
        key = sort_major.astype(np.int64) * stride + sort_minor.astype(np.int64)
        order = np.argsort(key)
        ks, maj_s, min_s = key[order], sort_major[order], sort_minor[order]
        us = elem_unit[order]
        qk = q_major.astype(np.int64) * stride + q_minor.astype(np.int64)
        p = np.searchsorted(ks, qk)
        left = p - 1
        right = np.minimum(p, ks.size - 1)
        lok = (left >= 0) & (maj_s[np.maximum(left, 0)] == q_major)
        rok = (p < ks.size) & (maj_s[right] == q_major)
        ldist = np.where(lok, np.abs(min_s[np.maximum(left, 0)] - q_minor), 2**62)
        rdist = np.where(rok, np.abs(min_s[right] - q_minor), 2**62)
        # Ties toward the left neighbour == the smaller minor coordinate.
        use_left = lok & (~rok | (ldist <= rdist))
        unit = np.full(q_major.shape[0], -1, dtype=np.int64)
        unit[use_left] = us[np.maximum(left, 0)][use_left]
        use_right = ~use_left & rok
        unit[use_right] = us[right][use_right]
        return unit

    n, m = a.shape
    if a.nnz:
        out = nearest(a.row, a.col, rows, cols, m)
        miss = out < 0
        if miss.any():
            out[miss] = nearest(a.col, a.row, cols[miss], rows[miss], n)
    miss = out < 0
    if miss.any():
        out[miss] = x_block_owner(ncb, num_units)[cols[miss] // bn]
    return out


# Key of the session's device SpMM closure in the shared closure cache;
# not a string, so it never collides with an executor name.
_DEVICE_MV = ("device_spmm",)


class SparseSession:
    """A distributed sparse matrix, planned once and executable anywhere.

    Holds the immutable products of the planning pipeline (partition,
    packed device plan, exchange schedule), the device it computes on,
    and per-executor state built lazily and cached. Construct via
    :func:`distribute` (or :func:`repro_torch.api.interop.session_from_numpy`).

    Any of ``matrix`` / ``partition`` / ``device_plan`` / ``selective``
    may be passed as a zero-argument callable (a *thunk*): the plan store
    (DESIGN.md §11) loads sessions this way, deferring tile
    materialization until an executor first needs it. Thunks must be
    memoized (return the same object every call) — derived sessions
    (:meth:`with_executor`) share them raw, so a loaded plan is
    materialized at most once however many re-wraps exist.

    ``tile_transform`` is an optional elementwise value map applied to
    tile payloads at device-hoist time — the storage-sharing fast path
    behind :meth:`with_value_map` (``fn(0) == 0`` required, padding must
    stay inert).
    """

    def __init__(
        self,
        matrix: COO,
        topology: Topology,
        partition: PartitionResult,
        device_plan: DevicePlan,
        *,
        exchange: str,
        selective: ExchangePlan,
        executor: str,
        device: torch.device,
        tile_transform=None,
    ):
        self._matrix = matrix
        self.topology = topology
        self._partition = partition
        self._device_plan = device_plan
        self.exchange = exchange
        self._selective = selective
        self.executor = executor
        self.device = torch.device(device)
        self.tile_transform = tile_transform
        self._spmv_cache: Dict[object, Callable] = {}

    # -- lazy planning artifacts -------------------------------------------
    # Each property materializes a thunk in place on first access; the
    # raw slot keeps the thunk so derived sessions can share it unforced.

    @property
    def matrix(self) -> COO:
        if callable(self._matrix):
            self._matrix = self._matrix()
        return self._matrix

    @property
    def partition(self) -> PartitionResult:
        if callable(self._partition):
            self._partition = self._partition()
        return self._partition

    @property
    def device_plan(self) -> DevicePlan:
        if callable(self._device_plan):
            self._device_plan = self._device_plan()
        return self._device_plan

    @property
    def selective(self) -> ExchangePlan:
        if callable(self._selective):
            self._selective = self._selective()
        return self._selective

    @property
    def is_materialized(self) -> bool:
        """False while any planning artifact is still a pending thunk."""
        return not any(
            callable(v)
            for v in (self._matrix, self._partition, self._device_plan, self._selective)
        )

    def materialize(self) -> "SparseSession":
        """Force every deferred planning artifact now (a lazily loaded
        session otherwise pays materialization on first use); returns
        ``self`` for chaining."""
        for name in ("matrix", "partition", "device_plan", "selective"):
            getattr(self, name)
        return self

    # -- execution ---------------------------------------------------------

    def _executor_fn(self, name: str) -> SpmvFn:
        if name not in self._spmv_cache:
            self._spmv_cache[name] = EXECUTORS.get(name)(self)
        return self._spmv_cache[name]

    def spmv(self, x: np.ndarray, *, executor: Optional[str] = None) -> np.ndarray:
        """y = A @ x through the session's (or the named) executor.

        ``x`` may be one vector ``[N]`` (returns ``[N]``) or a batch of
        right-hand sides ``[B, N]`` (returns ``[B, N]``): the batch runs
        as one SpMM.

        The output dtype matches the input's: the contraction runs in
        float32 on every executor, but a float16/float64 ``x`` is cast
        back on the way out. Non-float inputs raise ``TypeError``.
        """
        xa = np.asarray(x)
        if xa.dtype.kind != "f":
            raise TypeError(
                f"spmv needs a float vector, got dtype {xa.dtype} — cast "
                "explicitly (the contraction itself runs in float32)"
            )
        y = self._executor_fn(executor or self.executor)(xa)
        if xa.dtype != np.float32:
            y = np.asarray(y, dtype=xa.dtype)
        return y

    def device_spmm(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """``x -> A @ x`` on tensors on the session's device (``[N]`` or
        ``[B, N]``, same leading shape out), over plan arrays hoisted to
        the device once per session. It honors the session's exchange
        strategy; the ``simulate`` executor and the solvers'
        ``device_loop=True`` path both run through it."""
        if _DEVICE_MV not in self._spmv_cache:
            dp = self.device_plan
            run = make_simulate_fn(
                dp, self.selective, device=self.device, transform=self.tile_transform
            )
            n = dp.shape[0]
            ncb, bn = dp.num_col_blocks, dp.bn

            def mv(x: torch.Tensor) -> torch.Tensor:
                with trace.span("spmv.call"):
                    with trace.span("spmv.pad_x"):
                        xb = pad_x(x, ncb, bn)
                    yb = run(xb)
                    with trace.span("spmv.unblock_y"):
                        return unblock_y(yb, n)

            self._spmv_cache[_DEVICE_MV] = mv
        return self._spmv_cache[_DEVICE_MV]

    def solve(self, solver: str = "power_iteration", **kw) -> SolveResult:
        """Run a registered iterative solver (``iters=``, ``tol=``, ...).

        Solver results expose the iteration count as
        ``SolveResult.iters_run`` (``iters`` is the *budget* argument).
        """
        return SOLVERS.get(solver)(self, **kw)

    def batch_stepper(self, solver: str, slots: int, **config) -> BatchStepper:
        """Instantiate the slot-batched stepper for a registered
        steppable solver (``"pagerank"``, ``"jacobi"``, ``"spmv"``,
        ``"cg"``) — the unit the serving engine schedules. ``config`` is
        the solver's per-lane configuration (e.g. ``damping=`` for
        pagerank); requests sharing a stepper must share it."""
        return STEPPERS.get(solver)(self, slots, **config)

    def solve_batch(
        self,
        solver: str,
        payloads: list,
        *,
        iters: int = 50,
        tol: float = 0.0,
        **config,
    ) -> list:
        """Solve B independent requests through one slot-batched stepper
        — one batched SpMM per iteration for the whole group.

        ``payloads`` is a list of per-request keyword dicts (what
        ``seeds=`` / ``b=`` / ``x=`` would be on a direct solve, with
        1-D ``[N]`` operands). Returns one :class:`SolveResult` per
        payload, each bitwise equal to the matching direct batched-of-1
        ``solve`` call; per-request tol early-stop freezes converged
        slots without stopping the rest.
        """
        stepper = self.batch_stepper(solver, len(payloads), **config)
        nreq = len(payloads)
        for i, payload in enumerate(payloads):
            stepper.load(i, **payload)
        budget = iters if stepper.fixed_iters is None else stepper.fixed_iters
        active = np.ones(nreq, dtype=bool)
        residuals: list = [[] for _ in range(nreq)]
        for _ in range(budget):
            if not active.any():
                break
            res = stepper.step(active)
            for i in np.nonzero(active)[0]:
                residuals[i].append(float(res[i]))
                if tol and res[i] < tol:
                    active[i] = False
        out = []
        for i in range(nreq):
            hist = residuals[i]
            out.append(
                SolveResult(
                    solver=solver,
                    x=stepper.extract(i),
                    value=hist[-1] if hist else 0.0,
                    residuals=hist,
                    iters_run=len(hist),
                    converged=bool(tol and hist and hist[-1] < tol),
                )
            )
        return out

    # -- persistence -------------------------------------------------------

    def save(self, path: str, *, format_version: Optional[int] = None) -> str:
        """Serialize every planning artifact to one ``.npz`` (plus a JSON
        meta entry inside it) — see :mod:`repro_torch.api.plancache`. A session
        loaded back produces bitwise-identical ``spmv`` results on every
        executor. The default (v2) format stores only real, non-padding
        tiles; ``format_version=1`` writes the legacy padded layout for
        fleets mid-migration. Returns the path written."""
        from repro_torch.api.plancache import save_session

        return save_session(self, path, format_version=format_version)

    @classmethod
    def load(
        cls,
        path: str,
        *,
        executor: Optional[str] = None,
        lazy: bool = True,
        device=None,
    ) -> "SparseSession":
        """Rebuild a session saved with :meth:`save`; ``executor``
        overrides the saved default (plans are executor-agnostic).

        The load is lazy by default: only the meta entry is read and
        validated up front; matrix / partition / tile payloads
        materialize from the archive (mmap-backed where possible) when
        first touched — for the serving warm-start that means at the
        first ``spmv``. ``lazy=False`` forces everything immediately
        (:meth:`materialize`). Reads both the current sparse v2 format
        and v1 archives transparently, written by either package.
        ``device`` is where the session computes, as for
        :func:`distribute`."""
        from repro_torch.api.plancache import load_session

        return load_session(path, executor=executor, lazy=lazy, device=device)

    # -- static verification (DESIGN.md §15) -------------------------------

    def verify(self, level: str = "strict", *, raise_on_error: bool = True):
        """Statically prove the session's plan invariants — no spmv runs.

        ``level`` picks the tier (:mod:`repro_torch.analysis`): ``"structure"``
        checks the device/exchange plan arrays' internal consistency
        (delivery exactness, wave partition, padding, workspace
        indices); ``"strict"`` adds the O(nnz) matrix ↔ tiles
        conservation proof; ``"full"`` adds the repack-equivalence proof
        against the recorded partition — the patched-session ≡ replan
        guarantee :meth:`update` relies on.

        Returns the :class:`repro_torch.analysis.LintReport`. With
        ``raise_on_error`` (default) a report with findings raises
        :class:`repro_torch.analysis.PlanLintError` instead of being returned
        silently — ``session.verify()`` either passes or names exactly
        which invariant broke and where.
        """
        from repro_torch.analysis import lint_session

        report = lint_session(self, level=level)
        if raise_on_error:
            report.raise_for_findings()
        return report

    # -- introspection -----------------------------------------------------

    @property
    def combo(self) -> str:
        return self.partition.name

    def costs(self, bytes_per: int = 4, batch: int = 1) -> Dict[str, float]:
        """Partition quality + realized per-phase volumes, one dict: the
        paper's measurement columns (LB, FD, cut, scatter/gather bytes,
        FLOP efficiency). ``batch`` is the SpMM width B. Under an overlap
        exchange the dict also carries the pipelined time model
        (DESIGN.md §9)."""
        out: Dict[str, float] = {
            "lb_nodes": self.partition.lb_nodes,
            "lb_cores": self.partition.lb_cores,
            "lb_tiles": self.device_plan.lb_tiles,
            "inter_fd": float(self.partition.inter_fd),
            "hyper_cut": float(self.partition.hyper_cut),
        }
        out.update(
            phase_costs(
                self.device_plan, self.selective, bytes_per=bytes_per, batch=batch
            )
        )
        return out

    # -- cheap re-configuration (planning artifacts shared) ----------------

    def _derive(self, **changes) -> "SparseSession":
        fields = {  # raw slots: pending thunks stay shared and pending
            "matrix": self._matrix,
            "topology": self.topology,
            "partition": self._partition,
            "device_plan": self._device_plan,
            "exchange": self.exchange,
            "selective": self._selective,
            "executor": self.executor,
            "device": self.device,
            "tile_transform": self.tile_transform,
        }
        fields.update(changes)
        return SparseSession(
            fields.pop("matrix"),
            fields.pop("topology"),
            fields.pop("partition"),
            fields.pop("device_plan"),
            **fields,
        )

    def with_executor(self, executor: str) -> "SparseSession":
        """Same plans *and exchange strategy*, different default executor.

        The derived session shares the closure cache both ways: an
        executor built through either session is visible to the other —
        safe because every closure captures only the shared planning
        artifacts.
        """
        EXECUTORS.get(executor)  # fail fast on unknown names
        sess = self._derive(executor=executor)
        sess._spmv_cache = self._spmv_cache  # share built closures
        return sess

    def with_value_map(self, fn, *, materialize: bool = False) -> "SparseSession":
        """Same *structure* — partition, tile layout, exchange schedule —
        with every stored matrix value transformed elementwise by ``fn``.

        The planning pipeline depends only on the sparsity pattern, so a
        value-only transform never re-plans, and by default it never
        copies the tile payloads either: the derived session is a **value
        view** sharing this session's tile storage, with ``fn`` recorded
        as ``tile_transform`` and applied when the tiles are hoisted to
        the device (:func:`repro_torch.pmvc.dist.hoist_tiles` — known
        ufuncs like ``np.abs`` run as their torch twin after the
        transfer). Only the COO ``val`` array is remapped eagerly.

        ``fn`` must be elementwise with ``fn(0) == 0`` (padding entries
        must stay inert). ``materialize=True`` opts back into eagerly
        rewritten tile copies. Either way the derived session starts with
        a cold closure cache (executors capture tile payloads).
        """
        a = self.matrix
        mat = COO(a.shape, a.row, a.col, np.asarray(fn(a.val), dtype=a.val.dtype))
        base = self.tile_transform  # views compose: fn ∘ base over shared storage
        transform = fn if base is None else (lambda t: fn(base(t)))
        if not materialize:
            return self._derive(matrix=mat, tile_transform=transform)
        dp = dataclasses.replace(
            self.device_plan,
            tiles=np.asarray(transform(self.device_plan.tiles), dtype=np.float32),
        )
        sp = self.selective
        if isinstance(sp, OverlapPlan):
            sp = dataclasses.replace(
                sp,
                local_tiles=np.asarray(transform(sp.local_tiles), dtype=np.float32),
                halo_tiles=np.asarray(transform(sp.halo_tiles), dtype=np.float32),
            )
        return self._derive(
            matrix=mat, device_plan=dp, selective=sp, tile_transform=None
        )

    def with_exchange(self, exchange: str) -> "SparseSession":
        """Same partition/packing, re-planned exchange schedule. The
        closure cache is **not** shared: closures capture the exchange
        plan, so the derived session starts cold."""
        return self._derive(
            exchange=exchange, selective=resolve_exchange(exchange)(self.device_plan)
        )

    # -- streaming updates (DESIGN.md §14) ---------------------------------

    def update(
        self, delta: SparseDelta, *, force: Optional[str] = None
    ) -> "SparseSession":
        """Apply a sparse delta and return a new session for the mutated
        matrix — patched in place when cheap, fully re-planned when not.

        The patch path keeps the existing partition: surviving elements
        keep their unit, inserted elements inherit one deterministically
        (see :func:`_inherit_units`), only the touched tiles are
        re-scattered (:func:`repro_torch.pmvc.plan_device.patch_device_plan`),
        and the exchange plan is rebuilt exactly as a cold
        ``distribute()`` would from the patched packing — so a patched
        session is bitwise-equal to the cold pipeline run on the same
        assignment (and, for value-only deltas, to a cold
        ``distribute()`` of the mutated matrix outright, since the
        partitioners depend only on the sparsity pattern).

        The decision is driven by the §9/§13 phase-cost model: replan if
        the delta touches more than ``PATCH_TOUCH_LIMIT`` of the real
        tiles, or if the patched plan's modeled iteration time drifts
        past ``PATCH_DRIFT_LIMIT`` × the baseline recorded when the
        partition was last computed (the baseline carries across chained
        patches, so slow drift still triggers eventually). Replans run
        ``distribute()`` with a lightened FM budget (``REPLAN_FM_KW``).

        ``force="patch"`` / ``force="replan"`` override the rule. The
        returned session carries an :class:`UpdateReport` as
        ``update_report`` and computes on this session's device; its
        executor closures start cold (a structural patch may change the
        tile capacity ``t``). Value views (``with_value_map``) cannot be
        updated — update the base session and re-derive the view.
        """
        if not isinstance(delta, SparseDelta):
            raise TypeError(
                f"update() takes a SparseDelta, got {type(delta).__name__}"
            )
        if force not in (None, "patch", "replan"):
            raise ValueError(
                f"force must be None, 'patch' or 'replan', got {force!r}"
            )
        if self.tile_transform is not None:
            raise ValueError(
                "update() on a value view (with_value_map) is ambiguous — "
                "update the base session and re-derive the view"
            )
        a = self.matrix
        mutated = delta.apply(a)  # validates; raises on bad deletes
        dp = self.device_plan
        part = self.partition
        bm, bn = dp.bm, dp.bn
        nrb, ncb = dp.num_row_blocks, dp.num_col_blocks
        u_n = self.topology.units
        elem_unit_old = np.asarray(part.elem_unit)

        m64 = np.int64(a.shape[1])
        akey = a.row.astype(np.int64) * m64 + a.col.astype(np.int64)
        aorder = np.argsort(akey)
        akey_s, aunit_s = akey[aorder], elem_unit_old[aorder]

        def unit_of_existing(keys):
            if akey_s.size == 0 or keys.size == 0:
                return np.full(keys.shape, -1, np.int64), np.zeros(keys.shape, bool)
            p = np.minimum(np.searchsorted(akey_s, keys), akey_s.size - 1)
            found = akey_s[p] == keys
            return np.where(found, aunit_s[p], -1), found

        upkey, delkey = delta._keys()
        del_units, _ = unit_of_existing(delkey)  # all exist (apply validated)
        up_units, up_found = unit_of_existing(upkey)
        fresh = ~up_found
        if fresh.any():
            up_units = up_units.copy()
            up_units[fresh] = _inherit_units(
                a,
                elem_unit_old,
                delta.up_row[fresh],
                delta.up_col[fresh],
                ncb=ncb,
                bn=bn,
                num_units=u_n,
            )
        structural = bool(delta.num_deletes) or bool(fresh.any())

        def tile_key(rows, cols, units):
            return (
                units.astype(np.int64) * nrb + (rows // bm).astype(np.int64)
            ) * ncb + (cols // bn).astype(np.int64)

        touched = np.unique(
            np.concatenate(
                [
                    tile_key(delta.del_row, delta.del_col, del_units),
                    tile_key(delta.up_row, delta.up_col, up_units),
                ]
            )
        )
        total = int(dp.real_tiles.sum())
        frac = touched.size / max(total, 1)

        # The mutated matrix's element→unit map: survivors keep their old
        # unit, inserts carry the inherited one.
        munit = np.empty(mutated.nnz, dtype=elem_unit_old.dtype)
        mkey = mutated.row.astype(np.int64) * m64 + mutated.col.astype(np.int64)
        old_u, old_found = unit_of_existing(mkey)
        munit[old_found] = old_u[old_found]
        miss = ~old_found
        if miss.any():
            nk = upkey[fresh]
            norder = np.argsort(nk)
            q = np.searchsorted(nk[norder], mkey[miss])
            munit[miss] = up_units[fresh][norder][q]

        replan_reason = None
        t_patched = t_baseline = None
        dp_new = sp_new = None
        if force == "replan":
            replan_reason = "forced"
        elif force != "patch" and frac > PATCH_TOUCH_LIMIT:
            replan_reason = (
                f"delta touches {touched.size}/{total} tiles "
                f"({frac:.1%} > PATCH_TOUCH_LIMIT {PATCH_TOUCH_LIMIT:.0%})"
            )
        if replan_reason is None:
            dp_new = patch_device_plan(dp, mutated, munit, touched)
            sp_old = self.selective
            if structural:
                # Structure changed: rebuild the exchange plan exactly as a
                # cold distribute() would from the patched packing.
                sp_new = resolve_exchange(self.exchange)(dp_new)
            elif isinstance(sp_old, OverlapPlan):
                # Values only: the selective sub-plan is a pure function of
                # tile structure — share it; rebuild just the value-carrying
                # local/halo payload split.
                sp_new = build_overlap_plan(
                    dp_new, sp_old.selective, waves=sp_old.waves
                )
            else:
                sp_new = sp_old  # replicated / selective: structure-only
            tkey = (
                "t_iter_overlap"
                if isinstance(sp_new, OverlapPlan)
                else "t_iter_blocking"
            )
            t_baseline = getattr(self, "_t_iter_model", None)
            if t_baseline is None:
                t_baseline = phase_costs(dp, sp_old)[tkey]
            t_patched = phase_costs(dp_new, sp_new)[tkey]
            if force != "patch" and t_patched > PATCH_DRIFT_LIMIT * t_baseline:
                replan_reason = (
                    f"modeled t_iter {t_patched:.3e}s drifted past "
                    f"{PATCH_DRIFT_LIMIT}x baseline {t_baseline:.3e}s"
                )
        if replan_reason is not None:
            return self._replan(
                mutated,
                replan_reason,
                structural=structural,
                touched_tiles=int(touched.size),
                total_tiles=total,
                t_patched=t_patched,
                t_baseline=t_baseline,
            )

        part_new = PartitionResult(
            name=part.name, topology=self.topology, elem_unit=munit
        )
        sess = SparseSession(
            mutated,
            self.topology,
            part_new,
            dp_new,
            exchange=self.exchange,
            selective=sp_new,
            executor=self.executor,
            device=self.device,
        )
        sess._t_iter_model = t_baseline  # drift accumulates across patches
        cfg = getattr(self, "_plan_config", None)
        if cfg is not None:
            sess._plan_config = cfg
        sess.update_report = UpdateReport(
            action="patched",
            reason="within patch budget",
            structural=structural,
            touched_tiles=int(touched.size),
            total_tiles=total,
            t_model_patched=t_patched,
            t_model_baseline=t_baseline,
        )
        return sess

    def _replan(
        self,
        mutated: COO,
        reason: str,
        *,
        structural: bool,
        touched_tiles: int,
        total_tiles: int,
        t_patched: Optional[float],
        t_baseline: Optional[float],
    ) -> "SparseSession":
        """Full re-plan of ``mutated`` with a lightened FM budget, reusing
        the planning configuration recorded by :func:`distribute` (falling
        back to parsing the partition name for loaded sessions)."""
        cfg = getattr(self, "_plan_config", None)
        if cfg is None:
            name = self.partition.name
            if ":" in name:
                method, dim = name.split(":", 1)
                cfg = {"combo": method, "seed": 0, "partitioner_kw": {"dim": dim}}
            else:
                cfg = {"combo": name, "seed": 0, "partitioner_kw": {}}
        kw = dict(cfg.get("partitioner_kw") or {})
        light = dict(kw)
        for k, v in REPLAN_FM_KW.items():
            light.setdefault(k, v)
        dp = self.device_plan
        common = {
            "topology": self.topology,
            "combo": cfg["combo"],
            "exchange": self.exchange,
            "executor": self.executor,
            "block": (dp.bm, dp.bn),
            "seed": cfg.get("seed", 0),
            "device": self.device,
        }
        try:
            sess = distribute(mutated, **common, **light)
        except TypeError:
            # Custom partitioner predating the fm_* kwargs: full budget.
            sess = distribute(mutated, **common, **kw)
        tkey = (
            "t_iter_overlap"
            if isinstance(sess.selective, OverlapPlan)
            else "t_iter_blocking"
        )
        sess._t_iter_model = phase_costs(sess.device_plan, sess.selective)[tkey]
        sess.update_report = UpdateReport(
            action="replanned",
            reason=reason,
            structural=structural,
            touched_tiles=touched_tiles,
            total_tiles=total_tiles,
            t_model_patched=t_patched,
            t_model_baseline=t_baseline,
        )
        return sess

    def __repr__(self) -> str:
        # repr must not force a lazily loaded plan's payload from disk.
        combo = "<lazy>" if callable(self._partition) else self.combo
        if callable(self._matrix):
            size = "unmaterialized"
        else:
            size = f"N={self.matrix.shape[0]}, NNZ={self.matrix.nnz}"
        return (
            f"SparseSession({combo} on {self.topology}, {size}, "
            f"exchange={self.exchange!r}, executor={self.executor!r}, "
            f"device={str(self.device)!r})"
        )


def distribute(
    a: COO,
    *,
    topology: Topology,
    combo: str = "NL-HL",
    exchange: str = "selective",
    executor: str = "simulate",
    block: Union[int, Tuple[int, int]] = 16,
    seed: int = 0,
    device=None,
    cache_dir: Optional[str] = None,
    cache_budget_bytes: Optional[int] = None,
    validate: Optional[str] = None,
    **partitioner_kw,
) -> SparseSession:
    """Plan the full paper pipeline for ``a`` and return a session.

    ``combo`` names any registered partitioner — the thesis' four
    two-level combinations (``"NL-HC"`` etc.), a generic ``"XX-YY"``
    [MeH12] combo, or flat ``"nezgt"``/``"hyper"``.

    ``exchange`` picks the x fan-out: ``"replicated"`` (all-gather),
    ``"selective"`` (static all_to_all of the needed blocks),
    ``"overlap"`` (selective + pipelined local/halo contraction;
    DESIGN.md §9) or ``"overlap:K"`` (the halo split into K prioritized
    waves — DESIGN.md §13).

    ``locality_weight`` (a partitioner kwarg, forwarded) biases the
    partition toward keeping tiles on the unit that owns their x
    block-column. Under an overlap exchange it defaults to ``"auto"``:
    the pipeline is planned at each weight in ``LOCALITY_GRID`` and the
    candidate with the smallest modeled ``t_iter_overlap`` wins.
    Non-overlap exchanges default to ``0.0``.

    ``device`` is where the session computes: the card when omitted
    (``RuntimeError`` when there is none — nothing falls back to the
    CPU), or any ``torch.device`` the caller names, such as ``"cpu"``.

    ``cache_dir`` enables the persistent plan cache (DESIGN.md §10–§11):
    plans are keyed on (matrix content hash, topology, combo, block,
    exchange, seed, partitioner kwargs — including the literal
    ``"auto"`` sentinel, so an auto-tuned plan caches without paying the
    grid on hits); a key seen before in this process on this device
    returns a re-wrapped session without re-planning, a key found on
    disk lazily loads ``plan-<key>.npz`` (tile payloads materialize when
    an executor first needs them), and a miss plans then writes the file
    so sibling serving processes warm-start. The key names the same file
    as the JAX package's, so either package finds the other's archives.
    ``cache_budget_bytes`` bounds the directory: after a write, plan
    files are LRU-pruned (least-recently *used*, by access time) until
    the total drops under the budget — see
    :func:`repro_torch.api.plancache.gc`.

    ``validate`` runs the static plan linter on the finished session
    (:meth:`SparseSession.verify`) at the named level (``"structure"``,
    ``"strict"``, ``"full"``) and raises
    :class:`repro_torch.analysis.PlanLintError` on any finding. Not part
    of the cache key: validation is a check, not a planning input.
    """
    dev = resolve_device(device)
    bm, bn = (block, block) if isinstance(block, int) else block
    kw = dict(partitioner_kw)
    lw = kw.pop("locality_weight", None)
    if lw is None:
        lw = "auto" if exchange.split(":", 1)[0] == "overlap" else 0.0
    # The planning configuration, normalized — cached under this key, and
    # recorded on the session so update() can replan with the same recipe.
    cfg_kw = dict(kw)
    if lw == "auto":
        cfg_kw["locality_weight"] = "auto"
    elif float(lw) != 0.0:
        cfg_kw["locality_weight"] = float(lw)
        cfg_kw.setdefault("locality_bn", bn)
    plan_config = {"combo": combo, "seed": seed, "partitioner_kw": cfg_kw}
    if cache_dir is not None:
        from repro_torch.api.plancache import cached_distribute

        sess = cached_distribute(
            a,
            topology=topology,
            combo=combo,
            exchange=exchange,
            executor=executor,
            block=(bm, bn),
            seed=seed,
            cache_dir=cache_dir,
            cache_budget_bytes=cache_budget_bytes,
            partitioner_kw=cfg_kw or None,
            device=dev,
        )
        sess._plan_config = plan_config
        if validate is not None:
            sess.verify(level=validate)
        return sess
    if cache_budget_bytes is not None:
        raise ValueError("cache_budget_bytes requires cache_dir")
    if lw == "auto":
        part, dp, sp = _auto_locality_plan(
            a, topology, combo, exchange, bm, bn, seed, kw
        )
    else:
        if float(lw) != 0.0:
            kw["locality_weight"] = float(lw)
            kw.setdefault("locality_bn", bn)
        part, dp, sp = _plan(a, topology, resolve_partitioner(combo), resolve_exchange(exchange),
                             bm, bn, seed, kw)
    sess = SparseSession(
        a,
        topology,
        part,
        dp,
        exchange=exchange,
        selective=sp,
        executor=executor,
        device=dev,
    )
    sess._plan_config = plan_config
    if validate is not None:
        sess.verify(level=validate)
    return sess


# Candidate locality weights the overlap auto-tuner plans at — 0.0 (the
# pure load/FD objectives) plus a mild and a strong affinity bias. The
# modeled pipelined iteration time arbitrates, so a weight only wins
# when the halo it removes outweighs any load balance it costs.
LOCALITY_GRID = (0.0, 1.0, 4.0)

# The grid's throwaway candidates run at this lightened FM refinement
# budget — a screening pass. Screening costs within SWEEP_TIE_REL of the
# best are treated as a tie broken toward the smaller weight, and only
# the single winning weight is re-planned at the caller's full budget
# (the JAX package pins this against an all-full-budget sweep).
SWEEP_FM_KW = {"fm_passes": 2, "fm_kicks": 1}
SWEEP_TIE_REL = 0.005


def _plan(a, topology, partition, make_exchange, bm, bn, seed, kw):
    """The pipeline's three stages, each in its span: ``partition``,
    then BELL packing, then ``make_exchange``'s schedule."""
    with trace.span("plan.partition"):
        part = partition(a, topology, seed=seed, **kw)
    with trace.span("plan.pack"):
        dp = pack_units(a, part.elem_unit, topology.units, bm, bn)
    with trace.span("plan.exchange"):
        sp = make_exchange(dp)
    return part, dp, sp


def _auto_locality_plan(a, topology, combo, exchange, bm, bn, seed, base_kw):
    """Plan the overlap pipeline at each ``LOCALITY_GRID`` weight and
    keep the candidate whose modeled ``t_iter_overlap`` is smallest
    (ties break toward the smaller weight). Partitioners that predate
    the locality kwargs (custom registrations) fall back to weight 0.0.

    Two-stage budget (see ``SWEEP_FM_KW``): every weight screens at the
    lightened refinement budget, costs within ``SWEEP_TIE_REL`` of the
    screening best count as a tie broken toward the smaller weight, and
    only the winning weight is planned at the full budget. Explicit
    ``fm_*`` kwargs from the caller always win over the lightening
    (``setdefault``)."""
    make_exchange = resolve_exchange(exchange)
    run = resolve_partitioner(combo)

    def plan_at(w, budget_kw):
        kw = dict(base_kw)
        for k, v in budget_kw.items():
            kw.setdefault(k, v)
        if w != 0.0:
            kw["locality_weight"] = w
            kw.setdefault("locality_bn", bn)
        return _plan(a, topology, run, make_exchange, bm, bn, seed, kw)

    screened = []
    for w in LOCALITY_GRID:
        try:
            _, dp, sp = plan_at(w, SWEEP_FM_KW)
        except TypeError:
            # Partitioner predating the fm_* budget kwargs (custom
            # registration): retry unlightened; a second TypeError means
            # the locality kwargs themselves are unsupported.
            try:
                _, dp, sp = plan_at(w, {})
            except TypeError:
                if w == 0.0:
                    raise
                continue
        screened.append((phase_costs(dp, sp)["t_iter_overlap"], w))
    cutoff = min(t for t, _ in screened) * (1.0 + SWEEP_TIE_REL)
    # Grid order is ascending, so the first weight under the cutoff is
    # the smallest tied one.
    w_win = next(w for t, w in screened if t <= cutoff)
    return plan_at(w_win, {})
