"""The :class:`SparseSession` façade and :func:`distribute` entry point.

The port of the JAX package's ``repro/api/session.py``. One call chains
the whole paper pipeline — two-level partition, per-unit BELL packing,
exchange planning — and hands back a session whose ``spmv`` / ``solve``
/ ``costs`` methods run it under any registered executor, on the
session's device (the card unless the caller asks for the CPU).

The serving engine's unit, :meth:`SparseSession.batch_stepper`, and
:meth:`SparseSession.solve_batch` are here too. Not ported yet (listed
in ROADMAP.md): the plan cache (``cache_dir``, ``save`` / ``load``),
``update``, ``verify`` / ``validate=``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
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
    pack_units,
)
from repro_torch.sparse.formats import COO

__all__ = ["SparseSession", "distribute"]

# Key of the session's device SpMM closure in the shared closure cache;
# not a string, so it never collides with an executor name.
_DEVICE_MV = ("device_spmm",)


class SparseSession:
    """A distributed sparse matrix, planned once and executable anywhere.

    Holds the immutable products of the planning pipeline (partition,
    packed device plan, exchange schedule), the device it computes on,
    and per-executor state built lazily and cached. Construct via
    :func:`distribute` (or :func:`repro_torch.api.interop.session_from_numpy`).

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
        self.matrix = matrix
        self.topology = topology
        self.partition = partition
        self.device_plan = device_plan
        self.exchange = exchange
        self.selective = selective
        self.executor = executor
        self.device = torch.device(device)
        self.tile_transform = tile_transform
        self._spmv_cache: Dict[object, Callable] = {}

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
                return unblock_y(run(pad_x(x, ncb, bn)), n)

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
        fields = {
            "matrix": self.matrix,
            "topology": self.topology,
            "partition": self.partition,
            "device_plan": self.device_plan,
            "exchange": self.exchange,
            "selective": self.selective,
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

    def __repr__(self) -> str:
        return (
            f"SparseSession({self.combo} on {self.topology}, "
            f"N={self.matrix.shape[0]}, NNZ={self.matrix.nnz}, "
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

    ``cache_dir`` (the plan cache) and ``validate`` (the static plan
    linter) are not ported yet and raise ``NotImplementedError``.
    """
    dev = resolve_device(device)
    if cache_dir is not None:
        raise NotImplementedError(
            "cache_dir: the plan cache (repro/api/plancache.py) is not ported "
            "yet; see ROADMAP.md, Queue 1, item 3"
        )
    if validate is not None:
        raise NotImplementedError(
            "validate: the static plan linter (SparseSession.verify) is not "
            "ported yet; see ROADMAP.md, Queue 1, item 5"
        )
    if cache_budget_bytes is not None:
        raise ValueError("cache_budget_bytes requires cache_dir")
    bm, bn = (block, block) if isinstance(block, int) else block
    kw = dict(partitioner_kw)
    lw = kw.pop("locality_weight", None)
    if lw is None:
        lw = "auto" if exchange.split(":", 1)[0] == "overlap" else 0.0
    if lw == "auto":
        part, dp, sp = _auto_locality_plan(
            a, topology, combo, exchange, bm, bn, seed, kw
        )
    else:
        if float(lw) != 0.0:
            kw["locality_weight"] = float(lw)
            kw.setdefault("locality_bn", bn)
        part = resolve_partitioner(combo)(a, topology, seed=seed, **kw)
        dp = pack_units(a, part.elem_unit, topology.units, bm, bn)
        sp = resolve_exchange(exchange)(dp)
    return SparseSession(
        a,
        topology,
        part,
        dp,
        exchange=exchange,
        selective=sp,
        executor=executor,
        device=dev,
    )


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
        part = run(a, topology, seed=seed, **kw)
        dp = pack_units(a, part.elem_unit, topology.units, bm, bn)
        sp = make_exchange(dp)
        return part, dp, sp

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
