"""Iterative-solver drivers over a :class:`SparseSession`.

The port of the JAX package's ``repro/api/solvers.py``: its ``SOLVERS``
and the serving engine's ``STEPPERS``. A solver is a callable
``(session, *, iters, tol, **kw) -> SolveResult`` that only touches A
through the session's SpMM, so every registered solver runs unchanged on
every (partitioner × exchange × executor) cell. A stepper
(:class:`BatchStepper`) is its slot-granularity serving counterpart.

* **Batching** — ``block_power_iteration``, multi-source ``pagerank``
  (``seeds=[B, N]``) and ``jacobi``/``cg`` with ``b=[B, N]`` drive B
  right-hand sides through one SpMM per iteration.
* **Device-resident loops** — ``device_loop=True`` keeps the iterate on
  the session's device between iterations: each iteration is one
  :meth:`SparseSession.device_spmm` call plus tensor arithmetic, and
  the host reads a scalar only where ``tol`` needs it. The JAX package
  runs the same loop under ``lax.while_loop``; ``iters_run``,
  ``converged`` and the residual history follow the same rules. ``cg``
  takes ``device_loop`` too, with the host loop's arithmetic and its
  dot products in float64.

Built-ins: ``"power_iteration"``, ``"block_power_iteration"``,
``"jacobi"``, ``"pagerank"``, ``"cg"``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.api.registry import Registry

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.api.session import SparseSession

__all__ = [
    "SOLVERS",
    "STEPPERS",
    "BatchStepper",
    "SolveResult",
    "register_solver",
    "register_stepper",
]

SOLVERS = Registry("solver")
register_solver = SOLVERS.register

# Batch steppers: the slot-granularity serving counterpart of a solver.
# A registry entry is a factory ``(session, slots, **config) ->
# BatchStepper`` whose step() advances all ``slots`` lanes of one
# ``[slots, N]`` state block by exactly one solver iteration through a
# single SpMM — see :class:`BatchStepper`.
STEPPERS = Registry("stepper")
register_stepper = STEPPERS.register


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Outcome of a solver run.

    ``value`` is the solver's scalar headline (dominant eigenvalue for
    power iteration, final residual norm otherwise); ``residuals`` is
    one entry per iteration; ``iters_run`` is the number of iterations
    actually executed — the ``iters`` *keyword* is only the budget, so
    ``iters_run <= iters`` (strictly less on a ``tol`` early stop) and
    ``converged`` records whether the stop was tol-triggered. Batched
    drivers return ``x`` with shape ``[B, N]`` and reduce the
    per-iteration metric over the batch (max).
    """

    solver: str
    x: np.ndarray
    value: float
    residuals: List[float]
    iters_run: int
    converged: bool


def _link_operator(session: "SparseSession"):
    """``(link, dangling, inv_col)`` for the column-stochastic PageRank
    operator ``P = |A|·D⁻¹`` (+ dangling-mass restart), cached on the
    session: |A| shares the plan's tile storage
    (:meth:`SparseSession.with_value_map`) and the column scan is
    O(nnz), so repeated pagerank solves — and the serving engine's batch
    stepper — pay the tile remap, the column scan and the hoist of |A|'s
    tiles to the device once per session."""
    a = session.matrix
    n = a.shape[1]
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"pagerank needs a square matrix, got {a.shape}")
    cached = getattr(session, "_abs_link", None)
    if cached is None:
        colsum = np.bincount(
            a.col, weights=np.abs(a.val.astype(np.float64)), minlength=n
        )
        dangling = (colsum == 0.0).astype(np.float32)
        inv_col = np.where(
            colsum > 0.0, 1.0 / np.maximum(colsum, 1e-300), 0.0
        ).astype(np.float32)
        cached = (session.with_value_map(np.abs), dangling, inv_col)
        session._abs_link = cached
    return cached


def _diag_of(session: "SparseSession") -> np.ndarray:
    a = session.matrix
    n = min(a.shape)
    d = np.zeros(n, dtype=np.float64)
    on_diag = a.row == a.col
    np.add.at(d, a.row[on_diag], a.val[on_diag].astype(np.float64))
    return d


def _device_solver_loop(
    iterate: Callable, carry0, iters: int, tol: float
) -> Tuple[int, bool, np.ndarray, tuple]:
    """Run ``carry, res = iterate(carry)`` with tol early-stop, the carry
    staying on its device.

    Returns ``(iters_run, converged, residuals[:iters_run], carry)`` —
    the same early-stop semantics as the host loops (stop *after* the
    first iteration whose residual drops below ``tol``; ``tol=0`` runs
    all ``iters`` and never synchronizes with the host inside the loop).
    """
    carry = carry0
    res: List[torch.Tensor] = []
    done = False
    while len(res) < iters and not done:
        carry, r = iterate(carry)
        res.append(r.to(torch.float32))
        if tol > 0.0:
            done = bool(res[-1] < tol)
    hist = torch.stack(res).cpu().numpy() if res else np.zeros(0, np.float32)
    return len(res), done, hist, carry


def _result(
    solver: str,
    x,
    value: float,
    residuals,
    iters_run: int,
    converged: bool,
) -> SolveResult:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return SolveResult(
        solver=solver,
        x=np.asarray(x, np.float32),
        value=float(value),
        residuals=[float(r) for r in residuals],
        iters_run=iters_run,
        converged=converged,
    )


@SOLVERS.register("power_iteration")
def power_iteration(
    session: "SparseSession",
    *,
    iters: int = 50,
    tol: float = 0.0,
    device_loop: bool = False,
) -> SolveResult:
    """x ← Ax / ‖Ax‖; residual per iter = |λ_k − λ_{k−1}|."""
    n = session.matrix.shape[1]
    x0 = np.ones(n, np.float32) / np.sqrt(n)

    if device_loop:
        mv = session.device_spmm()
        dev = session.device

        def iterate(carry):
            x, lam_prev = carry
            y = mv(x)
            lam = torch.linalg.vector_norm(y)
            x = y / torch.clamp(lam, min=1e-30)
            return (x, lam), torch.abs(lam - lam_prev)

        carry0 = (torch.as_tensor(x0, device=dev), torch.zeros((), device=dev))
        k, conv, res, (x, lam) = _device_solver_loop(iterate, carry0, iters, tol)
        return _result("power_iteration", x, float(lam), res, k, conv)

    x = x0
    lam_prev, lam = 0.0, 0.0
    residuals: List[float] = []
    k = 0
    for k in range(1, iters + 1):  # noqa: B007 — k reported after the loop
        y = session.spmv(x)
        lam = float(np.linalg.norm(y))
        x = (y / max(lam, 1e-30)).astype(np.float32)
        residuals.append(abs(lam - lam_prev))
        lam_prev = lam
        if tol and residuals[-1] < tol:
            break
    return _result(
        "power_iteration",
        x,
        lam,
        residuals,
        k,
        bool(tol and residuals and residuals[-1] < tol),
    )


@SOLVERS.register("block_power_iteration")
def block_power_iteration(
    session: "SparseSession",
    *,
    iters: int = 50,
    tol: float = 0.0,
    block: int = 8,
    seed: int = 0,
    device_loop: bool = False,
) -> SolveResult:
    """Subspace iteration on B vectors: X ← qr(A Xᵀ) re-orthonormalized
    every step; one SpMM per iteration drives the whole block.

    Ritz-value estimates are |diag R|; residual per iter is the max
    change over the block; ``value`` is the dominant-eigenvalue
    estimate; ``x`` is the ``[B, N]`` orthonormal basis (rows, each
    defined up to sign). With ``block=1`` this reduces exactly to
    ``power_iteration`` (same init, λ = ‖Ax‖).
    """
    n = session.matrix.shape[1]
    b = int(block)
    if not 1 <= b <= n:
        raise ValueError(f"block must be in [1, N={n}], got {b}")
    x0 = np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)
    x0[0] = 1.0 / np.sqrt(n)  # block=1 ≡ power_iteration's init
    q0, _ = np.linalg.qr(x0.T)  # orthonormal start
    x0 = np.ascontiguousarray(q0.T, dtype=np.float32)

    if device_loop:
        mv = session.device_spmm()
        dev = session.device

        def iterate(carry):
            x, lam_prev = carry
            q, r = torch.linalg.qr(mv(x).T)
            lam = torch.abs(torch.diagonal(r))
            return (q.T.contiguous(), lam), torch.max(torch.abs(lam - lam_prev))

        carry0 = (torch.as_tensor(x0, device=dev), torch.zeros((b,), device=dev))
        k, conv, res, (x, lam) = _device_solver_loop(iterate, carry0, iters, tol)
        return _result(
            "block_power_iteration", x, float(lam.max()), res, k, conv
        )

    x = x0
    lam_prev = np.zeros(b)
    lam = lam_prev
    residuals: List[float] = []
    k = 0
    for k in range(1, iters + 1):  # noqa: B007 — k reported after the loop
        y = session.spmv(x)  # [B, N] — one SpMM for the whole block
        q, r = np.linalg.qr(y.T)
        lam = np.abs(np.diagonal(r))
        x = np.ascontiguousarray(q.T, dtype=np.float32)
        residuals.append(float(np.max(np.abs(lam - lam_prev))))
        lam_prev = lam
        if tol and residuals[-1] < tol:
            break
    return _result(
        "block_power_iteration",
        x,
        float(np.max(lam)),
        residuals,
        k,
        bool(tol and residuals and residuals[-1] < tol),
    )


@SOLVERS.register("jacobi")
def jacobi(
    session: "SparseSession",
    *,
    iters: int = 50,
    tol: float = 0.0,
    b: Optional[np.ndarray] = None,
    device_loop: bool = False,
) -> SolveResult:
    """Solve A z = b with z ← z + D⁻¹(b − Az); residual = ‖b − Az‖₂.

    ``b`` may be one right-hand side ``[N]`` or a batch ``[B, N]`` — the
    batch is swept by one SpMM per iteration and the residual is the max
    2-norm over the batch.
    """
    n = session.matrix.shape[0]
    d = _diag_of(session)
    if np.any(d == 0.0):
        raise ValueError("jacobi needs a zero-free diagonal")
    bv = np.ones(n, np.float32) if b is None else np.asarray(b, np.float32)
    batched = bv.ndim == 2

    if device_loop:
        mv = session.device_spmm()
        bd = torch.as_tensor(bv, device=session.device)
        dd = torch.as_tensor(d.astype(np.float32), device=session.device)

        def iterate(carry):
            z, r = carry  # r = b − Az carried forward: one SpMM per iter
            z = z + r / dd
            r = bd - mv(z)
            rn = torch.linalg.vector_norm(r, dim=-1)
            return (z, r), (torch.max(rn) if batched else rn)

        z0 = torch.zeros_like(bd)
        k, conv, res, (z, _) = _device_solver_loop(
            iterate, (z0, bd - mv(z0)), iters, tol
        )
        return _result("jacobi", z, res[-1] if len(res) else 0.0, res, k, conv)

    z = np.zeros_like(bv)
    r = bv - session.spmv(z)
    residuals: List[float] = []
    k = 0
    for k in range(1, iters + 1):  # noqa: B007 — k reported after the loop
        z = (z + r / d).astype(np.float32)
        r = bv - session.spmv(z)
        rn = np.linalg.norm(r, axis=-1)
        residuals.append(float(rn.max() if batched else rn))
        if tol and residuals[-1] < tol:
            break
    return _result(
        "jacobi",
        z,
        residuals[-1] if residuals else 0.0,
        residuals,
        k,
        bool(tol and residuals and residuals[-1] < tol),
    )


@SOLVERS.register("pagerank")
def pagerank(
    session: "SparseSession",
    *,
    iters: int = 50,
    tol: float = 0.0,
    damping: float = 0.85,
    seeds: Optional[np.ndarray] = None,
    normalize: str = "auto",
    device_loop: bool = False,
) -> SolveResult:
    """r ← d·Pr + (1−d)·s; residual = ‖r_k − r_{k−1}‖₁.

    ``normalize="auto"`` (the default) builds the column-stochastic
    link matrix ``P = |A|·D⁻¹`` with ``D = diag(Σᵢ |Aᵢⱼ|)`` through the
    value view ``|A|`` (:meth:`SparseSession.with_value_map`, nothing
    re-plans), and restarts *dangling* columns at the teleport
    distribution, so the result is a probability vector on any input
    matrix. ``normalize="none"`` applies A as-is with only an L1
    renormalization per step.

    ``seeds=None`` is classic PageRank (uniform teleport s = 1/n);
    ``seeds=[B, N]`` is multi-source personalized PageRank, all B walks
    advanced by a single SpMM per iteration; the residual is then the
    max 1-norm change over the batch.
    """
    if normalize not in ("auto", "none"):
        raise ValueError(f"normalize must be 'auto' or 'none', got {normalize!r}")
    n = session.matrix.shape[1]
    if seeds is None:
        s = np.full(n, 1.0 / n, np.float32)
    else:
        s = np.asarray(seeds, np.float32)
        mass = np.abs(s).sum(axis=-1, keepdims=True)
        if np.any(mass == 0.0):
            raise ValueError("each seed row needs non-zero mass")
        s = s / mass  # teleport distributions: rows sum to 1
    batched = s.ndim == 2
    r0 = s.copy()

    if normalize == "auto":
        link, dangling, inv_col = _link_operator(session)
    else:
        dangling = inv_col = None
        link = session

    if device_loop:
        mv = link.device_spmm()
        dev = session.device
        sd = torch.as_tensor(s, device=dev)
        if normalize == "auto":
            inv_d = torch.as_tensor(inv_col, device=dev)
            dang_d = torch.as_tensor(dangling, device=dev)

            def pr_step(r):
                dmass = torch.sum(r * dang_d, dim=-1, keepdim=True)
                return mv(r * inv_d) + dmass * sd

        else:
            pr_step = mv

        def iterate(carry):
            (r,) = carry
            r_new = damping * pr_step(r) + (1.0 - damping) * sd
            norm = torch.sum(torch.abs(r_new), dim=-1, keepdim=True)
            r_new = r_new / torch.clamp(norm, min=1e-30)
            diff = torch.sum(torch.abs(r_new - r), dim=-1)
            return (r_new,), (torch.max(diff) if batched else diff)

        k, conv, res, (r,) = _device_solver_loop(
            iterate, (torch.as_tensor(r0, device=dev),), iters, tol
        )
        return _result("pagerank", r, res[-1] if len(res) else 0.0, res, k, conv)

    if normalize == "auto":

        def pr_step(r):
            dmass = (r * dangling).sum(axis=-1, keepdims=True)
            return link.spmv(r * inv_col) + dmass * s

    else:
        pr_step = link.spmv

    r = r0
    residuals: List[float] = []
    k = 0
    for k in range(1, iters + 1):  # noqa: B007 — k reported after the loop
        r_new = damping * pr_step(r) + (1.0 - damping) * s
        norm = np.abs(r_new).sum(axis=-1, keepdims=True)
        r_new = (r_new / np.maximum(norm, 1e-30)).astype(np.float32)
        diff = np.abs(r_new - r).sum(axis=-1)
        residuals.append(float(diff.max() if batched else diff))
        r = r_new
        if tol and residuals[-1] < tol:
            break
    return _result(
        "pagerank",
        r,
        residuals[-1] if residuals else 0.0,
        residuals,
        k,
        bool(tol and residuals and residuals[-1] < tol),
    )


def _row_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row dot product of two ``[B, N]`` blocks, accumulated in
    float64 — a pure ``axis=-1`` reduction, so each row's value is
    independent of every other row and of the batch width B. This is
    what lets CG's two dots per iteration ride the slot-batched serving
    path with the bitwise engine-vs-direct guarantee."""
    return (a.astype(np.float64) * b.astype(np.float64)).sum(axis=-1)


def _cg_advance(session, z, r, p, rs):
    """One batched CG iteration over ``[B, N]`` state; per-row
    arithmetic only (batched SpMM + ``axis=-1`` dots + row selects).

    Breakdown (``|pᵀAp| < 1e-30``) freezes that row — state and residual
    stay constant while the budget runs out — and leaves the other rows
    unaffected. Returns ``(z, r, p, rs, resid)`` with ``resid = √rs``
    per row (float64)."""
    ap = session.spmv(p)
    denom = _row_dot(p, ap)
    ok = np.abs(denom) >= 1e-30
    alpha = np.where(ok, rs / np.where(ok, denom, 1.0), 0.0)
    z_new = (z + alpha[:, None] * p).astype(np.float32)
    r_new = (r - alpha[:, None] * ap).astype(np.float32)
    rs_new = _row_dot(r_new, r_new)
    beta = rs_new / np.maximum(rs, 1e-30)
    p_new = (r_new + beta[:, None] * p).astype(np.float32)
    sel = ok[:, None]
    z = np.where(sel, z_new, z)
    r = np.where(sel, r_new, r)
    p = np.where(sel, p_new, p)
    rs = np.where(ok, rs_new, rs)
    return z, r, p, rs, np.sqrt(rs)


def _cg_batched(session, bv, iters, tol) -> SolveResult:
    """Batched CG over ``b=[B, N]`` — shares :func:`_cg_advance` with
    the serving stepper verbatim, so a direct batched solve and an
    engine slot produce bitwise-identical trajectories. One residual
    entry per iteration (max 2-norm over the batch; no initial-residual
    entry)."""
    z = np.zeros_like(bv)
    r = bv - session.spmv(z)
    p = r.copy()
    rs = _row_dot(r, r)
    residuals: List[float] = []
    k = 0
    for k in range(1, iters + 1):  # noqa: B007 — k reported after the loop
        z, r, p, rs, resid = _cg_advance(session, z, r, p, rs)
        residuals.append(float(resid.max()))
        if tol and residuals[-1] < tol:
            break
    return _result(
        "cg",
        z,
        residuals[-1] if residuals else 0.0,
        residuals,
        k,
        bool(tol and residuals and residuals[-1] < tol),
    )


def _cg_device(session, bv, iters, tol) -> SolveResult:
    """CG with the iterate on the session's device: the host loops'
    bookkeeping (``b=[N]`` logs the initial residual and stops on
    breakdown; ``b=[B, N]`` freezes a broken-down row), float32 vectors
    and float64 dot products. The breakdown test reads ``pᵀAp`` on the
    host once per iteration. Traced as ``solve.cg``, each iteration as
    ``cg.iter`` (:mod:`repro_torch.trace`)."""
    with trace.span("solve.cg"):
        mv = session.device_spmm()
        b = torch.as_tensor(bv, device=session.device)
        batched = b.dim() == 2

        def dot(u, v):
            return (u.double() * v.double()).sum(dim=-1)

        z = torch.zeros_like(b)
        r = b - mv(z)
        p = r.clone()
        rs = dot(r, r)
        residuals: List[torch.Tensor] = [] if batched else [rs.sqrt()]
        k = 0
        for k in range(1, iters + 1):  # noqa: B007 — k reported after the loop
            with trace.span("cg.iter"):
                ap = mv(p)
                denom = dot(p, ap)
                ok = denom.abs() >= 1e-30
                if not batched and not bool(ok):
                    break
                alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
                z_new = (z + alpha[..., None] * p).float()
                r_new = (r - alpha[..., None] * ap).float()
                rs_new = dot(r_new, r_new)
                p_new = (r_new + (rs_new / torch.clamp(rs, min=1e-30))[..., None] * p).float()
                sel = ok[..., None]
                z = torch.where(sel, z_new, z)
                r = torch.where(sel, r_new, r)
                p = torch.where(sel, p_new, p)
                rs = torch.where(ok, rs_new, rs)
                residuals.append(rs.sqrt().max())
            if tol and float(residuals[-1]) < tol:
                break
        hist = torch.stack(residuals).cpu().numpy() if residuals else np.zeros(0)
        conv = bool(tol and len(hist) and hist[-1] < tol)
        return _result("cg", z, hist[-1] if len(hist) else 0.0, hist, k, conv)


@SOLVERS.register("cg")
def conjugate_gradient(
    session: "SparseSession",
    *,
    iters: int = 50,
    tol: float = 0.0,
    b: Optional[np.ndarray] = None,
    device_loop: bool = False,
) -> SolveResult:
    """Conjugate gradient for SPD A; residual = ‖b − Az‖₂.

    ``b=[N]`` is the single-vector driver: it logs the initial residual
    before iterating and stops without ``converged`` on the breakdown
    branch (search-direction curvature ``pᵀAp ≈ 0``). ``b=[B, N]``
    sweeps the batch with one SpMM and two ``axis=-1`` dots per
    iteration (:func:`_cg_advance`); breakdown there freezes only the
    affected row. ``device_loop=True`` runs either on the device
    (:func:`_cg_device`).
    """
    n = session.matrix.shape[0]
    bv = np.ones(n, np.float32) if b is None else np.asarray(b, np.float32)
    if device_loop:
        return _cg_device(session, bv, iters, tol)
    if bv.ndim == 2:
        return _cg_batched(session, bv, iters, tol)
    z = np.zeros(n, np.float32)
    r = bv - session.spmv(z)
    p = r.copy()
    rs = float(r @ r)
    residuals: List[float] = [float(np.sqrt(rs))]
    k = 0
    for k in range(1, iters + 1):  # noqa: B007 — k reported after the loop
        ap = session.spmv(p)
        denom = float(p @ ap)
        if abs(denom) < 1e-30:
            break
        alpha = rs / denom
        z = (z + alpha * p).astype(np.float32)
        r = (r - alpha * ap).astype(np.float32)
        rs_new = float(r @ r)
        residuals.append(float(np.sqrt(rs_new)))
        if tol and residuals[-1] < tol:
            break
        p = (r + (rs_new / max(rs, 1e-30)) * p).astype(np.float32)
        rs = rs_new
    return _result(
        "cg",
        z,
        residuals[-1],
        residuals,
        k,
        bool(tol and residuals[-1] < tol),
    )


# ---------------------------------------------------------------------------
# Batch steppers — the slot-granularity serving counterpart of a solver


class BatchStepper:
    """One solver iterating B independent requests through shared SpMMs.

    A stepper owns a fixed ``[slots, N]`` state block. ``load`` writes
    one request's payload into a slot; ``step(active)`` advances every
    slot by exactly one solver iteration with a *single* batched SpMM,
    using ``np.where(active[:, None], new, old)`` selects so inactive
    slots keep their state **bitwise** frozen; ``extract(slot)`` reads a
    finished slot's solution row.

    The contract that makes serving results trustworthy: the arithmetic
    of one slot must be *independent of every other slot* — only
    per-row ops (the batched SpMM is per-column bitwise stable across
    batch widths on the simulate executor: one FMA chain per output in
    the kernel, exact gathers, a unit sum whose order does not depend on
    B; reductions are ``axis=-1``) — so a slot's trajectory is bitwise
    equal to a direct batched-of-1 ``session.solve`` with the same
    payload, whatever else shares the batch and whenever slots join or
    leave. Solvers whose iterations couple rows (block power iteration's
    QR re-orthonormalization, power iteration's global norm) cannot be
    slot-batched and have no stepper entry.

    The state stays numpy on the host, as in the JAX package, whatever
    the session's device: only the SpMM runs there.

    ``fixed_iters`` (class attribute) caps the per-request iteration
    budget when a "solver" completes in a known number of steps (the
    ``spmv`` stepper: 1); ``None`` means the caller's budget applies.
    """

    solver: str = "?"
    fixed_iters: Optional[int] = None

    def __init__(self, session: "SparseSession", slots: int):
        if slots < 1:
            raise ValueError(f"need at least 1 slot, got {slots}")
        self.session = session
        self.slots = int(slots)
        self.n = session.matrix.shape[1]

    def load(self, slot: int, **payload) -> None:
        raise NotImplementedError

    def step(self, active: np.ndarray) -> np.ndarray:
        """Advance one iteration; returns per-slot residuals ``[B]``
        (inactive slots' entries are meaningless)."""
        raise NotImplementedError

    def extract(self, slot: int) -> np.ndarray:
        raise NotImplementedError

    # -- state capture ------------------------------------------------------
    # Stepper state is numpy by contract (the np.where freezing that makes
    # slot trajectories bitwise-stable), so the mutable per-slot state is
    # exactly the set of ndarray attributes. Capturing them generically
    # means every registered stepper — including user registrations — is
    # snapshot/restorable without opting in, and the attribute names are
    # the JAX package's, so a snapshot of either package's stepper
    # restores into the other's.

    def snapshot(self) -> dict:
        """Deep copy of every ndarray attribute — the per-slot solver
        state. Restoring it onto a fresh stepper built for the same
        (session, slots, config) resumes the iteration bitwise."""
        return {
            k: v.copy() for k, v in vars(self).items() if isinstance(v, np.ndarray)
        }

    def restore(self, state: dict) -> None:
        """Install a :meth:`snapshot` (copied — the snapshot stays valid)."""
        for k, v in state.items():
            setattr(self, k, v.copy())


class _PagerankStepper(BatchStepper):
    """Slot-batched personalized PageRank — the multi-user serving path.

    Each slot's row follows exactly the host loop of
    :func:`pagerank`: teleport-normalized seed, damping step, L1
    renormalization, L1-diff residual. All ops are per-row, so slot
    trajectories match direct batched-of-1 solves bitwise.
    """

    solver = "pagerank"

    def __init__(self, session, slots, *, damping=0.85, normalize="auto"):
        super().__init__(session, slots)
        if normalize not in ("auto", "none"):
            raise ValueError(f"normalize must be 'auto' or 'none', got {normalize!r}")
        self.damping = float(damping)
        self.normalize = normalize
        if normalize == "auto":
            self._link, self._dangling, self._inv_col = _link_operator(session)
        else:
            self._link, self._dangling, self._inv_col = session, None, None
        self.r = np.zeros((self.slots, self.n), np.float32)
        self.s = np.zeros((self.slots, self.n), np.float32)

    def load(self, slot, *, seeds=None):
        if seeds is None:
            s = np.full(self.n, 1.0 / self.n, np.float32)
        else:
            s = np.asarray(seeds, np.float32)
            if s.shape != (self.n,):
                raise ValueError(f"seeds must be [N={self.n}], got {s.shape}")
            mass = np.abs(s).sum(axis=-1, keepdims=True)
            if np.any(mass == 0.0):
                raise ValueError("each seed row needs non-zero mass")
            s = s / mass
        self.s[slot] = s
        self.r[slot] = s

    def step(self, active):
        r = self.r
        if self.normalize == "auto":
            dmass = (r * self._dangling).sum(axis=-1, keepdims=True)
            y = self._link.spmv(r * self._inv_col) + dmass * self.s
        else:
            y = self._link.spmv(r)
        r_new = self.damping * y + (1.0 - self.damping) * self.s
        norm = np.abs(r_new).sum(axis=-1, keepdims=True)
        r_new = (r_new / np.maximum(norm, 1e-30)).astype(np.float32)
        diff = np.abs(r_new - r).sum(axis=-1)
        self.r = np.where(active[:, None], r_new, r)
        return diff

    def extract(self, slot):
        return self.r[slot].copy()


class _JacobiStepper(BatchStepper):
    """Slot-batched Jacobi sweeps: z ← z + D⁻¹(b − Az) per row.

    ``r0 = b − A·0`` is seeded from one zero-batch SpMV computed at
    construction (per-column stability makes it the same column every
    direct solve's first SpMM produces), so a slot loaded mid-stream
    starts exactly where a fresh direct solve would.
    """

    solver = "jacobi"

    def __init__(self, session, slots):
        super().__init__(session, slots)
        self.d = _diag_of(session)
        if np.any(self.d == 0.0):
            raise ValueError("jacobi needs a zero-free diagonal")
        self.z = np.zeros((self.slots, self.n), np.float32)
        self.r = np.zeros((self.slots, self.n), np.float32)
        self.b = np.zeros((self.slots, self.n), np.float32)
        self._zero_y = session.spmv(np.zeros((1, self.n), np.float32))[0]

    def load(self, slot, *, b=None):
        bv = np.ones(self.n, np.float32) if b is None else np.asarray(b, np.float32)
        if bv.shape != (self.n,):
            raise ValueError(f"b must be [N={self.n}], got {bv.shape}")
        self.b[slot] = bv
        self.z[slot] = 0.0
        self.r[slot] = bv - self._zero_y

    def step(self, active):
        z_new = (self.z + self.r / self.d).astype(np.float32)
        r_new = self.b - self.session.spmv(z_new)
        rn = np.linalg.norm(r_new, axis=-1)
        sel = active[:, None]
        self.z = np.where(sel, z_new, self.z)
        self.r = np.where(sel, r_new, self.r)
        return rn

    def extract(self, slot):
        return self.z[slot].copy()


class _SpmvStepper(BatchStepper):
    """One-shot y = A @ x as a degenerate stepper, so raw PMVC requests
    ride the same batched serving path as the iterative solvers."""

    solver = "spmv"
    fixed_iters = 1

    def __init__(self, session, slots):
        super().__init__(session, slots)
        self.x = np.zeros((self.slots, self.n), np.float32)
        self.y = np.zeros((self.slots, self.n), np.float32)

    def load(self, slot, *, x):
        xv = np.asarray(x, np.float32)
        if xv.shape != (self.n,):
            raise ValueError(f"x must be [N={self.n}], got {xv.shape}")
        self.x[slot] = xv

    def step(self, active):
        y = self.session.spmv(self.x)
        self.y = np.where(active[:, None], y, self.y)
        return np.zeros(self.slots, np.float32)

    def extract(self, slot):
        return self.y[slot].copy()


class _CgStepper(BatchStepper):
    """Slot-batched conjugate gradient: one shared SpMM (A·P) plus two
    ``axis=-1`` dot reductions per iteration drive B independent SPD
    solves.

    Each slot advances through :func:`_cg_advance` — literally the
    function the batched host driver loops, with its float64 host dots
    (:func:`_row_dot`), never the device loop of :func:`_cg_device` — so
    a slot's (z, r, p, rs) trajectory is bitwise a direct batched-of-1
    ``solve("cg", b=b[None])``. The per-row float64 ``rs`` rides the
    generic ndarray snapshot/restore like every other state block. A
    slot that breaks down (``pᵀAp ≈ 0``) freezes at its solution and
    burns its budget, same as the host batch.
    """

    solver = "cg"

    def __init__(self, session, slots):
        super().__init__(session, slots)
        self.z = np.zeros((self.slots, self.n), np.float32)
        self.r = np.zeros((self.slots, self.n), np.float32)
        self.p = np.zeros((self.slots, self.n), np.float32)
        self.rs = np.zeros(self.slots, np.float64)
        self._zero_y = session.spmv(np.zeros((1, self.n), np.float32))[0]

    def load(self, slot, *, b=None):
        bv = np.ones(self.n, np.float32) if b is None else np.asarray(b, np.float32)
        if bv.shape != (self.n,):
            raise ValueError(f"b must be [N={self.n}], got {bv.shape}")
        r0 = bv - self._zero_y
        self.z[slot] = 0.0
        self.r[slot] = r0
        self.p[slot] = r0
        self.rs[slot] = _row_dot(r0[None, :], r0[None, :])[0]

    def step(self, active):
        z, r, p, rs, resid = _cg_advance(
            self.session, self.z, self.r, self.p, self.rs
        )
        sel = active[:, None]
        self.z = np.where(sel, z, self.z)
        self.r = np.where(sel, r, self.r)
        self.p = np.where(sel, p, self.p)
        self.rs = np.where(active, rs, self.rs)
        return resid

    def extract(self, slot):
        return self.z[slot].copy()


@register_stepper("pagerank")
def pagerank_stepper(
    session: "SparseSession", slots: int, *, damping: float = 0.85,
    normalize: str = "auto",
) -> BatchStepper:
    return _PagerankStepper(session, slots, damping=damping, normalize=normalize)


@register_stepper("jacobi")
def jacobi_stepper(session: "SparseSession", slots: int) -> BatchStepper:
    return _JacobiStepper(session, slots)


@register_stepper("spmv")
def spmv_stepper(session: "SparseSession", slots: int) -> BatchStepper:
    return _SpmvStepper(session, slots)


@register_stepper("cg")
def cg_stepper(session: "SparseSession", slots: int) -> BatchStepper:
    return _CgStepper(session, slots)
