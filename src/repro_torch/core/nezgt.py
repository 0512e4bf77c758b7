"""NEZGT — « Nombre Équilibré de nonZéros, Généralisé, Trié ».

The paper's load-balancing heuristic (ch.3 §4.2.1 for the row variant,
ch.4 §2 for the thesis' column variant). Three phases:

* **Phase 0** — sort lines (rows or columns) by non-zero count, descending
  (LPT order; ascending gives SPT).
* **Phase 1** — list scheduling (LS): lines ``i = 1..f`` seed fragments
  ``1..f``; every subsequent line goes to the currently least-loaded
  fragment.
* **Phase 2** — iterative improvement of the **FD** criterion (difference
  between the two extreme fragment loads): between the most-loaded
  fragment ``fcmx`` and least-loaded ``fcmn``, either *transfer* a line
  with ``nzx < Diff`` or *exchange* a pair with ``nzx - nzn < Diff``,
  choosing the move that minimizes ``|Diff/2 - nzx|`` (transfer) or
  ``|Diff/2 - (nzx - nzn)|`` (exchange). Iterate while FD decreases, up
  to ``max_iters``.
* **Phase 3** (opt-in, ``affinity``/``locality_weight``) — load-preserving
  locality: within each weight class the multiset of fragment capacities
  is fixed (so loads — hence FD — stay bit-identical), but the
  line→fragment matching inside the class is re-solved greedily to
  maximize total own-block affinity. With ``locality_weight > 0`` the
  phase-2 move scores also gain ``-w·Δaffinity`` so refinement prefers
  FD moves that also improve locality.

The heuristic is weight-agnostic: the same code balances scalar non-zeros
(the paper's setting), non-empty MXU tiles (our TPU adaptation), or MoE
expert loads (``repro_torch.core.expert_placement``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List

import numpy as np

__all__ = ["NezgtResult", "nezgt_partition", "fragment_loads", "fd_criterion"]


@dataclasses.dataclass(frozen=True)
class NezgtResult:
    """Outcome of a NEZGT partition of ``len(assignment)`` lines into ``f``
    fragments."""

    assignment: np.ndarray  # int32 [n_lines] -> fragment id in [0, f)
    loads: np.ndarray  # int64 [f] total weight per fragment
    fd_phase1: int  # FD after list scheduling
    fd_final: int  # FD after refinement
    iters: int  # refinement iterations actually performed

    @property
    def f(self) -> int:
        return int(self.loads.shape[0])

    @property
    def lb(self) -> float:
        """Load-balance ratio max/avg — the paper's LB metric."""
        avg = self.loads.mean()
        return float(self.loads.max() / avg) if avg > 0 else 1.0


def fragment_loads(weights: np.ndarray, assignment: np.ndarray, f: int) -> np.ndarray:
    return np.bincount(assignment, weights=weights, minlength=f).astype(np.int64)


def fd_criterion(loads: np.ndarray) -> int:
    return int(loads.max() - loads.min())


def _phase01(weights: np.ndarray, f: int, descending: bool) -> np.ndarray:
    """Phases 0+1: sort then list-schedule. Returns assignment."""
    order = np.argsort(weights, kind="stable")
    if descending:
        order = order[::-1]
    assignment = np.empty(weights.shape[0], dtype=np.int32)
    # Seed: line i -> fragment i for the first f lines, then least-loaded.
    # (Seeding and the generic rule coincide when loads start at zero and
    # ties break on the lowest fragment id, matching the paper's example.)
    # A (load, fragment) heap pops exactly argmin-with-lowest-id — the
    # same fragment np.argmin would pick — in O(n log f) instead of the
    # O(n·f) per-line argmin scan.
    heap = [(0, frag) for frag in range(f)]
    w = weights.tolist()
    for line in order.tolist():
        load, frag = heap[0]
        assignment[line] = frag
        heapq.heapreplace(heap, (load + w[line], frag))
    return assignment


def _phase2(
    weights: np.ndarray,
    assignment: np.ndarray,
    f: int,
    max_iters: int,
    affinity: np.ndarray | None = None,
    locality_weight: float = 0.0,
) -> int:
    """In-place FD refinement. Returns iteration count.

    Each refinement step evaluates *every* candidate transfer and
    exchange between ``fcmx`` and ``fcmn`` in one vectorized pass:

    * transfer — ``|Diff/2 − nzx|`` over all lines of ``fcmx`` at once;
    * exchange — the score ``|Diff/2 − (nzx − nzn)|`` equals
      ``|nzn − (nzx − Diff/2)|`` and the validity window
      ``0 < nzx − nzn < Diff`` is the interval ``(nzx − Diff, nzx)``
      *centered on that same target*, so for each ``lx`` the best
      partner is one of the two ``searchsorted`` neighbours of
      ``nzx − Diff/2`` in the sorted ``fcmn`` weights — any farther
      element is both farther from the target and no more likely to be
      valid.

    This replaces the per-line Python loops (O(|fcmx|·|fcmn|) with a
    numpy call per line) by O((|fcmx| + |fcmn|) log |fcmn|) per step.

    With ``affinity``/``locality_weight`` set, every candidate score gains
    ``-locality_weight · Δaffinity`` (affinity gained by the move), so ties
    and near-ties in the FD window resolve toward moves that also place
    lines on the fragment owning their x blocks. The loop's termination
    rule — stop when FD stops decreasing — is unchanged.
    """
    use_loc = affinity is not None and locality_weight > 0.0
    loads = fragment_loads(weights, assignment, f)
    # Fragment membership as python lists; moves swap-pop by position
    # (order within a fragment is irrelevant to the heuristic).
    members: List[List[int]] = [[] for _ in range(f)]
    for line, frag in enumerate(assignment):
        members[frag].append(line)

    iters = 0
    while iters < max_iters:
        fcmx = int(np.argmax(loads))
        fcmn = int(np.argmin(loads))
        diff = int(loads[fcmx] - loads[fcmn])
        if diff <= 1 or fcmx == fcmn:
            break
        half = diff / 2.0

        mx = np.asarray(members[fcmx], dtype=np.int64)
        wx = weights[mx]

        # Candidate 1: transfer a line from fcmx with 0 < nzx < Diff,
        # minimizing |Diff/2 - nzx| (locality-adjusted when enabled).
        t_base = np.abs(half - wx)
        if use_loc:
            t_base = t_base - locality_weight * (
                affinity[mx, fcmn] - affinity[mx, fcmx]
            )
        t_scores = np.where((wx > 0) & (wx < diff), t_base, np.inf)
        ti = int(np.argmin(t_scores))
        best_transfer_pos = ti if np.isfinite(t_scores[ti]) else -1
        best_transfer_score = float(t_scores[ti])

        # Candidate 2: exchange (lx in fcmx, ln in fcmn) with
        # 0 < nzx - nzn < Diff, minimizing |Diff/2 - (nzx - nzn)|.
        best_exchange = None  # (position in fcmx, position in fcmn)
        best_exchange_score = np.inf
        mn = members[fcmn]
        if mn:
            mn_idx = np.asarray(mn, dtype=np.int64)
            wn = weights[mn_idx]
            sort_n = np.argsort(wn, kind="stable")
            sw = wn[sort_n]
            target = wx - half
            pos = np.searchsorted(sw, target)
            cand = np.stack(
                (np.clip(pos - 1, 0, sw.shape[0] - 1), np.clip(pos, 0, sw.shape[0] - 1)),
                axis=1,
            )  # [|fcmx|, 2] — the two neighbours of the target
            delta = wx[:, None] - sw[cand]
            e_base = np.abs(half - delta)
            if use_loc:
                # Affinity gained: lx moves fcmx→fcmn, partner ln the reverse.
                gain_x = affinity[mx, fcmn] - affinity[mx, fcmx]
                gain_n = (affinity[mn_idx, fcmx] - affinity[mn_idx, fcmn])[sort_n]
                e_base = e_base - locality_weight * (gain_x[:, None] + gain_n[cand])
            e_scores = np.where((delta > 0) & (delta < diff), e_base, np.inf)
            flat = int(np.argmin(e_scores))
            li, ci = divmod(flat, 2)
            if np.isfinite(e_scores[li, ci]):
                best_exchange = (li, int(sort_n[cand[li, ci]]))
                best_exchange_score = float(e_scores[li, ci])

        # Pick whichever move reduces the gap more (smaller score).
        if best_transfer_pos < 0 and best_exchange is None:
            break
        if best_exchange is None or (
            best_transfer_pos >= 0 and best_transfer_score <= best_exchange_score
        ):
            pos_x = best_transfer_pos
            line = members[fcmx][pos_x]
            gain = int(weights[line])
            members[fcmx][pos_x] = members[fcmx][-1]
            members[fcmx].pop()
            members[fcmn].append(line)
            assignment[line] = fcmn
            loads[fcmx] -= gain
            loads[fcmn] += gain
        else:
            pos_x, pos_n = best_exchange
            lx = members[fcmx][pos_x]
            ln = members[fcmn][pos_n]
            delta = int(weights[lx] - weights[ln])
            members[fcmx][pos_x] = ln
            members[fcmn][pos_n] = lx
            assignment[lx] = fcmn
            assignment[ln] = fcmx
            loads[fcmx] -= delta
            loads[fcmn] += delta

        iters += 1
        new_diff = fd_criterion(loads)
        if new_diff >= diff:
            # Move did not improve the global FD (it can shift the argmax
            # elsewhere) — stop, per the paper's "while FD can be reduced".
            break
    return iters


def _phase_locality(
    weights: np.ndarray,
    assignment: np.ndarray,
    f: int,
    affinity: np.ndarray,
) -> None:
    """In-place load-preserving locality pass.

    Within a weight class (lines of equal weight) any permutation of the
    line→fragment matching keeps every fragment load — and therefore the
    FD criterion — bit-identical. So per class we keep the per-fragment
    *capacities* fixed and re-solve the matching greedily for affinity:
    (line, fragment) pairs sorted by affinity descending, each line takes
    the best fragment with remaining capacity. The greedy result is only
    adopted when it beats the incumbent matching, so the pass can never
    lose affinity.
    """
    uw, inv = np.unique(weights, return_inverse=True)
    for c in range(uw.shape[0]):
        lines = np.nonzero(inv == c)[0]
        m = lines.shape[0]
        if m < 2:
            continue
        cap = np.bincount(assignment[lines], minlength=f)
        sub = affinity[lines]  # [m, f]
        cur_total = sub[np.arange(m), assignment[lines]].sum()
        order = np.argsort(sub, axis=None, kind="stable")[::-1]
        new_asg = np.full(m, -1, dtype=np.int64)
        rem = cap.copy()
        left = m
        for flat in order.tolist():
            li, fr = divmod(flat, f)
            if new_asg[li] >= 0 or rem[fr] == 0:
                continue
            new_asg[li] = fr
            rem[fr] -= 1
            left -= 1
            if left == 0:
                break
        if sub[np.arange(m), new_asg].sum() > cur_total:
            assignment[lines] = new_asg


def nezgt_partition(
    weights: np.ndarray,
    f: int,
    *,
    descending: bool = True,
    max_iters: int = 1000,
    refine: bool = True,
    affinity: np.ndarray | None = None,
    locality_weight: float = 0.0,
) -> NezgtResult:
    """Partition ``len(weights)`` lines into ``f`` fragments.

    ``weights[i]`` is the load of line ``i`` (non-zeros per row for
    NEZGT_ligne, per column for NEZGT_colonne, tiles per block-line for the
    TPU adaptation). ``refine=False`` stops after phase 1 (used by tests to
    check C1: refinement strictly helps).

    ``affinity`` is an optional ``[n_lines, f]`` table of per-(line,
    fragment) locality scores (weight of the line's non-zeros whose x
    blocks the fragment owns). With ``locality_weight > 0`` it biases the
    phase-2 move scores and enables the load-preserving phase-3 matching;
    at the default 0 the function is bit-identical to the locality-free
    heuristic.
    """
    weights = np.asarray(weights, dtype=np.int64)
    if f <= 0:
        raise ValueError(f"need f >= 1, got {f}")
    if f > weights.shape[0]:
        raise ValueError(f"f={f} exceeds number of lines {weights.shape[0]}")
    use_loc = affinity is not None and locality_weight > 0.0
    if use_loc:
        affinity = np.asarray(affinity, dtype=np.float64)
        if affinity.shape != (weights.shape[0], f):
            raise ValueError(
                f"affinity shape {affinity.shape} != {(weights.shape[0], f)}"
            )
    assignment = _phase01(weights, f, descending)
    loads = fragment_loads(weights, assignment, f)
    fd1 = fd_criterion(loads)
    iters = 0
    if refine:
        iters = _phase2(
            weights,
            assignment,
            f,
            max_iters,
            affinity if use_loc else None,
            locality_weight,
        )
        loads = fragment_loads(weights, assignment, f)
    if use_loc:
        _phase_locality(weights, assignment, f, affinity)
    return NezgtResult(
        assignment=assignment,
        loads=loads,
        fd_phase1=fd1,
        fd_final=fd_criterion(loads),
        iters=iters,
    )
