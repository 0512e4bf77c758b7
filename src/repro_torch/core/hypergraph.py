"""1-D hypergraph partitioning for PMVC (paper ch.3 §4.2.2).

Çatalyürek–Aykanat column-net / row-net model: for a *row* decomposition,
vertices are rows and each column is a net connecting the rows with a
non-zero in that column (and symmetrically for the column decomposition).
The connectivity-minus-one cut

    cut(Π) = Σ_nets (λ_net − 1)

*exactly* equals the PMVC communication volume (number of x entries that
must be sent to more than one fragment / partial-y entries to combine).

Zoltan-PHG is not available offline; this is our own substrate: an
LPT-seeded, FM-refined direct k-way partitioner with the (λ−1) objective
and a balance constraint, plus an optional single coarsening level
(identical-net-signature clustering). Deterministic under ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.sparse.formats import COO
from repro_torch.core.nezgt import _phase01, fragment_loads

__all__ = [
    "Hypergraph",
    "HgResult",
    "hypergraph_from_coo",
    "connectivity_cut",
    "partition_hypergraph",
]


@dataclasses.dataclass(frozen=True)
class Hypergraph:
    num_vertices: int
    num_nets: int
    # CSR adjacency vertex -> nets
    v_ptr: np.ndarray
    v_nets: np.ndarray
    # CSR adjacency net -> vertices (pins)
    n_ptr: np.ndarray
    n_pins: np.ndarray
    vertex_weights: np.ndarray  # int64 [num_vertices]


@dataclasses.dataclass(frozen=True)
class HgResult:
    assignment: np.ndarray  # int32 [num_vertices] -> part in [0,k)
    loads: np.ndarray  # int64 [k]
    cut: int  # Σ (λ-1)
    cut_initial: int  # before FM refinement

    @property
    def k(self) -> int:
        return int(self.loads.shape[0])

    @property
    def lb(self) -> float:
        avg = self.loads.mean()
        return float(self.loads.max() / avg) if avg > 0 else 1.0


def hypergraph_from_coo(a: COO, mode: str = "rows") -> Hypergraph:
    """Build the 1-D model. ``mode='rows'``: vertices = rows, nets =
    columns (row-wise decomposition); ``mode='cols'``: transposed."""
    if mode == "rows":
        v_idx, n_idx = a.row, a.col
        nv, nn = a.shape[0], a.shape[1]
    elif mode == "cols":
        v_idx, n_idx = a.col, a.row
        nv, nn = a.shape[1], a.shape[0]
    else:
        raise ValueError(mode)

    def _csr(src: np.ndarray, dst: np.ndarray, n_src: int) -> Tuple[np.ndarray, np.ndarray]:
        perm = np.argsort(src, kind="stable")
        ptr = np.zeros(n_src + 1, dtype=np.int64)
        np.add.at(ptr, src + 1, 1)
        return np.cumsum(ptr), dst[perm].astype(np.int32)

    v_ptr, v_nets = _csr(v_idx.astype(np.int64), n_idx, nv)
    n_ptr, n_pins = _csr(n_idx.astype(np.int64), v_idx, nn)
    weights = np.bincount(v_idx, minlength=nv).astype(np.int64)
    return Hypergraph(nv, nn, v_ptr, v_nets, n_ptr, n_pins, weights)


def _pin_counts(hg: Hypergraph, assignment: np.ndarray, k: int) -> np.ndarray:
    """Λ[net, part] = number of pins of ``net`` in ``part``."""
    counts = np.zeros((hg.num_nets, k), dtype=np.int32)
    net_of_pin = np.repeat(np.arange(hg.num_nets), np.diff(hg.n_ptr))
    np.add.at(counts, (net_of_pin, assignment[hg.n_pins]), 1)
    return counts


def _cut_from_counts(counts: np.ndarray) -> int:
    """Σ (λ−1) straight from a maintained Λ table (no pin scan)."""
    lam = (counts > 0).sum(axis=1)
    return int(np.maximum(lam - 1, 0).sum())


def connectivity_cut(hg: Hypergraph, assignment: np.ndarray, k: int) -> int:
    return _cut_from_counts(_pin_counts(hg, assignment, k))


_NEG = np.int64(-(2**62))  # "never pick" sentinel, overflow-safe in where()


def _vertex_of_pin(hg: Hypergraph) -> np.ndarray:
    """Flattened pin → vertex map aligned with ``v_nets`` (cached on the
    hypergraph: it is pass-invariant and rebuilding it dominated the
    vectorized passes)."""
    cached = getattr(hg, "_vid_cache", None)
    if cached is None:
        deg = np.diff(hg.v_ptr)
        cached = np.repeat(np.arange(hg.num_vertices, dtype=np.int64), deg)
        object.__setattr__(hg, "_vid_cache", cached)  # frozen dataclass
    return cached


def _gain_rows(
    hg: Hypergraph,
    assignment: np.ndarray,
    counts: np.ndarray,
    vid: np.ndarray,
    nets: np.ndarray,
    dv: np.ndarray,
) -> np.ndarray:
    """FM gain rows ``[len(dv), k]`` for the vertex subset ``dv``.

    ``gain(v, q) = #{e ∈ nets(v): Λ[e, p_v] == 1} − #{e ∈ nets(v):
    Λ[e, q] == 0}`` — the cut delta of moving ``v`` from its part
    ``p_v`` to ``q``. Computed with bincount segment-sums over the
    (subset of the) flattened vertex→net adjacency instead of a Python
    loop with a one-element ``ndarray.sum`` per vertex; the own-part
    column is masked. ``vid``/``nets`` are the pin→local-vertex and
    pin→net arrays for exactly the pins of ``dv``.
    """
    m, k = dv.shape[0], counts.shape[1]
    own = counts[nets, assignment[dv][vid]]
    term1 = np.bincount(vid, weights=(own == 1).astype(np.float64), minlength=m)
    zero = counts == 0
    rows = np.empty((m, k), dtype=np.int64)
    for q in range(k):
        term2 = np.bincount(
            vid, weights=zero[nets, q].astype(np.float64), minlength=m
        )
        rows[:, q] = (term1 - term2).astype(np.int64)
    rows[np.arange(m), assignment[dv]] = _NEG
    return rows


def _gain_table(hg: Hypergraph, assignment: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """All-vertices FM gain matrix ``[num_vertices, k]`` in one pass."""
    nv = hg.num_vertices
    return _gain_rows(
        hg, assignment, counts, _vertex_of_pin(hg), hg.v_nets,
        np.arange(nv, dtype=np.int64),
    )


def _ragged_take(ptr: np.ndarray, items: np.ndarray, which: np.ndarray):
    """Gather the CSR segments ``which`` from (``ptr``, ``items``):
    returns (local segment id per element, gathered elements)."""
    starts = ptr[which]
    lens = (ptr[which + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, items[:0]
    off = np.concatenate(([0], np.cumsum(lens)[:-1]))
    idx = np.repeat(starts - off, lens) + np.arange(total)
    seg = np.repeat(np.arange(which.shape[0], dtype=np.int64), lens)
    return seg, items[idx]


def _refresh_stale_rows(
    hg: Hypergraph,
    assignment: np.ndarray,
    counts: np.ndarray,
    gains: np.ndarray,
    stale_nets: np.ndarray,
) -> None:
    """Incremental gain maintenance between passes: recompute only the
    rows of vertices incident to a net touched since the table was last
    exact, then clear ``stale_nets``. Late passes touch few nets, so
    this is a small fraction of a full table rebuild."""
    touched = np.nonzero(stale_nets)[0]
    if touched.shape[0] == 0:
        return
    _, pins = _ragged_take(hg.n_ptr, hg.n_pins, touched)
    dv = np.unique(pins.astype(np.int64))
    vid, nets = _ragged_take(hg.v_ptr, hg.v_nets, dv)
    gains[dv] = _gain_rows(hg, assignment, counts, vid, nets, dv)
    stale_nets[:] = False


# Stale-gain screen: vertices whose best cached gain is this close to
# positive stay in the candidate list, because a move on a shared net can
# push them over 0 mid-pass (they cost nothing unless that happens).
_SCREEN_SLACK = 0


def _fm_pass(
    hg: Hypergraph,
    assignment: np.ndarray,
    counts: np.ndarray,
    loads: np.ndarray,
    max_load: int,
    order: np.ndarray,
    gains: np.ndarray,
    stale_nets: np.ndarray,
    screen_slack: int = _SCREEN_SLACK,
    bonus: Optional[np.ndarray] = None,
) -> int:
    """One FM sweep over the maintained gain table.

    The old per-vertex sweep recomputed the ``[deg, k]`` gain slice for
    every one of the ``num_vertices`` vertices (~6 numpy calls each —
    the profiled 709k one-element ``ndarray.sum`` bottleneck). This pass
    instead:

    1. reads the caller-maintained gain matrix (exact at entry — the
       caller refreshes rows of vertices on nets in ``stale_nets``
       between passes) and keeps only *candidates* — vertices whose
       best gain is within :data:`_SCREEN_SLACK` of positive — visited
       in ``order`` (the caller's seeded permutation, as before);
    2. precomputes every candidate's best feasible target and gain in
       one masked argmax over ``[num_candidates, k]``;
    3. maintains state incrementally during the walk: the Λ table
       ``counts`` is updated by index deltas on each applied move, and a
       candidate's precomputed (target, gain) stays *exact* as long as
       no net of the vertex was touched by an earlier move — only dirty
       candidates (or a target whose balance feasibility shifted)
       recompute their ``[deg, k]`` slice. Touched nets are recorded in
       ``stale_nets`` for the caller's between-pass refresh.

    Cascaded gains that surface only after this pass's moves are picked
    up by the caller's next pass — passes are cheap now, so the caller
    runs them to convergence. Returns total gain (cut reduction).

    ``bonus`` is an optional pre-scaled integer ``[num_vertices, k]``
    locality table: the effective gain of moving ``v`` from ``p`` to
    ``q`` becomes ``cut_gain + bonus[v, q] − bonus[v, p]``, so the pass
    descends on the combined objective ``cut − Σ_v bonus[v, part(v)]``.
    The maintained ``gains`` table stays pure cut gains — the bonus is a
    per-use delta off the *current* assignment, so no extra table
    maintenance is needed.
    """
    nv = hg.num_vertices
    if bonus is not None:
        eff = gains + (bonus - bonus[np.arange(nv), assignment][:, None])
    else:
        eff = gains
    best = eff.max(axis=1)
    cand = np.nonzero(best > -screen_slack)[0]
    if cand.size == 0:
        return 0
    rank = np.empty(nv, dtype=np.int64)
    rank[order] = np.arange(nv)
    cand = cand[np.argsort(rank[cand], kind="stable")]

    # Cached best feasible move per candidate (feasibility at pass
    # start; both are re-validated at apply time).
    weights = hg.vertex_weights
    feas0 = weights[cand, None] + loads[None, :] <= max_load
    masked = np.where(feas0, eff[cand], _NEG)
    best_q = np.argmax(masked, axis=1)
    best_g = masked[np.arange(cand.shape[0]), best_q]

    total_gain = 0
    for i, v in enumerate(cand.tolist()):
        p = int(assignment[v])
        nets = hg.v_nets[hg.v_ptr[v] : hg.v_ptr[v + 1]]
        w = int(weights[v])
        q = int(best_q[i])
        g = int(best_g[i])
        dirty = bool(stale_nets[nets].any())
        if not dirty and g <= 0:
            continue  # gains unchanged since the refresh: still ≤ 0
        if dirty or loads[q] + w > max_load:
            # A net of v changed (stale gain) or the cached target went
            # over the balance bound — recompute the exact gain row.
            cnt = counts[nets]  # [deg, k]
            row = (cnt[:, p] == 1).sum() - (cnt == 0).sum(axis=0)  # [k]
            if bonus is not None:
                row = row + (bonus[v] - bonus[v, p])
            row[p] = _NEG
            g_row = np.where(loads + w <= max_load, row, _NEG)
            q = int(np.argmax(g_row))
            g = int(g_row[q])
            if g <= 0:
                continue
        # Apply the move; Λ is maintained by bincount-style index deltas.
        counts[nets, p] -= 1
        counts[nets, q] += 1
        loads[p] -= w
        loads[q] += w
        assignment[v] = q
        stale_nets[nets] = True
        total_gain += g
    return total_gain


def _kick(
    hg: Hypergraph,
    assignment: np.ndarray,
    counts: np.ndarray,
    loads: np.ndarray,
    max_load: int,
    rng: np.random.Generator,
    stale_nets: np.ndarray,
) -> None:
    """Perturb a converged partition in place: move a few random *cut
    boundary* vertices (incident to a λ>1 net) to a random feasible
    other part, recording the touched nets in ``stale_nets``. The
    iterated-local-search escape — the caller snapshots the best
    converged state, so a bad kick can never degrade the returned
    result, while a good one lets the next FM rounds descend into a
    neighbouring (often better) local optimum."""
    k = loads.shape[0]
    if k < 2:
        return
    lam_gt1 = (counts > 0).sum(axis=1) > 1
    vid = _vertex_of_pin(hg)
    on_boundary = (
        np.bincount(
            vid,
            weights=lam_gt1[hg.v_nets].astype(np.float64),
            minlength=hg.num_vertices,
        )
        > 0
    )
    cand = np.nonzero(on_boundary)[0]
    if cand.size == 0:
        return
    m = int(min(cand.size, max(4, min(64, cand.size // 64))))
    for v in rng.choice(cand, size=m, replace=False).tolist():
        p = int(assignment[v])
        w = int(hg.vertex_weights[v])
        feas = np.nonzero(loads + w <= max_load)[0]
        feas = feas[feas != p]
        if feas.size == 0:
            continue
        q = int(rng.choice(feas))
        nets = hg.v_nets[hg.v_ptr[v] : hg.v_ptr[v + 1]]
        counts[nets, p] -= 1
        counts[nets, q] += 1
        loads[p] -= w
        loads[q] += w
        assignment[v] = q
        stale_nets[nets] = True


def partition_hypergraph(
    hg: Hypergraph,
    k: int,
    *,
    epsilon: float = 0.10,
    passes: int = 80,
    kicks: int = 8,
    seed: int = 0,
    screen_slack: Optional[int] = None,
    affinity: Optional[np.ndarray] = None,
    locality_weight: float = 0.0,
) -> HgResult:
    """Direct k-way partition minimizing the (λ−1) cut subject to
    ``load(part) ≤ (1+epsilon) · total/k``.

    ``passes`` bounds the total FM refinement rounds. Rounds are cheap
    (vectorized :func:`_fm_pass`), so unlike the old 6-sweep cap the
    refinement actually reaches a local optimum of single-vertex moves;
    it then perturbs a few boundary vertices (:func:`_kick`) and
    re-converges up to ``kicks`` times, returning the best converged
    assignment seen (iterated local search — strictly no worse than the
    first local optimum, and in practice at or below the old sweeps'
    quality at a fraction of their cost).

    ``passes`` / ``kicks`` / ``screen_slack`` are the per-call
    refinement budget: a caller planning a throwaway or low-SLA
    partition (the serving engine's on-demand graphs) can trade cut
    quality for planning latency — e.g. ``passes=8, kicks=0`` stops
    after the first local descent. ``screen_slack`` overrides the
    stale-gain candidate screen (:data:`_SCREEN_SLACK`; ``None`` keeps
    the default): larger values re-examine more near-zero-gain vertices
    per pass, smaller ones make each pass cheaper.

    ``affinity`` is an optional ``[num_vertices, k]`` locality table
    (weight of each vertex's pins whose x blocks part ``q`` owns). With
    ``locality_weight > 0`` refinement descends on the combined integer
    objective ``cut − round(w·affinity)`` summed over the assignment —
    FM moves that convert halo tiles into local tiles are rewarded —
    while the reported ``cut`` stays the true (λ−1) cut of the returned
    assignment. At the default 0 the function is bit-identical to the
    locality-free partitioner.
    """
    if k <= 0:
        raise ValueError(k)
    bonus: Optional[np.ndarray] = None
    if affinity is not None and locality_weight > 0.0:
        affinity = np.asarray(affinity, dtype=np.float64)
        if affinity.shape != (hg.num_vertices, k):
            raise ValueError(
                f"affinity shape {affinity.shape} != {(hg.num_vertices, k)}"
            )
        bonus = np.rint(locality_weight * affinity).astype(np.int64)
    rng = np.random.default_rng(seed)
    # LPT seed on vertex weights — NEZGT phase 0+1 doubles as the balanced
    # initial partition (the two methods share their balance machinery).
    assignment = _phase01(hg.vertex_weights, k, descending=True)
    loads = fragment_loads(hg.vertex_weights, assignment, k)
    total = int(hg.vertex_weights.sum())
    max_load = int(np.ceil((1.0 + epsilon) * total / k)) + int(hg.vertex_weights.max(initial=1))

    counts = _pin_counts(hg, assignment, k)
    lam = (counts > 0).sum(axis=1)
    cut0 = int(np.maximum(lam - 1, 0).sum())

    # The gain table is built once and then maintained: after each pass
    # (or kick) only rows of vertices on touched nets are recomputed.
    gains = _gain_table(hg, assignment, counts)
    stale_nets = np.zeros(hg.num_nets, dtype=bool)

    def _objective(asg: np.ndarray, cut_val: int) -> int:
        # Snapshot selection criterion: true cut, minus the locality
        # bonus of the assignment when locality is enabled.
        if bonus is None:
            return cut_val
        return cut_val - int(bonus[np.arange(hg.num_vertices), asg].sum())

    best_assignment: np.ndarray | None = None
    best_loads: np.ndarray | None = None
    best_cut = 0
    best_obj = np.inf
    kicks_left = kicks
    slack = _SCREEN_SLACK if screen_slack is None else int(screen_slack)
    for _ in range(passes):
        order = rng.permutation(hg.num_vertices)
        gain = _fm_pass(
            hg, assignment, counts, loads, max_load, order, gains, stale_nets,
            screen_slack=slack, bonus=bonus,
        )
        if gain != 0:
            _refresh_stale_rows(hg, assignment, counts, gains, stale_nets)
            continue
        # Converged: snapshot if best, then kick or stop. The cut comes
        # from the incrementally-maintained Λ table — no pin re-scan.
        cut_now = _cut_from_counts(counts)
        obj_now = _objective(assignment, cut_now)
        if obj_now < best_obj:
            best_obj = obj_now
            best_cut = cut_now
            best_assignment = assignment.copy()
            best_loads = loads.copy()
        if kicks_left <= 0:
            break
        kicks_left -= 1
        _kick(hg, assignment, counts, loads, max_load, rng, stale_nets)
        _refresh_stale_rows(hg, assignment, counts, gains, stale_nets)

    # `passes` may run out mid-descent; keep the better of the final
    # state and the best converged snapshot.
    cut_final = _cut_from_counts(counts)
    if best_assignment is not None and best_obj <= _objective(assignment, cut_final):
        assignment, loads, cut = best_assignment, best_loads, int(best_cut)
    else:
        cut = int(cut_final)
    return HgResult(assignment=assignment.astype(np.int32), loads=loads, cut=cut, cut_initial=cut0)
