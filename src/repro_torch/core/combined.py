"""Two-level (inter-node × intra-node) sparse matrix distribution.

The paper's central object (ch.3 §4.2.3, ch.4 §2): decompose A once with
NEZGT across the ``f`` nodes of the cluster, then decompose each node
fragment with the hypergraph method across the ``c`` cores of that node.
Four combinations are studied: NL-HL, NL-HC, NC-HL, NC-HC
(N = NEZGT, H = hypergraph, L = row/ligne, C = column/colonne).

We generalize to any (method, dimension) pair at either level so the
related-work combinations of [MeH12] (NEZ-NEZ, HYP-HYP, HYP-NEZ) are also
expressible; the thesis' four are exposed under their paper names.

Every non-zero ends up with a (node, core) owner; all paper metrics
(LB_nodes, LB_cores, C_Xk, C_Yk, FR_Xk, DR_k, DE_k, scatter/gather
volumes) derive from that element-level assignment.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.sparse.formats import COO
from repro_torch.sparse.bell import x_block_owner
from repro_torch.core import nezgt
from repro_torch.core import hypergraph as hg

__all__ = [
    "PAPER_COMBOS",
    "LevelSpec",
    "CommStats",
    "TwoLevelPlan",
    "comm_stats",
    "two_level_partition",
    "partition_lines",
]

# The thesis' four combinations (Table 4.1).
PAPER_COMBOS: Dict[str, Tuple[Tuple[str, str], Tuple[str, str]]] = {
    "NL-HL": (("nezgt", "rows"), ("hyper", "rows")),
    "NL-HC": (("nezgt", "rows"), ("hyper", "cols")),
    "NC-HL": (("nezgt", "cols"), ("hyper", "rows")),
    "NC-HC": (("nezgt", "cols"), ("hyper", "cols")),
}


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    method: str  # 'nezgt' | 'hyper'
    dim: str  # 'rows' | 'cols'


@dataclasses.dataclass(frozen=True)
class CommStats:
    """Paper ch.3 §4.2.3 communication quantities, per compute unit."""

    nnz: np.ndarray  # load per unit
    c_x: np.ndarray  # distinct x entries needed (fan-out volume)
    c_y: np.ndarray  # distinct partial-y entries produced (fan-in volume)
    fr_x: np.ndarray  # reduction factor N / C_Xk

    @property
    def reception(self) -> np.ndarray:  # DR_k = NZ_k + C_Xk
        return self.nnz + self.c_x

    @property
    def emission(self) -> np.ndarray:  # DE_k = C_Yk
        return self.c_y

    @property
    def lb(self) -> float:
        avg = self.nnz.mean()
        return float(self.nnz.max() / avg) if avg > 0 else 1.0


@dataclasses.dataclass(frozen=True)
class TwoLevelPlan:
    combo: str
    inter: LevelSpec
    intra: LevelSpec
    f: int  # nodes
    c: int  # cores per node
    shape: Tuple[int, int]
    nnz: int
    elem_node: np.ndarray  # int32 [nnz] -> node
    elem_core: np.ndarray  # int32 [nnz] -> core within node
    node_stats: CommStats  # per node (f entries)
    core_stats: CommStats  # per (node*c + core) unit (f*c entries)
    inter_fd: int  # FD criterion at the node level
    hyper_cut: int  # Σ intra-level (λ-1) cuts (0 for NEZGT intra)

    @property
    def lb_nodes(self) -> float:
        return self.node_stats.lb

    @property
    def lb_cores(self) -> float:
        return self.core_stats.lb

    @property
    def scatter_volume(self) -> int:
        """Total reals sent during fan-out: Σ_k DR_k."""
        return int(self.node_stats.reception.sum())

    @property
    def gather_volume(self) -> int:
        """Total reals returned during fan-in: Σ_k DE_k."""
        return int(self.node_stats.emission.sum())

    def modeled_cost(
        self,
        *,
        flop_rate: float = 2.0e9,  # scalar MACs/s per core
        bw: float = 1.25e9,  # bytes/s per link (10 GbE, the paper's network)
        alpha: float = 5e-6,  # per-message latency
        bytes_per_real: int = 8,
    ) -> Dict[str, float]:
        """α-β cost model of the paper's measured phases (used by the
        benchmark tables; hardware-free comparison of combinations)."""
        compute = float(self.core_stats.nnz.max()) / flop_rate
        scatter = alpha * self.f + self.scatter_volume * bytes_per_real / bw
        gather = alpha * self.f + self.gather_volume * bytes_per_real / bw
        # Local Y construction: column variants must reduce partial vectors.
        construct = float(self.core_stats.c_y.sum()) / flop_rate
        return {
            "scatter": scatter,
            "compute": compute,
            "construct_y": construct,
            "gather": gather,
            "total": compute + gather + construct,
        }


def partition_lines(
    a: COO,
    k: int,
    spec: LevelSpec,
    *,
    seed: int = 0,
    line_weights: np.ndarray | None = None,
    fm_kw: Optional[Dict[str, int]] = None,
    affinity: np.ndarray | None = None,
    locality_weight: float = 0.0,
) -> np.ndarray:
    """Partition the rows (or cols) of ``a`` into ``k`` groups with the
    requested method. Returns per-line assignment (length N or M).

    ``fm_kw`` forwards refinement-budget overrides (``passes`` /
    ``kicks`` / ``screen_slack``) to
    :func:`repro_torch.core.hypergraph.partition_hypergraph`; NEZGT has no
    refinement loop, so the budget is ignored for ``method="nezgt"``.

    ``affinity``/``locality_weight`` forward the locality objective
    (per-(line, group) own-x-block scores) to either method; at weight 0
    both are bit-identical to the locality-free heuristics.
    """
    if spec.method == "nezgt":
        if line_weights is None:
            line_weights = a.row_counts() if spec.dim == "rows" else a.col_counts()
        res = nezgt.nezgt_partition(
            line_weights, k, affinity=affinity, locality_weight=locality_weight
        )
        return res.assignment
    elif spec.method == "hyper":
        graph = hg.hypergraph_from_coo(a, mode=spec.dim)
        res = hg.partition_hypergraph(
            graph, k, seed=seed, affinity=affinity,
            locality_weight=locality_weight, **(fm_kw or {}),
        )
        return res.assignment
    raise ValueError(f"unknown method {spec.method}")


def comm_stats(
    a: COO, owner: np.ndarray, num_units: int
) -> CommStats:
    """Element-owner array -> per-unit nnz / C_X / C_Y."""
    n = a.shape[0]
    nnz = np.bincount(owner, minlength=num_units).astype(np.int64)
    c_x = np.zeros(num_units, dtype=np.int64)
    c_y = np.zeros(num_units, dtype=np.int64)
    # Distinct (unit, col) and (unit, row) pairs.
    for arr, out, dim in ((a.col, c_x, a.shape[1]), (a.row, c_y, a.shape[0])):
        key = owner.astype(np.int64) * dim + arr
        uniq = np.unique(key)
        np.add.at(out, (uniq // dim).astype(np.int64), 1)
    fr = np.where(c_x > 0, n / np.maximum(c_x, 1), float(n))
    return CommStats(nnz=nnz, c_x=c_x, c_y=c_y, fr_x=fr)


def two_level_partition(
    a: COO,
    f: int,
    c: int,
    combo: str = "NL-HL",
    *,
    seed: int = 0,
    timings: Optional[Dict[str, float]] = None,
    fm_kw: Optional[Dict[str, int]] = None,
    locality_weight: float = 0.0,
    locality_bn: Optional[int] = None,
) -> TwoLevelPlan:
    """Run the paper's combined method: inter-node then intra-node.

    When ``timings`` is a dict it receives the wall-clock seconds of the
    three planning stages (``inter_s``, ``intra_s``, ``metrics_s``) —
    the per-phase decomposition ``benchmarks/bench_partition.py`` writes
    to ``BENCH_plan.json``.

    ``fm_kw`` applies an FM refinement-budget override (``passes`` /
    ``kicks`` / ``screen_slack``) to every hypergraph level of the
    combo; NEZGT levels are unaffected.

    ``locality_weight > 0`` enables the locality objective at both
    levels (DESIGN.md §13): each non-zero's *home unit* is the unit that
    owns its x block under the runtime's contiguous block-col ownership
    (:func:`repro_torch.sparse.bell.x_block_owner` with ``bn=locality_bn``,
    which must then be given). The inter level scores lines by how much
    of their weight lands on each node's units; the intra level scores
    the node's lines against the node's own cores — so both partitioners
    are pulled toward placements whose tiles read x locally instead of
    through the exchange.
    """
    if combo in PAPER_COMBOS:
        (im, idim), (jm, jdim) = PAPER_COMBOS[combo]
        inter, intra = LevelSpec(im, idim), LevelSpec(jm, jdim)
    else:
        # Generic "XX-YY" with X,Y in {NL,NC,HL,HC} for the [MeH12] combos.
        tok = {"N": "nezgt", "H": "hyper", "L": "rows", "C": "cols"}
        p, q = combo.split("-")
        inter, intra = LevelSpec(tok[p[0]], tok[p[1]]), LevelSpec(tok[q[0]], tok[q[1]])

    use_loc = locality_weight > 0.0
    home_node = home_core = None
    if use_loc:
        if locality_bn is None:
            raise ValueError("locality_weight > 0 requires locality_bn")
        ncb = -(-a.shape[1] // locality_bn)
        home_unit = x_block_owner(ncb, f * c)[a.col // locality_bn]  # [nnz]
        home_node = home_unit // c
        home_core = home_unit % c

    # --- Inter-node level ------------------------------------------------
    t0 = time.perf_counter()
    aff_inter = None
    if use_loc:
        lines_idx = (a.row if inter.dim == "rows" else a.col).astype(np.int64)
        n_lines = a.shape[0] if inter.dim == "rows" else a.shape[1]
        aff_inter = (
            np.bincount(lines_idx * f + home_node, minlength=n_lines * f)
            .reshape(n_lines, f)
            .astype(np.float64)
        )
    node_of_line = partition_lines(
        a, f, inter, seed=seed, fm_kw=fm_kw,
        affinity=aff_inter, locality_weight=locality_weight,
    )
    elem_line = a.row if inter.dim == "rows" else a.col
    elem_node = node_of_line[elem_line].astype(np.int32)

    inter_loads = np.bincount(elem_node, minlength=f).astype(np.int64)
    inter_fd = int(inter_loads.max() - inter_loads.min())
    t1 = time.perf_counter()

    # --- Intra-node level -------------------------------------------------
    elem_core = np.zeros(a.nnz, dtype=np.int32)
    hyper_cut = 0
    for k in range(f):
        sel = np.nonzero(elem_node == k)[0]
        if sel.shape[0] == 0:
            continue
        sub_rows, sub_cols, sub_vals = a.row[sel], a.col[sel], a.val[sel]
        # Remap the intra dimension to a compact local index space.
        lines = sub_rows if intra.dim == "rows" else sub_cols
        uniq, local = np.unique(lines, return_inverse=True)
        n_local = uniq.shape[0]
        cc = min(c, n_local)
        if intra.dim == "rows":
            sub = COO((n_local, a.shape[1]), local.astype(np.int32), sub_cols, sub_vals)
        else:
            sub = COO((a.shape[0], n_local), sub_rows, local.astype(np.int32), sub_vals)
        aff_sub = None
        if use_loc:
            # Only elements whose home unit sits on *this* node can become
            # local by intra-level placement; score them by home core.
            sh_node, sh_core = home_node[sel], home_core[sel]
            ok = (sh_node == k) & (sh_core < cc)
            aff_sub = (
                np.bincount(local[ok] * cc + sh_core[ok], minlength=n_local * cc)
                .reshape(n_local, cc)
                .astype(np.float64)
            )
        if intra.method == "hyper":
            graph = hg.hypergraph_from_coo(sub, mode=intra.dim)
            res = hg.partition_hypergraph(
                graph, cc, seed=seed + 1 + k, affinity=aff_sub,
                locality_weight=locality_weight, **(fm_kw or {}),
            )
            assignment = res.assignment
            hyper_cut += res.cut
        else:
            w = sub.row_counts() if intra.dim == "rows" else sub.col_counts()
            assignment = nezgt.nezgt_partition(
                w, cc, affinity=aff_sub, locality_weight=locality_weight
            ).assignment
        elem_core[sel] = assignment[local]

    # --- Metrics ------------------------------------------------------------
    t2 = time.perf_counter()
    unit = elem_node.astype(np.int64) * c + elem_core
    node_stats = comm_stats(a, elem_node.astype(np.int64), f)
    core_stats = comm_stats(a, unit, f * c)
    if timings is not None:
        timings["inter_s"] = t1 - t0
        timings["intra_s"] = t2 - t1
        timings["metrics_s"] = time.perf_counter() - t2
    return TwoLevelPlan(
        combo=combo,
        inter=inter,
        intra=intra,
        f=f,
        c=c,
        shape=a.shape,
        nnz=a.nnz,
        elem_node=elem_node,
        elem_core=elem_core,
        node_stats=node_stats,
        core_stats=core_stats,
        inter_fd=inter_fd,
        hyper_cut=hyper_cut,
    )
