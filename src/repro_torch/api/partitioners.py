"""Partitioner registry: matrix → per-element compute-unit assignment.

Built-in entries:

* The thesis' four two-level combinations — ``"NL-HL"``, ``"NL-HC"``,
  ``"NC-HL"``, ``"NC-HC"`` (N = NEZGT, H = hypergraph, L = rows,
  C = cols) — inter-node then intra-node, via
  :func:`repro_torch.core.combined.two_level_partition`. Any other ``"XX-YY"``
  string over {N,H}×{L,C} (the [MeH12] combos, e.g. ``"NC-NC"``) is
  resolved on the fly.
* ``"nezgt"`` / ``"hyper"`` — flat one-level partitions over all
  ``topology.units`` units (dim selectable via ``dim="rows"|"cols"``),
  for comparing against the two-level pipeline.

User strategies register with :func:`register_partitioner`; a
partitioner is any callable ``(a: COO, topology: Topology, *, seed=0,
**kw) -> PartitionResult``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import numpy as np

from repro_torch.api.registry import Registry
from repro_torch.api.topology import Topology
from repro_torch.core.combined import (
    LevelSpec,
    PAPER_COMBOS,
    TwoLevelPlan,
    comm_stats,
    partition_lines,
    two_level_partition,
)
from repro_torch.core.metrics import fd, load_balance
from repro_torch.sparse.formats import COO

__all__ = [
    "PARTITIONERS",
    "PartitionResult",
    "register_partitioner",
    "resolve_partitioner",
]

PARTITIONERS = Registry("partitioner")
register_partitioner = PARTITIONERS.register

_COMBO_RE = re.compile(r"^[NH][LC]-[NH][LC]$")


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    """Element → unit assignment plus the metrics the paper reports."""

    name: str
    topology: Topology
    elem_unit: np.ndarray  # int64 [nnz] → unit in [0, topology.units)
    plan: Optional[TwoLevelPlan] = None  # set by two-level partitioners
    cut: Optional[int] = None  # connectivity cut of flat hypergraph runs

    def unit_loads(self) -> np.ndarray:
        return np.bincount(self.elem_unit, minlength=self.topology.units)

    def node_loads(self) -> np.ndarray:
        return np.bincount(
            self.topology.node_of(self.elem_unit), minlength=self.topology.nodes
        )

    @property
    def lb_units(self) -> float:
        """max/avg non-zeros per unit (paper's LB, at unit granularity)."""
        return load_balance(self.unit_loads())

    @property
    def lb_nodes(self) -> float:
        if self.plan is not None:
            return self.plan.lb_nodes
        return load_balance(self.node_loads())

    @property
    def lb_cores(self) -> float:
        return self.plan.lb_cores if self.plan is not None else self.lb_units

    @property
    def inter_fd(self) -> int:
        if self.plan is not None:
            return self.plan.inter_fd
        return fd(self.node_loads())

    @property
    def hyper_cut(self) -> int:
        if self.plan is not None:
            return self.plan.hyper_cut
        return self.cut if self.cut is not None else 0

    def comm_stats(self, a: COO):
        """Per-unit C_X / C_Y / DR / DE quantities (paper ch.3 §4.2.3)."""
        if self.plan is not None:
            return self.plan.core_stats
        return comm_stats(a, self.elem_unit, self.topology.units)

    def modeled_cost(self, **kw) -> dict:
        """α-β phase-cost model; needs a two-level plan."""
        if self.plan is None:
            raise ValueError(f"partitioner {self.name!r} has no two-level plan")
        return self.plan.modeled_cost(**kw)


def _fm_budget(
    fm_passes: Optional[int],
    fm_kicks: Optional[int],
    fm_screen_slack: Optional[int],
) -> Optional[dict]:
    """Collect non-default FM refinement budget overrides into the
    ``fm_kw`` dict the core partitioning layer consumes (None = library
    default, key omitted so :func:`partition_hypergraph` defaults
    apply)."""
    kw = {}
    if fm_passes is not None:
        kw["passes"] = int(fm_passes)
    if fm_kicks is not None:
        kw["kicks"] = int(fm_kicks)
    if fm_screen_slack is not None:
        kw["screen_slack"] = int(fm_screen_slack)
    return kw or None


def _combo_partitioner(combo: str) -> Callable:
    def run(
        a: COO,
        topology: Topology,
        *,
        seed: int = 0,
        timings: Optional[dict] = None,
        fm_passes: Optional[int] = None,
        fm_kicks: Optional[int] = None,
        fm_screen_slack: Optional[int] = None,
        locality_weight: float = 0.0,
        locality_bn: Optional[int] = None,
    ) -> PartitionResult:
        plan = two_level_partition(
            a, topology.nodes, topology.cores, combo, seed=seed, timings=timings,
            fm_kw=_fm_budget(fm_passes, fm_kicks, fm_screen_slack),
            locality_weight=locality_weight, locality_bn=locality_bn,
        )
        elem_unit = topology.unit_of(plan.elem_node, plan.elem_core)
        return PartitionResult(
            name=combo, topology=topology, elem_unit=elem_unit, plan=plan
        )

    run.__name__ = f"partition_{combo.replace('-', '_')}"
    return run


for _combo in PAPER_COMBOS:
    PARTITIONERS.register(_combo, _combo_partitioner(_combo))


def _flat_partitioner(method: str) -> Callable:
    def run(
        a: COO,
        topology: Topology,
        *,
        seed: int = 0,
        dim: str = "rows",
        fm_passes: Optional[int] = None,
        fm_kicks: Optional[int] = None,
        fm_screen_slack: Optional[int] = None,
        locality_weight: float = 0.0,
        locality_bn: Optional[int] = None,
    ) -> PartitionResult:
        cut = None
        fm_kw = _fm_budget(fm_passes, fm_kicks, fm_screen_slack)
        affinity = None
        if locality_weight > 0.0:
            if locality_bn is None:
                raise ValueError("locality_weight > 0 requires locality_bn")
            from repro_torch.sparse.bell import x_block_owner

            u_n = topology.units
            ncb = -(-a.shape[1] // locality_bn)
            home_unit = x_block_owner(ncb, u_n)[a.col // locality_bn]
            lines_idx = (a.row if dim == "rows" else a.col).astype(np.int64)
            n_lines = a.shape[0] if dim == "rows" else a.shape[1]
            affinity = (
                np.bincount(lines_idx * u_n + home_unit, minlength=n_lines * u_n)
                .reshape(n_lines, u_n)
                .astype(np.float64)
            )
        if method == "hyper":
            # Go through the hypergraph module directly so the real
            # connectivity cut is kept (partition_lines discards it).
            from repro_torch.core import hypergraph as hg

            res = hg.partition_hypergraph(
                hg.hypergraph_from_coo(a, mode=dim), topology.units, seed=seed,
                affinity=affinity, locality_weight=locality_weight,
                **(fm_kw or {}),
            )
            assignment, cut = res.assignment, int(res.cut)
        else:
            assignment = partition_lines(
                a, topology.units, LevelSpec(method, dim), seed=seed, fm_kw=fm_kw,
                affinity=affinity, locality_weight=locality_weight,
            )
        lines = a.row if dim == "rows" else a.col
        elem_unit = assignment[lines].astype(np.int64)
        return PartitionResult(
            name=f"{method}:{dim}", topology=topology, elem_unit=elem_unit, cut=cut
        )

    run.__name__ = f"partition_{method}"
    return run


PARTITIONERS.register("nezgt", _flat_partitioner("nezgt"))
PARTITIONERS.register("hyper", _flat_partitioner("hyper"))


def resolve_partitioner(name: str) -> Callable:
    """Registry lookup, with un-registered ``"XX-YY"`` generic combos
    (the [MeH12] set) synthesized on demand."""
    if name in PARTITIONERS:
        return PARTITIONERS.get(name)
    if _COMBO_RE.match(name):
        return _combo_partitioner(name)
    return PARTITIONERS.get(name)  # raises with the known-names message
