"""Cluster topology descriptor: the paper's (f nodes × c cores) grid.

The thesis distributes A in two levels — NEZGT across the ``f`` nodes of
the Grid'5000 cluster, then a hypergraph split across the ``c`` cores of
each node. A flat *unit* index ``node * cores + core`` addresses every
compute unit; this class owns that mapping so no caller re-derives it by
hand.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Topology"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """``nodes`` × ``cores_per_node`` compute-unit grid."""

    nodes: int
    cores: int = 1

    def __post_init__(self):
        if self.nodes < 1 or self.cores < 1:
            raise ValueError(f"topology must be positive, got {self}")

    @property
    def units(self) -> int:
        return self.nodes * self.cores

    def unit_of(self, node, core):
        """Flat unit id of (node, core); accepts scalars or arrays."""
        return np.asarray(node, dtype=np.int64) * self.cores + np.asarray(core)

    def node_of(self, unit):
        return np.asarray(unit) // self.cores

    def core_of(self, unit):
        return np.asarray(unit) % self.cores

    def __str__(self) -> str:
        return f"{self.nodes}x{self.cores}"
