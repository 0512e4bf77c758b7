"""Shared partition-quality metrics (paper ch.4 measurement columns)."""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["load_balance", "fd", "padding_waste", "summarize_loads"]


def load_balance(loads: np.ndarray) -> float:
    """LB = max/avg — 1.0 is perfect (paper's LB_noeuds / LB_coeurs)."""
    loads = np.asarray(loads, dtype=np.float64)
    avg = loads.mean()
    return float(loads.max() / avg) if avg > 0 else 1.0


def fd(loads: np.ndarray) -> int:
    """FD criterion: spread between the two extreme fragment loads."""
    return int(np.max(loads) - np.min(loads))


def padding_waste(loads: np.ndarray) -> float:
    """SPMD realization of imbalance: every shard is padded to the max
    load, so wasted fraction = 1 - avg/max = 1 - 1/LB."""
    lb = load_balance(loads)
    return 1.0 - 1.0 / lb


def summarize_loads(loads: np.ndarray) -> Dict[str, float]:
    loads = np.asarray(loads)
    return {
        "min": float(loads.min()),
        "max": float(loads.max()),
        "avg": float(loads.mean()),
        "lb": load_balance(loads),
        "fd": float(fd(loads)),
        "padding_waste": padding_waste(loads),
    }
