"""Frozen matrix generators, one module a ``generator`` name.

Each module has ``graphs(config, seed) -> {name: Matrix}``. They are
numpy copies made for the benchmark, so a change to the program's own
generators never changes what is measured.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np

__all__ = ["Matrix", "make_graphs"]


@dataclasses.dataclass(frozen=True)
class Matrix:
    """A square sparse matrix in COO form: int32 rows and columns,
    float32 values (the type the program plans and serves)."""

    n: int
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])


def make_graphs(config: dict, seed: int) -> dict:
    """The named matrices of ``config``, by its ``generator``."""
    mod = importlib.import_module(f"portbench.matrices.{config['generator']}")
    return mod.graphs(config, seed)
