"""Frozen matrix generators, one module a ``generator`` name.

Each module has ``graphs(config, seed) -> {name: Matrix}`` and
``TINY``, the overrides of its configuration's keys that cut it to the
size of a CPU test. They are numpy copies made for the benchmark, so a
change to the program's own generators never changes what is measured.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from portbench import load

__all__ = ["Matrix", "generator", "make_graphs"]


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


def generator(config: dict, root: Optional[str] = None):
    """``portbench/matrices/<generator>.py`` of ``config``, from the
    checkout ``root`` or this package (:func:`portbench.load`)."""
    return load("matrices", config["generator"], root)


def make_graphs(config: dict, seed: int, root: Optional[str] = None) -> dict:
    """The named matrices of ``config``, by its ``generator``."""
    return generator(config, root).graphs(config, seed)
