"""Frozen matrix generators, one module a ``generator`` name.

Each module has ``graphs(config, seed) -> {name: Matrix}`` and
``TINY``, the overrides of its configuration's keys that cut it to the
size of a CPU test. They are numpy copies made for the benchmark, so a
change to the program's own generators never changes what is measured.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Optional

import numpy as np

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
    """``portbench/matrices/<generator>.py`` of ``config``, loaded from
    its file in the checkout ``root`` as the metrics' readers are, or
    from this package where ``root`` is None or has no such file."""
    name = config["generator"]
    path = os.path.join(root or "", "portbench", "matrices", f"{name}.py")
    if root is None or not os.path.exists(path):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.py")
    mod_name = "portbench_matrix_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_graphs(config: dict, seed: int, root: Optional[str] = None) -> dict:
    """The named matrices of ``config``, by its ``generator``."""
    return generator(config, root).graphs(config, seed)
