"""Sparse matrix storage formats (paper ch.1 §2.3).

Host-side (numpy) representations used by the partitioners and by the
Block-ELL packing that feeds the Pallas SpMV kernel. These mirror the
formats the thesis presents (COO, CSR, CSC) plus the TPU-native Block-ELL
(BELL) layout described in DESIGN.md §2.

All formats are immutable dataclasses over numpy arrays; device-side
packing happens in :mod:`repro_torch.sparse.bell`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "COO",
    "CSR",
    "CSC",
    "coo_from_dense",
    "csr_from_coo",
    "csc_from_coo",
    "dense_from_coo",
]


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate format: three NNZ-sized arrays (Val, Lig, Col)."""

    shape: Tuple[int, int]
    row: np.ndarray  # int32 [nnz]
    col: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float  [nnz]

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def density(self) -> float:
        n, m = self.shape
        return self.nnz / float(n * m) if n and m else 0.0

    def row_counts(self) -> np.ndarray:
        """Non-zeros per row — the NEZGT_ligne load vector."""
        return np.bincount(self.row, minlength=self.shape[0]).astype(np.int64)

    def col_counts(self) -> np.ndarray:
        """Non-zeros per column — the NEZGT_colonne load vector."""
        return np.bincount(self.col, minlength=self.shape[1]).astype(np.int64)

    def validate(self) -> None:
        n, m = self.shape
        assert self.row.shape == self.col.shape == self.val.shape
        if self.nnz:
            assert self.row.min() >= 0 and self.row.max() < n
            assert self.col.min() >= 0 and self.col.max() < m

    def select_rows(self, rows: np.ndarray) -> "COO":
        """Sub-matrix restricted to ``rows`` (global indices kept)."""
        mask = np.isin(self.row, rows)
        return COO(self.shape, self.row[mask], self.col[mask], self.val[mask])

    def select_cols(self, cols: np.ndarray) -> "COO":
        mask = np.isin(self.col, cols)
        return COO(self.shape, self.row[mask], self.col[mask], self.val[mask])


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed Sparse Row: Val/Col per row, Ptr of size N+1."""

    shape: Tuple[int, int]
    ptr: np.ndarray  # int32 [n+1]
    col: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float [nnz]

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def row_counts(self) -> np.ndarray:
        return np.diff(self.ptr).astype(np.int64)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference sequential PMVC (paper ch.1 §5 CSR algorithm)."""
        n = self.shape[0]
        y = np.zeros(n, dtype=np.result_type(self.val.dtype, x.dtype))
        for i in range(n):
            lo, hi = self.ptr[i], self.ptr[i + 1]
            y[i] = np.dot(self.val[lo:hi], x[self.col[lo:hi]])
        return y


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed Sparse Column: Val/Lig per column, Ptr of size M+1."""

    shape: Tuple[int, int]
    ptr: np.ndarray  # int32 [m+1]
    row: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float [nnz]

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def col_counts(self) -> np.ndarray:
        return np.diff(self.ptr).astype(np.int64)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Column-version PMVC: accumulate partial sums (paper ch.3 §2.3)."""
        n = self.shape[0]
        y = np.zeros(n, dtype=np.result_type(self.val.dtype, x.dtype))
        for j in range(self.shape[1]):
            lo, hi = self.ptr[j], self.ptr[j + 1]
            y[self.row[lo:hi]] += self.val[lo:hi] * x[j]
        return y


def coo_from_dense(a: np.ndarray) -> COO:
    r, c = np.nonzero(a)
    return COO(a.shape, r.astype(np.int32), c.astype(np.int32), a[r, c])


def dense_from_coo(a: COO) -> np.ndarray:
    out = np.zeros(a.shape, dtype=a.val.dtype)
    out[a.row, a.col] = a.val
    return out


def _sorted_perm(primary: np.ndarray, secondary: np.ndarray) -> np.ndarray:
    return np.lexsort((secondary, primary))


def csr_from_coo(a: COO) -> CSR:
    perm = _sorted_perm(a.row, a.col)
    row, col, val = a.row[perm], a.col[perm], a.val[perm]
    ptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.add.at(ptr, row + 1, 1)
    ptr = np.cumsum(ptr)
    return CSR(a.shape, ptr.astype(np.int64), col.astype(np.int32), val)


def csc_from_coo(a: COO) -> CSC:
    perm = _sorted_perm(a.col, a.row)
    row, col, val = a.row[perm], a.col[perm], a.val[perm]
    ptr = np.zeros(a.shape[1] + 1, dtype=np.int64)
    np.add.at(ptr, col + 1, 1)
    ptr = np.cumsum(ptr)
    return CSC(a.shape, ptr.astype(np.int64), row.astype(np.int32), val)
