"""Synthetic sparse matrix generators matched to the paper's test suite.

The thesis evaluates on 8 matrices from the Tim Davis / SuiteSparse
collection (Table 4.2). That collection is not available offline, so we
generate matrices with the *same order N, non-zero count NNZ, density and
structure class* (banded / 2-D grid stencil / random / power-law), with
fixed seeds for reproducibility. DESIGN.md §5 records this substitution.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch.sparse.formats import COO

__all__ = [
    "MatrixSpec",
    "PAPER_SUITE",
    "generate",
    "random_coo",
    "banded_coo",
    "grid5_coo",
    "powerlaw_coo",
]


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """One row of the paper's Table 4.2."""

    name: str
    n: int
    nnz: int
    structure: str  # diagonal | banded | grid | random | powerlaw
    domain: str


# Paper Table 4.2 — name, N, NNZ, structure class, application domain.
PAPER_SUITE: Dict[str, MatrixSpec] = {
    s.name: s
    for s in [
        MatrixSpec("bcsstm09", 1083, 1083, "diagonal", "structural engineering"),
        MatrixSpec("thermal", 3456, 66528, "grid", "thermal problem"),
        MatrixSpec("t2dal", 4257, 20861, "banded", "model reduction"),
        MatrixSpec("ex19", 12005, 259879, "grid", "fluid dynamics"),
        MatrixSpec("epb1", 14743, 95053, "banded", "thermal problem"),
        MatrixSpec("af23560", 23560, 484256, "banded", "Navier-Stokes stability"),
        MatrixSpec("spmsrtls", 29995, 129971, "banded", "mathematical problem"),
        MatrixSpec("zhao1", 33861, 166453, "random", "electromagnetism"),
    ]
}


def _dedupe(n: int, row: np.ndarray, col: np.ndarray, rng: np.random.Generator) -> COO:
    key = row.astype(np.int64) * n + col
    _, idx = np.unique(key, return_index=True)
    row, col = row[idx], col[idx]
    val = rng.standard_normal(row.shape[0]).astype(np.float32)
    # Keep values away from 0 so allclose tests are meaningful.
    val = np.where(np.abs(val) < 0.1, 0.1, val)
    return COO((n, n), row.astype(np.int32), col.astype(np.int32), val)


def random_coo(n: int, nnz: int, seed: int = 0) -> COO:
    """Matrice quelconque: uniformly scattered non-zeros."""
    rng = np.random.default_rng(seed)
    # Oversample to survive dedupe.
    m = int(nnz * 1.3) + 16
    row = rng.integers(0, n, size=m, dtype=np.int64)
    col = rng.integers(0, n, size=m, dtype=np.int64)
    a = _dedupe(n, row, col, rng)
    return COO(a.shape, a.row[:nnz], a.col[:nnz], a.val[:nnz])


def banded_coo(n: int, nnz: int, seed: int = 0) -> COO:
    """Matrice bande: non-zeros clustered near the diagonal (half-width m)."""
    rng = np.random.default_rng(seed)
    half = max(1, int(np.ceil(nnz / (2.0 * n))) * 2)
    m = int(nnz * 1.4) + 16
    row = rng.integers(0, n, size=m, dtype=np.int64)
    off = rng.integers(-half, half + 1, size=m, dtype=np.int64)
    col = np.clip(row + off, 0, n - 1)
    a = _dedupe(n, row, col, rng)
    return COO(a.shape, a.row[:nnz], a.col[:nnz], a.val[:nnz])


def grid5_coo(n: int, nnz: int, seed: int = 0) -> COO:
    """5-point 2-D grid stencil (thermal / fluid problems), padded with
    random extra entries up to NNZ."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    rows, cols = [], []
    idx = np.arange(side * side).reshape(side, side)
    for di, dj in ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)):
        src = idx[max(0, -di) : side - max(0, di), max(0, -dj) : side - max(0, dj)]
        dst = idx[max(0, di) : side - max(0, -di), max(0, dj) : side - max(0, -dj)]
        rows.append(src.ravel())
        cols.append(dst.ravel())
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    keep = (row < n) & (col < n)
    row, col = row[keep], col[keep]
    if row.shape[0] < nnz:  # pad with random entries
        extra = nnz - row.shape[0]
        row = np.concatenate([row, rng.integers(0, n, size=2 * extra + 16)])
        col = np.concatenate([col, rng.integers(0, n, size=2 * extra + 16)])
    a = _dedupe(n, row.astype(np.int64), col.astype(np.int64), rng)
    return COO(a.shape, a.row[:nnz], a.col[:nnz], a.val[:nnz])


def diagonal_coo(n: int, nnz: int, seed: int = 0) -> COO:
    """Pure diagonal matrix (bcsstm09 is a diagonal mass matrix: NNZ == N)."""
    rng = np.random.default_rng(seed)
    k = min(n, nnz)
    idx = np.arange(k, dtype=np.int32)
    val = rng.standard_normal(k).astype(np.float32)
    val = np.where(np.abs(val) < 0.1, 0.1, val)
    return COO((n, n), idx, idx, val)


def powerlaw_coo(n: int, nnz: int, seed: int = 0) -> COO:
    """Power-law row/col degree distribution (web-link / electromagnetic
    style irregular matrices — e.g. the Google matrix of ch.1 §3.1)."""
    rng = np.random.default_rng(seed)
    m = int(nnz * 1.5) + 16
    # Zipf-ish marginals via pareto ranks.
    ranks = np.argsort(rng.pareto(1.5, size=n))
    p = 1.0 / (np.arange(1, n + 1) ** 0.8)
    p /= p.sum()
    row = ranks[rng.choice(n, size=m, p=p)]
    col = ranks[rng.choice(n, size=m, p=p)]
    a = _dedupe(n, row.astype(np.int64), col.astype(np.int64), rng)
    return COO(a.shape, a.row[:nnz], a.col[:nnz], a.val[:nnz])


_GENERATORS: Dict[str, Callable[[int, int, int], COO]] = {
    "random": random_coo,
    "banded": banded_coo,
    "grid": grid5_coo,
    "diagonal": diagonal_coo,
    "powerlaw": powerlaw_coo,
}


def generate(spec: MatrixSpec, seed: int = 0) -> COO:
    """Generate the synthetic stand-in for one paper matrix."""
    gen = _GENERATORS[spec.structure]
    a = gen(spec.n, spec.nnz, seed=seed)
    a.validate()
    return a


def generate_suite(seed: int = 0) -> Dict[str, COO]:
    return {name: generate(spec, seed) for name, spec in PAPER_SUITE.items()}
