"""HPCG's problem (``GenerateProblem_ref.cpp``): the 27-point stencil on
an nx × ny × nz grid, 26 on the diagonal and −1 for every neighbour in
the grid, row ``ix + nx·(iy + ny·iz)``. It has no random entries."""
from __future__ import annotations

import numpy as np

from portbench.matrices import Matrix

# A CPU test's grid: 210 rows, every kind of boundary row.
TINY = {"nx": 6, "ny": 7, "nz": 5}


def stencil27(nx: int, ny: int, nz: int) -> Matrix:
    n = nx * ny * nz
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                      & (jz >= 0) & (jz < nz))
                src = np.nonzero(ok)[0]
                rows.append(src)
                cols.append(jx[ok] + nx * (jy[ok] + ny * jz[ok]))
                diag = dx == 0 and dy == 0 and dz == 0
                vals.append(np.full(src.shape[0], 26.0 if diag else -1.0, np.float32))
    return Matrix(n, np.concatenate(rows).astype(np.int32),
                  np.concatenate(cols).astype(np.int32), np.concatenate(vals))


def graphs(config: dict, seed: int) -> dict:
    return {"a": stencil27(config["nx"], config["ny"], config["nz"])}
