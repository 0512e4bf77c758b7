"""Plain PyTorch version of the stacked Block-ELL SpMM kernel.

The same function as ``csrc/bell_spmm.cu``, for tensors on the CPU (the
wrapper in :mod:`repro_torch.kernels.spmv.ops` takes it only there) and
as the kernel's yardstick on the card. It is written as the
bn-unrolled broadcast sum of the JAX package's CPU path
(``repro/pmvc/dist.py::_unit_spmm``), not as a batched matmul: every
operation is elementwise over the batch axis, so column b of the result
does not depend on the batch width B.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bell_spmm_plain"]


def bell_spmm_plain(
    tiles: torch.Tensor,  # [U, T, bm, bn]
    tile_row: torch.Tensor,  # [U, T] global block-row
    tile_src: torch.Tensor,  # [U, T] index into the unit's x source
    counts: np.ndarray,  # [U] real tiles per unit
    xsrc: torch.Tensor,  # [U or 1, S, bn, B]
    nrb: int,
) -> torch.Tensor:
    """``out[u, r] = Σ_{t < counts[u], tile_row[u, t] = r} tiles[u, t] @
    xsrc[u or 0, tile_src[u, t]]`` as ``[U, NRB, bm, B]`` float32, the
    real tiles added in index order."""
    u_n, _, bm, bn = tiles.shape
    out = torch.zeros(
        (u_n, nrb, bm, xsrc.shape[-1]), dtype=torch.float32, device=tiles.device
    )
    for u in range(u_n):
        c = int(counts[u])
        if c == 0:
            continue
        t = tiles[u, :c].float()  # [c, bm, bn]
        xs = xsrc[u if xsrc.shape[0] > 1 else 0][tile_src[u, :c].long()].float()
        contribs = t[..., 0, None] * xs[:, None, 0, :]  # [c, bm, B]
        for n in range(1, bn):
            contribs = contribs + t[..., n, None] * xs[:, None, n, :]
        out[u].index_add_(0, tile_row[u, :c].long(), contribs)
    return out
