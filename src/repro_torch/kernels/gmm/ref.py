"""Plain PyTorch version of the grouped matmul kernel.

The same function as ``csrc/gmm.cu``, for tensors on the CPU (the
wrapper in :mod:`repro_torch.kernels.gmm.ops` takes it only there) and
as the kernel's yardstick on the card: the torch form of the JAX
package's oracle ``repro/kernels/gmm/ref.py::gmm_ref``.
"""
from __future__ import annotations

import torch

__all__ = ["gmm_plain"]


def gmm_plain(
    x: torch.Tensor,  # [M, K]
    w: torch.Tensor,  # [E, K, N]
    group_of_tile: torch.Tensor,  # [M // bm]
    *,
    bm: int = 128,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``out[tile i] = x[tile i] @ w[group_of_tile[i]]`` as ``[M, N]``
    ``out_dtype``: each ``bm``-row tile of ``x`` times its group's
    weights, in float32, rounded to ``out_dtype`` once at the end."""
    m, k = x.shape
    tiles = x.reshape(m // bm, bm, k)
    w_sel = w[group_of_tile.long()]  # [m_tiles, K, N]
    out = torch.einsum("tmk,tkn->tmn", tiles.float(), w_sel.float())
    return out.reshape(m, w.shape[-1]).to(out_dtype)
