"""Plain PyTorch version of the flash attention kernel.

The same function as ``csrc/flash_attention.cu``, for tensors on the CPU
(the wrapper in :mod:`repro_torch.kernels.attn.ops` takes it only there)
and as the kernel's yardstick on the card: the torch form of the JAX
package's oracle ``repro/kernels/attn/ref.py::attention_ref``. It builds
the whole ``[BH, S, T]`` float32 score tensor.
"""
from __future__ import annotations

import torch

__all__ = ["attention_plain", "attention_mask"]


def attention_mask(s: int, t: int, *, causal: bool, window: int, device=None) -> torch.Tensor:
    """``[S, T]`` bool: key t is visible from query s when (not causal or
    s >= t) and (window <= 0 or s - t <= window) — the one-sided window
    of ``repro/models/attention.py::_mask``, keys indexed from 0."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= rows >= cols
    if window > 0:
        mask &= rows - cols <= window
    return mask


def attention_plain(
    q: torch.Tensor,  # [BH, S, D]
    k: torch.Tensor,  # [BH, T, D]
    v: torch.Tensor,  # [BH, T, D]
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Softmax attention in float32 with masked scores set to -1e30,
    returned in q's type."""
    d = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / (d**0.5)
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                          device=q.device)
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)
