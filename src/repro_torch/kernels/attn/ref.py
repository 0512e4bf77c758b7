"""Plain PyTorch version of the flash attention kernel.

The same function as ``csrc/flash_attention.cu``, for tensors on the CPU
(the wrapper in :mod:`repro_torch.kernels.attn.ops` takes it only there)
and as the kernel's yardstick on the card: the torch form of the JAX
package's oracle ``repro/kernels/attn/ref.py::attention_ref``. It builds
the whole ``[BH, S, T]`` float32 score tensor.

Given the kernel's tiles ``bq`` and ``bkv`` it computes what the tiled
kernels compute, the Pallas one included: a key whose ``bkv`` tile the
row's ``bq`` tile does not visit (:func:`tile_visits`) drops out of that
row's softmax, so a row whose visited keys are all masked averages v over
those keys, and a row with no visited key is 0.
"""
from __future__ import annotations

import torch

__all__ = ["attention_plain", "attention_mask", "tile_visits"]


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


def tile_visits(s: int, t: int, *, causal: bool, window: int, bq: int, bkv: int,
                device=None) -> torch.Tensor:
    """``[S // bq, T // bkv]`` bool: the (bq × bkv) tiles of one ``[S, T]``
    score matrix that the kernels visit, those with a visible pair by the
    reference's tile test (``repro/kernels/attn/kernel.py:57-63``)."""
    q_start = torch.arange(s // bq, device=device)[:, None] * bq
    k_start = torch.arange(t // bkv, device=device)[None, :] * bkv
    needed = torch.ones((s // bq, t // bkv), dtype=torch.bool, device=device)
    if causal:
        needed &= q_start + bq - 1 >= k_start
    if window > 0:
        needed &= q_start <= k_start + bkv - 1 + window
    return needed


def attention_plain(
    q: torch.Tensor,  # [BH, S, D]
    k: torch.Tensor,  # [BH, T, D]
    v: torch.Tensor,  # [BH, T, D]
    *,
    causal: bool = True,
    window: int = 0,
    bq: int | None = None,
    bkv: int | None = None,
) -> torch.Tensor:
    """Softmax attention in float32 with masked scores set to -1e30,
    returned in q's type. With ``bq`` and ``bkv`` both None it is the dense
    oracle; with both given, keys of tiles the row's tile does not visit
    carry no weight (a row with no visited key is 0), as in the kernels."""
    if (bq is None) != (bkv is None):
        raise ValueError("give both bq and bkv, or neither")
    d = q.shape[-1]
    n_q, n_k = q.shape[1], k.shape[1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / (d**0.5)
    mask = attention_mask(n_q, n_k, causal=causal, window=window, device=q.device)
    s = s.masked_fill(~mask[None], -1e30)
    if bq is None:
        p = torch.softmax(s, dim=-1)
    else:
        if bq <= 0 or bkv <= 0 or n_q % bq or n_k % bkv:
            raise ValueError(f"S={n_q} and T={n_k} must be multiples of bq={bq} and bkv={bkv}")
        visit = tile_visits(n_q, n_k, causal=causal, window=window, bq=bq, bkv=bkv,
                            device=q.device)
        visit = visit.repeat_interleave(bq, 0).repeat_interleave(bkv, 1)  # [S, T]
        p = torch.softmax(s.masked_fill(~visit[None], float("-inf")), dim=-1)
        p = p.masked_fill(~visit.any(dim=1)[None, :, None], 0.0)  # no visited key: 0, not NaN
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)
