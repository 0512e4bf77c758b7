"""GQA/MQA attention with qk-norm, sliding-window, decode and
encoder-decoder cross-attention paths.

The JAX package's attention as plain PyTorch products: einsums (the
projections through :func:`project`) and a masked softmax, or, for long sequences with ``chunked_attn``, an online
softmax over KV chunks. It calls neither the port's attention kernel nor
``scaled_dot_product_attention``, as the reference calls no Pallas
kernel here. The order of the casts is the reference's: the scores are
formed and divided by √hd in the input type, then cast to float32,
masked with the finite ``NEG_INF`` and normalised, then cast back.

A decode step writes its new K and V into the cache it is given, in
place, at slot ``pos % T``; ``pos`` is a host integer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models.common import Params, dense_init, project, rms_norm, rope

__all__ = [
    "init_attn",
    "attention",
    "decode_attention",
    "cross_attention",
    "KVCache",
    "init_kv_cache",
    "kv_cache_len",
]

NEG_INF = -1e30


def init_attn(generator: torch.Generator, cfg: ArchConfig, dtype, device=None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": dense_init(generator, (d, h, hd), fan_in=d, dtype=dtype, device=device),
        "wk": dense_init(generator, (d, kv, hd), fan_in=d, dtype=dtype, device=device),
        "wv": dense_init(generator, (d, kv, hd), fan_in=d, dtype=dtype, device=device),
        "wo": dense_init(generator, (h, hd, d), fan_in=h * hd, dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return Params(p)


def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    q = project(x, p["wq"])
    k = project(x, p["wk"])
    v = project(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(s: int, t: int, causal: bool, window: int, offset: int = 0,
          device=None) -> torch.Tensor:
    rows = offset + torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    m = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        m &= rows >= cols
    if window > 0:
        m &= rows - cols <= window
    return m


def _chunked_core(
    q: torch.Tensor,  # [B, S, KV, G, hd]
    k: torch.Tensor,  # [B, T, KV, hd]
    v: torch.Tensor,  # [B, T, KV, hd]
    *,
    causal: bool,
    window: Optional[int],  # None or <= 0 = full
    chunk: int,
    scale: float,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks in ascending order: peak
    score memory O(S·chunk) instead of O(S·T). The reference scans the
    chunks with ``lax.scan``; here a Python loop carries the same state."""
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    t_real = t
    if t % chunk:  # pad KV to a chunk multiple; padding masked out below
        pad = chunk - t % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        t = t + pad
    nc = t // chunk
    rows = torch.arange(s, device=q.device)[:, None]

    m_prev = torch.full((b, kvh, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l_prev = torch.zeros((b, kvh, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, s, hd), dtype=torch.float32, device=q.device)
    for j in range(nc):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        sc = torch.einsum("bskgd,btkd->bkgst", q, kj).float() * scale
        cols = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = cols < t_real  # KV padding is never attended
        if causal:
            mask = mask & (rows >= cols)
        if window is not None and window > 0:
            mask = mask & (rows - cols <= window)
        sc = torch.where(mask[None, None, None], sc, NEG_INF)
        m_cur = torch.amax(sc, dim=-1)
        m_new = torch.maximum(m_prev, m_cur)
        p_ = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l_prev = l_prev * alpha + p_.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p_.to(vj.dtype), vj
        ).float()
        m_prev = m_new
    out = acc / torch.clamp(l_prev, min=1e-30)[..., None]
    # [B,KV,G,S,hd] -> [B,S,KV,G,hd]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def attention(
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    cfg: ArchConfig,
    *,
    causal: bool = True,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    b, s, _ = x.shape
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions)
    groups = h // kv
    q = q.reshape(b, s, kv, groups, cfg.hd)
    if cfg.chunked_attn and s >= 2 * cfg.attn_chunk:
        o = _chunked_core(
            q, k, v, causal=causal, window=window if window > 0 else None,
            chunk=cfg.attn_chunk, scale=1.0 / (cfg.hd**0.5),
        ).reshape(b, s, h, cfg.hd)
        return project(o, p["wo"], 2)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / (cfg.hd**0.5)
    m = _mask(s, s, causal, window, device=x.device)
    scores = torch.where(m[None, None, None], scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, cfg.hd)
    return project(o, p["wo"], 2)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, T, KV, hd]
    v: torch.Tensor  # [B, T, KV, hd]
    length: int  # position of the next token (host integer)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=0,
    )


def kv_cache_len(cfg: ArchConfig, max_len: int) -> int:
    """Uniform-SWA archs keep a ring buffer of window+1 slots — constant
    decode memory, which is what makes long_500k feasible for them."""
    if cfg.window > 0 and cfg.global_attn_every == 0:
        return min(max_len, cfg.window + 1)
    return max_len


def decode_attention(
    p: Params,
    x: torch.Tensor,  # [B, 1, D] — one new token
    cache: KVCache,
    cfg: ArchConfig,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, KVCache]:
    """One-token attention over a (possibly ring-buffered) KV cache.

    Slot ``i`` of a T-slot cache holds absolute position
    ``p_i = pos - ((pos - i) mod T)``, the mod a floor mod
    (``torch.remainder``: ``pos - i`` is negative until the cache fills);
    for a full cache (T > pos) this is the identity for i ≤ pos and
    invalid otherwise, so the same masking covers both the ring and the
    plain case. The new K and V are written into ``cache.k`` and
    ``cache.v`` in place; the returned cache holds the same tensors.
    """
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    pos = cache.length
    positions = torch.full((b, 1), pos, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    t = cache.k.shape[1]
    w_idx = pos % t
    cache.k[:, w_idx] = k_new[:, 0]
    cache.v[:, w_idx] = v_new[:, 0]

    groups = h // kv
    q = q.reshape(b, 1, kv, groups, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, cache.k) / (hd**0.5)
    cols = torch.arange(t, device=x.device)
    p_col = pos - torch.remainder(pos - cols, t)  # absolute position per slot
    valid = p_col >= 0
    if window > 0:
        valid &= pos - p_col <= window
    scores = torch.where(valid, scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, cache.v).reshape(b, 1, h, hd)
    out = project(o, p["wo"], 2)
    return out, KVCache(k=cache.k, v=cache.v, length=pos + 1)


def cross_attention(
    p: Params,
    x: torch.Tensor,  # [B, S, D] decoder states
    mem: torch.Tensor,  # [B, T, D] encoder states
    cfg: ArchConfig,
) -> torch.Tensor:
    """Decoder queries over the encoder's states: no mask, no rope, no
    qk-norm, as in the reference. K and V are projected from ``mem`` at
    every call."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = project(x, p["wq"])
    k = project(mem, p["wk"])
    v = project(mem, p["wv"])
    groups = h // kv
    q = q.reshape(b, s, kv, groups, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / (hd**0.5)
    w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, hd)
    return project(o, p["wo"], 2)
