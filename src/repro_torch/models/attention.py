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

On a device mesh (``ctx``) the core runs per shard through
``local_map``: every (sequence, head) is independent, so each rank takes
its batch shard and its query heads, with the block of K / V heads they
read, and runs the meshless core (:func:`_core`) on them. Left to DTensor,
the grouped view ``[B, S, KV, G, hd]`` of heads sharded finer than the K /
V heads has no placement, and on the multi-pod mesh the grouped einsum
merges a batch dim sharded over two mesh axes with a head dim sharded
over a third, whose redistribution planning does not finish. A decode
step runs per shard over the cache's own placements and writes its
shard in place; a cache sharded over the sequence combines the ranks'
softmax sums and partial outputs over that axis.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import functools

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ArchConfig
from repro_torch.models.common import Params, dense_init, project, rms_norm, rope
from repro_torch.models.mesh import MeshCtx, as_dtensor, wait, whole

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


def _core(q, k, v, *, causal: bool, window: int, chunk: int = 0) -> torch.Tensor:
    """The attention of q [B, S, H, hd] over k / v [B, T, KV, hd], query
    head ``i`` reading K / V head ``i // (H // KV)``: the grouped einsum,
    the mask and the softmax, or (``chunk`` > 0) the online softmax over
    KV chunks of that size. Returns [B, S, H, hd]."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q = q.reshape(b, s, kv, h // kv, hd)
    if chunk:
        return _chunked_core(q, k, v, causal=causal, window=window if window > 0 else None,
                             chunk=chunk, scale=1.0 / (hd**0.5)).reshape(b, s, h, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / (hd**0.5)
    m = _mask(s, t, causal, window, device=q.device)
    scores = torch.where(m[None, None, None], scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, hd)


def _block_core(q, k, v, *, kv_block: Optional[slice], **kw) -> torch.Tensor:
    """:func:`_core` of a rank's query heads over ``k`` / ``v``'s heads
    ``kv_block`` (all of them when None)."""
    if kv_block is not None:
        k, v = k[:, :, kv_block], v[:, :, kv_block]
    return _core(q, k, v, **kw)


def _on_mesh(q, k, v, cfg: ArchConfig, ctx: MeshCtx, *, causal: bool, window: int,
             chunk: int = 0) -> torch.Tensor:
    """:func:`_core` over the mesh: q [B, S, H, hd], k / v [B, T, KV, hd]
    DTensors → [B, S, H, hd], batch-sharded over the batch axes where it
    divides. The query heads shard over the model axis where they divide
    and a shard's heads read a contiguous block of K / V heads (one group
    size divides the other); the K / V heads shard with them where they
    divide too, else each rank takes its block of whole K / V (and its
    gradient of them is partial)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    ranks, m = ctx.model_ranks, ctx.model_axis
    hl, groups = h // ranks, h // kv
    batch = ctx.batch_shard(q.shape[0])
    q_heads = h % ranks == 0 and (hl % groups == 0 or groups % hl == 0)
    kv_heads = kv % ranks == 0
    kv_block = None
    if q_heads and not kv_heads:
        first = ctx.mesh.get_local_rank(m) * hl // groups
        kv_block = slice(first, first + max(hl // groups, 1))
        # Each rank's K / V gradient is partial (from its query heads).
        k, v = whole(k), whole(v)
    qpl = ctx.placements(batch=batch, **{m: Shard(2) if q_heads else Replicate()})
    kvpl = ctx.placements(batch=batch, **{m: Shard(2) if kv_heads else Replicate()})
    kv_grad = kvpl if kv_block is None else ctx.placements(batch=batch, **{m: Partial()})
    fn = functools.partial(_block_core, kv_block=kv_block, causal=causal, window=window,
                           chunk=chunk)
    return local_map(fn, out_placements=list(qpl), in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kv_grad, kv_grad), device_mesh=ctx.mesh,
                     redistribute_inputs=True)(q, k, v)


def attention(
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    cfg: ArchConfig,
    *,
    causal: bool = True,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    ctx: Optional[MeshCtx] = None,
) -> torch.Tensor:
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions)
    chunk = cfg.attn_chunk if cfg.chunked_attn and s >= 2 * cfg.attn_chunk else 0
    if ctx is not None and ctx.mesh is not None:
        o = _on_mesh(q, k, v, cfg, ctx, causal=causal, window=window, chunk=chunk)
    else:
        o = _core(q, k, v, causal=causal, window=window, chunk=chunk)
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


def _decode_core(q, k_new, v_new, ck, cv, *, pos: int, t: int, window: int, t_first: int = 0,
                 group=None) -> torch.Tensor:
    """Write the new K / V into the cache slots ``[t_first, t_first +
    ck.shape[1])`` of a T-slot cache where slot ``pos % t`` lies among
    them, then attend q [B, 1, H, hd] over those slots. With ``group``
    (the ranks that hold the other slots) the softmax's max and sum and
    the output are combined over it; without, they are this rank's."""
    b, _, h, hd = q.shape
    tl, kv = ck.shape[1], ck.shape[2]
    w_idx = pos % t - t_first
    if 0 <= w_idx < tl:
        ck[:, w_idx] = k_new[:, 0]
        cv[:, w_idx] = v_new[:, 0]
    q = q.reshape(b, 1, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, ck) / (hd**0.5)
    cols = t_first + torch.arange(tl, device=q.device)
    p_col = pos - torch.remainder(pos - cols, t)  # absolute position per slot
    valid = p_col >= 0
    if window > 0:
        valid &= pos - p_col <= window
    scores = torch.where(valid, scores.float(), NEG_INF)
    if group is None:
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bkgst,btkd->bskgd", w, cv).reshape(b, 1, h, hd)
    top = wait(funcol.all_reduce(scores.amax(dim=-1, keepdim=True), "max", group))
    e = torch.exp(scores - top)
    w = (e / wait(funcol.all_reduce(e.sum(dim=-1, keepdim=True), "sum", group))).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, cv).reshape(b, 1, h, hd)
    return wait(funcol.all_reduce(o, "sum", group))


def _decode_on_mesh(q, k_new, v_new, cache: KVCache, ctx: MeshCtx, *,
                    window: int) -> torch.Tensor:
    """:func:`_decode_core` over the mesh, on the cache's own placements
    (so each rank writes its shard in place): q and the new K / V take
    the cache's batch and head shards and are whole along a mesh axis
    that shards the cache's sequence, over which the softmax combines."""
    ck, cv = as_dtensor(cache.k, ctx), as_dtensor(cache.v, ctx)
    cpl = ck.placements
    qpl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in cpl)
    seq = [i for i, p in enumerate(cpl) if p.is_shard(1)]
    if len(seq) > 1:
        raise ValueError(f"a cache sharded over its sequence on more than one mesh axis: {cpl}")
    t, t_first, group = ck.shape[1], 0, None
    if seq:
        t_first = ctx.mesh.get_local_rank(seq[0]) * (t // ctx.mesh.size(seq[0]))
        group = ctx.mesh.get_group(seq[0])
    fn = functools.partial(_decode_core, pos=cache.length, t=t, window=window, t_first=t_first,
                           group=group)
    return local_map(fn, out_placements=list(qpl), in_placements=(qpl, qpl, qpl, cpl, cpl),
                     device_mesh=ctx.mesh, redistribute_inputs=True)(q, k_new, v_new, ck, cv)


def decode_attention(
    p: Params,
    x: torch.Tensor,  # [B, 1, D] — one new token
    cache: KVCache,
    cfg: ArchConfig,
    *,
    window: int = 0,
    ctx: Optional[MeshCtx] = None,
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
    pos = cache.length
    positions = torch.full((b, 1), pos, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    if ctx is not None and ctx.mesh is not None:
        o = _decode_on_mesh(q, k_new, v_new, cache, ctx, window=window)
    else:
        o = _decode_core(q, k_new, v_new, cache.k, cache.v, pos=pos, t=cache.k.shape[1],
                         window=window)
    out = project(o, p["wo"], 2)
    return out, KVCache(k=cache.k, v=cache.v, length=pos + 1)


def cross_attention(
    p: Params,
    x: torch.Tensor,  # [B, S, D] decoder states
    mem: torch.Tensor,  # [B, T, D] encoder states
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> torch.Tensor:
    """Decoder queries over the encoder's states: no mask (an all-true
    one), no rope, no qk-norm, as in the reference. K and V are projected
    from ``mem`` at every call."""
    q = project(x, p["wq"])
    k = project(mem, p["wk"])
    v = project(mem, p["wv"])
    if ctx is not None and ctx.mesh is not None:
        o = _on_mesh(q, k, v, cfg, ctx, causal=False, window=0)
    else:
        o = _core(q, k, v, causal=False, window=0)
    return project(o, p["wo"], 2)
