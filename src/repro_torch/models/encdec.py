"""Encoder-decoder backbone (seamless-m4t family).

The audio frontend is a stub: the batch's ``frontend_embeds`` are
precomputed frame embeddings [B, T_enc, D]. The encoder is
bidirectional; the decoder has causal self-attention and
cross-attention over the encoder's output. A decode step keeps a
self-attention KV cache beside the (static) encoder memory.

The JAX package's ``encdec`` module on the port's weights: one
:class:`Params` module per block in ``enc_layers`` and ``dec_layers``,
where the reference stacks each list ``[L, ...]`` and scans over it.
Neither path calls a kernel of the port, as the reference's calls no
Pallas kernel.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import Params, embed_init, rms_norm
from repro_torch.models.mesh import MeshCtx, embed_lookup, mesh_scope
from repro_torch.models.transformer import REMAT, _dtype, _logits, init_mlp, mlp, padded_vocab

__all__ = [
    "init_encdec",
    "encdec_forward",
    "encode",
    "encdec_decode_step",
    "init_encdec_state",
    "EncDecState",
]


def _norm(cfg: ArchConfig, dtype, device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def _init_enc_layer(generator: torch.Generator, cfg: ArchConfig, dtype, device=None) -> Params:
    return Params({
        "norm1": _norm(cfg, dtype, device),
        "attn": attn_mod.init_attn(generator, cfg, dtype, device),
        "norm2": _norm(cfg, dtype, device),
        "mlp": init_mlp(generator, cfg, dtype, device),
    })


def _init_dec_layer(generator: torch.Generator, cfg: ArchConfig, dtype, device=None) -> Params:
    return Params({
        "norm1": _norm(cfg, dtype, device),
        "attn": attn_mod.init_attn(generator, cfg, dtype, device),
        "norm_x": _norm(cfg, dtype, device),
        "xattn": attn_mod.init_attn(generator, cfg, dtype, device),
        "norm2": _norm(cfg, dtype, device),
        "mlp": init_mlp(generator, cfg, dtype, device),
    })


def init_encdec(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """Weights drawn from ``generator`` (on its device) and placed on
    ``device``: the embedding, the encoder's blocks, then the decoder's."""
    dtype = _dtype(cfg)
    embed = embed_init(generator, padded_vocab(cfg), cfg.d_model, dtype, device)
    dev = embed.device
    return Params({
        "embed": embed,
        "enc_layers": [_init_enc_layer(generator, cfg, dtype, dev)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [_init_dec_layer(generator, cfg, dtype, dev)
                       for _ in range(cfg.num_layers)],
        "enc_norm": _norm(cfg, dtype, dev),
        "final_norm": _norm(cfg, dtype, dev),
    })


def encode(params: Params, frames, cfg: ArchConfig, ctx: Optional[MeshCtx] = None
           ) -> torch.Tensor:
    """frames: precomputed frontend embeddings [B, T, D] (a tensor or a
    numpy array), cast to the model's type on the weights' device."""
    x = torch.as_tensor(frames, device=params["embed"].device).to(_dtype(cfg))
    for lp in params["enc_layers"]:
        a = attn_mod.attention(lp["attn"], rms_norm(x, lp["norm1"], cfg.norm_eps), cfg,
                               causal=False, ctx=ctx)
        x = x + a
        x = x + mlp(lp["mlp"], rms_norm(x, lp["norm2"], cfg.norm_eps))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(h: torch.Tensor, lp: Params, mem: torch.Tensor, cfg: ArchConfig,
               ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    a = attn_mod.attention(lp["attn"], rms_norm(h, lp["norm1"], cfg.norm_eps), cfg, causal=True,
                           ctx=ctx)
    h = h + a
    c = attn_mod.cross_attention(lp["xattn"], rms_norm(h, lp["norm_x"], cfg.norm_eps), mem, cfg,
                                 ctx)
    h = h + c
    return h + mlp(lp["mlp"], rms_norm(h, lp["norm2"], cfg.norm_eps))


def encdec_forward(
    params: Params,
    batch: Dict[str, object],
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
    *,
    remat: str = "none",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: (logits [B, S, V], a float32 zero for the
    aux loss). ``remat="full"`` recomputes each decoder block in the
    backward pass; the encoder is never recomputed. ``remat="dots"``
    changes nothing here: the reference wraps its decoder scan for
    ``"full"`` alone."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: expected one of {REMAT}")
    block = _dec_block
    if remat == "full" and torch.is_grad_enabled():
        # The blocks draw no random numbers: there is no RNG state to replay.
        block = functools.partial(checkpoint, _dec_block, use_reentrant=False,
                                  preserve_rng_state=False)
    with mesh_scope(ctx):
        mem = encode(params, batch["frontend_embeds"], cfg, ctx)
        embed = params["embed"]
        x = embed_lookup(embed, batch["tokens"], ctx)
        for lp in params["dec_layers"]:
            x = block(x, lp, mem, cfg, ctx)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _logits(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


class EncDecState(NamedTuple):
    """The encoder's output and the decoder's stacked self-attention
    caches. A decode step writes the caches in place and returns a state
    over the same tensors with ``pos + 1``: a state is not shared between
    two decoders."""

    mem: torch.Tensor  # [B, T_enc, D] encoder output (static during decode)
    kv_k: torch.Tensor  # [L, B, T, KV, hd]
    kv_v: torch.Tensor
    pos: int  # host integer: no device read per step


@torch.no_grad()
def init_encdec_state(params: Params, frames, cfg: ArchConfig, max_len: int) -> EncDecState:
    """Encodes ``frames`` once and makes empty caches of ``max_len``
    positions on the weights' device."""
    mem = encode(params, frames, cfg)
    shape = (cfg.num_layers, mem.shape[0], max_len, cfg.num_kv_heads, cfg.hd)
    return EncDecState(
        mem=mem,
        kv_k=torch.zeros(shape, dtype=_dtype(cfg), device=mem.device),
        kv_v=torch.zeros(shape, dtype=_dtype(cfg), device=mem.device),
        pos=0,
    )


@torch.no_grad()
def encdec_decode_step(
    params: Params,
    tokens,  # [B, 1] integer, tensor or numpy
    state: EncDecState,
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, EncDecState]:
    """One decode step: (logits [B, V], the state at ``pos + 1``). The
    cross-attention's K and V are projected from ``mem`` again at every
    step, as the reference does."""
    with mesh_scope(ctx):
        embed = params["embed"]
        x = embed_lookup(embed, tokens, ctx)
        for i, lp in enumerate(params["dec_layers"]):
            kvc = attn_mod.KVCache(k=state.kv_k[i], v=state.kv_v[i], length=state.pos)
            a, _ = attn_mod.decode_attention(lp["attn"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                                             kvc, cfg, ctx=ctx)
            x = x + a
            c = attn_mod.cross_attention(lp["xattn"], rms_norm(x, lp["norm_x"], cfg.norm_eps),
                                         state.mem, cfg, ctx)
            x = x + c
            x = x + mlp(lp["mlp"], rms_norm(x, lp["norm2"], cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _logits(params, x, cfg)[:, 0], state._replace(pos=state.pos + 1)
