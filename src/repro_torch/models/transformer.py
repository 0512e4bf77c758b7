"""Decoder-only LM assembly: the dense, VLM, MoE, SSM and hybrid families.

The JAX package stacks the layers' parameters and scans one generic
block over them; the port keeps one :class:`Params` module per block in
an ``nn.ModuleList`` and loops over it, with the per-layer windows as
host integers. With host windows the reference's dynamic-window helpers
(``_attention_dynwin``, ``_decode_attention_dynwin``) are plain
:func:`attention` and :func:`decode_attention` calls.

**On a mesh** (a :class:`MeshCtx` over a ``DeviceMesh``) the weights and
the batch are DTensors placed by :mod:`repro_torch.launch.shardings`,
and the entry points run under :func:`~repro_torch.models.moe.mesh_scope`:
DTensor propagates the shardings through the projections and norms, as
GSPMD does for the reference; the attention, the decode step and the SSD
run their meshless cores per shard and the MoE layer its expert-parallel
branches, through ``local_map``. The
reference's ``act_anchor`` (``with_sharding_constraint``) is
:func:`_anchor`, a redistribution of the residual stream.

``remat`` recomputes in the backward pass what the reference's
``jax.checkpoint`` of its scan body recomputes: ``"full"`` is
``torch.utils.checkpoint`` around each block, ``"dots"`` saves the
products without a batch dimension (each block's projections, one
``aten.mm`` each through :func:`project`) and recomputes the rest, as
``checkpoint_dots_with_no_batch_dims`` does.

Families:
  dense  : attn + SwiGLU MLP (also the VLM backbone, with frontend
           embeddings prepended)
  moe    : attn + MoE FFN (repro_torch.models.moe), whose load-balance
           loss is summed over the layers
  ssm    : Mamba-2 SSD block only
  hybrid : parallel attn(SWA) ‖ SSD heads + MLP (Hymba-style)
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    Params,
    dense_init,
    embed_init,
    project,
    rms_norm,
)
from repro_torch.models.mesh import MeshCtx, as_dtensor, embed_lookup, mesh_scope

__all__ = ["init_lm", "lm_forward", "lm_decode_step", "init_decode_state", "DecodeState"]

REMAT = ("none", "full", "dots")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def padded_vocab(cfg: ArchConfig) -> int:
    """Embedding rows, optionally padded to a multiple (vocab_pad_to)."""
    v = cfg.vocab_size
    if cfg.vocab_pad_to > 1:
        v = -(-v // cfg.vocab_pad_to) * cfg.vocab_pad_to
    return v


def init_mlp(generator: torch.Generator, cfg: ArchConfig, dtype, device=None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return Params({
        "w_gate": dense_init(generator, (d, f), fan_in=d, dtype=dtype, device=device),
        "w_up": dense_init(generator, (d, f), fan_in=d, dtype=dtype, device=device),
        "w_down": dense_init(generator, (f, d), fan_in=f, dtype=dtype, device=device),
    })


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(project(x, p["w_gate"]))
    u = project(x, p["w_up"])
    return project(h * u, p["w_down"])


def _init_layer(generator: torch.Generator, cfg: ArchConfig, dtype, device=None) -> Params:
    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=device)

    p = {"norm1": ones()}
    if cfg.family != "ssm":
        p["attn"] = attn_mod.init_attn(generator, cfg, dtype, device)
        p["norm2"] = ones()
    if cfg.family == "ssm":
        p["ssm"] = ssm_mod.init_ssm(generator, cfg, dtype, device)
    elif cfg.family == "hybrid":
        p["ssm"] = ssm_mod.init_ssm(generator, cfg, dtype, device)
        p["beta_attn"] = ones()
        p["beta_ssm"] = ones()
        p["mlp"] = init_mlp(generator, cfg, dtype, device)
    elif cfg.is_moe:
        p["moe"] = moe_mod.init_moe(generator, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(generator, cfg, dtype, device)
    return Params(p)


def init_lm(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """Weights drawn from ``generator`` (on its device) and placed on
    ``device``: the embedding, the layers in order, then the head."""
    dtype = _dtype(cfg)
    embed = embed_init(generator, padded_vocab(cfg), cfg.d_model, dtype, device)
    params = {
        "embed": embed,
        "layers": [_init_layer(generator, cfg, dtype, device) for _ in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=embed.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), fan_in=cfg.d_model, dtype=dtype,
            device=device,
        )
    return Params(params)


def _layer_windows(cfg: ArchConfig) -> List[int]:
    """Per-layer window size (0 = full attention)."""
    if cfg.global_attn_every > 0 and cfg.window > 0:
        return [0 if i % cfg.global_attn_every == 0 else cfg.window
                for i in range(cfg.num_layers)]
    return [cfg.window] * cfg.num_layers


def _anchor(x: torch.Tensor, cfg: ArchConfig, ctx: Optional[MeshCtx]) -> torch.Tensor:
    """§Perf `act_anchor`: pin the residual stream to batch-sharded /
    model-replicated layout, so that no op drifts into resharding [B,S,D]
    activations between layers (the reference's
    ``with_sharding_constraint``). Without a mesh, the identity."""
    if not cfg.act_anchor or ctx is None or ctx.mesh is None:
        return x
    return as_dtensor(x, ctx).redistribute(ctx.mesh, ctx.placements(batch=Shard(0)))


def _block(
    x: torch.Tensor,
    lp: Params,
    win: int,
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One residual block with the layer's window ``win``. Returns (x,
    the MoE load-balance loss, or None for the other families)."""
    x = _anchor(x, cfg, ctx)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + ssm_mod.ssm_forward(lp["ssm"], h, cfg, ctx), None

    if cfg.family == "hybrid":
        a_out = attn_mod.attention(lp["attn"], h, cfg, causal=True, window=win, ctx=ctx)
        s_out = ssm_mod.ssm_forward(lp["ssm"], h, cfg, ctx)
        mix = 0.5 * (
            rms_norm(a_out, lp["beta_attn"], cfg.norm_eps)
            + rms_norm(s_out, lp["beta_ssm"], cfg.norm_eps)
        )
        x = x + mix
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + mlp(lp["mlp"], h2), None

    a_out = attn_mod.attention(lp["attn"], h, cfg, causal=True, window=cfg.window,
                              ctx=ctx)
    x = x + a_out
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_mod.moe_ffn(lp["moe"], h2, cfg, ctx)
        return x + y, aux
    return x + mlp(lp["mlp"], h2), None


def _save_projections(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the products without a batch dimension (the
    port runs exactly those as ``aten.mm``), recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(remat: str):
    """``_block``, recomputed in the backward pass as ``remat`` says."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: expected one of {REMAT}")
    if remat == "none" or not torch.is_grad_enabled():
        return _block
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_projections)
    # The blocks draw no random numbers: there is no RNG state to replay.
    return functools.partial(checkpoint, _block, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _embed_inputs(params: Params, batch: Dict[str, object], cfg: ArchConfig,
                  ctx: Optional[MeshCtx] = None):
    """Token embeddings, with optional frontend-stub embeddings prepended
    (VLM patches arrive precomputed). ``batch`` holds tensors or numpy
    arrays; they are moved to the weights' device."""
    embed = params["embed"]
    x = embed_lookup(embed, batch["tokens"], ctx)
    n_front = 0
    if cfg.frontend and "frontend_embeds" in batch:
        fe = torch.as_tensor(batch["frontend_embeds"], device=embed.device).to(x.dtype)
        x = torch.cat([fe, x], dim=1)
        n_front = fe.shape[1]
    return x, n_front


def _logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, head)
    return logits[..., : cfg.vocab_size]


def lm_forward(
    params: Params,
    batch: Dict[str, object],
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
    *,
    remat: str = "none",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B,S,V], aux_loss); the aux
    loss is the MoE load-balance term summed over the layers, zero for
    the other families. ``ctx`` holds the mesh, if any (see the module's
    docstring). ``remat`` is one of ``REMAT`` and only matters when
    autograd records the call."""
    block = _remat_block(remat)
    with mesh_scope(ctx):
        x, n_front = _embed_inputs(params, batch, cfg, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, win in zip(params["layers"], _layer_windows(cfg)):
            x, a = block(x, lp, win, cfg, ctx)
            if a is not None:
                aux = aux + a
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if n_front:
            x = x[:, n_front:]
        return _logits(params, x, cfg), aux


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Stacked per-layer caches ([L, ...] leading axis) + shared position.

    A decode step writes the caches in place and returns a state over the
    same tensors with ``pos + 1``: a state is not shared between two
    decoders."""

    kv_k: Optional[torch.Tensor]  # [L, B, T, KV, hd]
    kv_v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]  # [L, B, cw-1, Din]
    ssm: Optional[torch.Tensor]  # [L, B, H, P, N]
    pos: int  # host integer: no device read per step


def init_decode_state(
    cfg: ArchConfig, batch: int, max_len: int, device=None
) -> DecodeState:
    dtype = _dtype(cfg)
    n = cfg.num_layers
    kv_k = kv_v = conv = ssm_st = None
    if cfg.family != "ssm":
        t = attn_mod.kv_cache_len(cfg, max_len)
        shape = (n, batch, t, cfg.num_kv_heads, cfg.hd)
        kv_k = torch.zeros(shape, dtype=dtype, device=device)
        kv_v = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.family in ("ssm", "hybrid"):
        conv = torch.zeros((n, batch, cfg.conv_width - 1, cfg.d_inner), dtype=dtype,
                           device=device)
        ssm_st = torch.zeros(
            (n, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device,
        )
    return DecodeState(kv_k, kv_v, conv, ssm_st, 0)


def _decode_block(
    x: torch.Tensor,
    lp: Params,
    cache: Dict[str, torch.Tensor],
    win: int,
    pos: int,
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> torch.Tensor:
    """One block of a decode step; ``cache`` holds this layer's views of
    the stacked caches, which it updates in place."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        sc = ssm_mod.SsmCache(conv=cache["conv"], state=cache["ssm"])
        out, sc = ssm_mod.ssm_decode_step(lp["ssm"], h, sc, cfg, ctx)
        cache["conv"].copy_(sc.conv)
        cache["ssm"].copy_(sc.state)
        return x + out

    kvc = attn_mod.KVCache(k=cache["kv_k"], v=cache["kv_v"], length=pos)
    if cfg.family == "hybrid":
        a_out, _ = attn_mod.decode_attention(lp["attn"], h, kvc, cfg, window=win, ctx=ctx)
        sc = ssm_mod.SsmCache(conv=cache["conv"], state=cache["ssm"])
        s_out, sc = ssm_mod.ssm_decode_step(lp["ssm"], h, sc, cfg, ctx)
        cache["conv"].copy_(sc.conv)
        cache["ssm"].copy_(sc.state)
        mix = 0.5 * (
            rms_norm(a_out, lp["beta_attn"], cfg.norm_eps)
            + rms_norm(s_out, lp["beta_ssm"], cfg.norm_eps)
        )
        x = x + mix
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + mlp(lp["mlp"], h2)

    a_out, _ = attn_mod.decode_attention(lp["attn"], h, kvc, cfg, window=cfg.window,
                                          ctx=ctx)
    x = x + a_out
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    if cfg.is_moe:
        return x + moe_mod.moe_ffn(lp["moe"], h2, cfg, ctx)[0]
    return x + mlp(lp["mlp"], h2)


@torch.no_grad()
def lm_decode_step(
    params: Params,
    tokens,  # [B, 1] integer, tensor or numpy
    state: DecodeState,
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step: returns (logits [B, V], the state at ``pos + 1``)."""
    with mesh_scope(ctx):
        embed = params["embed"]
        x = embed_lookup(embed, tokens, ctx)
        names = [n for n in ("kv_k", "kv_v", "conv", "ssm") if getattr(state, n) is not None]
        for i, (lp, win) in enumerate(zip(params["layers"], _layer_windows(cfg))):
            cache = {n: getattr(state, n)[i] for n in names}
            x = _decode_block(x, lp, cache, win, state.pos, cfg, ctx)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _logits(params, x, cfg)
        return logits[:, 0], state._replace(pos=state.pos + 1)
