"""Mamba-2 (SSD — state-space duality) layer, with the chunked scan and
O(1) decode.

The sequence is split into chunks; intra-chunk terms are masked
attention-like products, inter-chunk terms a recurrence over per-chunk
states — a ``lax.scan`` in the JAX package, a loop over the chunks here.
The SSD arithmetic runs in float32 whatever the model's type, and ``y``
is cast back to the input's type before the gate and the norm, as in
the reference.

On a device mesh (``ctx``) the SSD between the projections and the gate
(:func:`_ssd`, :func:`_ssd_step`) runs per shard through ``local_map``:
every (sequence, head) is independent given B and C, so each rank takes
its batch shard and, where the heads divide the model axis, its heads
with their channels, and runs the meshless code on them. Where they do
not divide, the heads are whole on every rank of the model axis.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ArchConfig
from repro_torch.models.common import Params, dense_init, project, rms_norm, softplus
from repro_torch.models.mesh import MeshCtx, as_dtensor

__all__ = [
    "FLOAT32_PARAMS",
    "init_ssm",
    "ssm_forward",
    "ssm_decode_step",
    "SsmCache",
    "init_ssm_cache",
]

# Parameters kept in float32 whatever the model's type.
FLOAT32_PARAMS = ("a_log", "d_skip", "dt_bias")


def init_ssm(generator: torch.Generator, cfg: ArchConfig, dtype, device=None) -> Params:
    """Input projections are kept *separate* (w_z/w_x/w_b/w_c/w_dt), as in
    the reference, so the weights carry across unchanged."""
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.conv_width
    f32 = torch.float32

    def dense(shape, fan_in):
        return dense_init(generator, shape, fan_in=fan_in, dtype=dtype, device=device)

    return Params({
        "w_z": dense((d, din), d),
        "w_x": dense((d, din), d),
        "w_b": dense((d, n), d),
        "w_c": dense((d, n), d),
        "w_dt": dense((d, h), d),
        "conv_w": dense((cw, din), cw),
        "conv_b": torch.zeros((din,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device)),  # A = -exp(a_log)
        "d_skip": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "norm": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": dense((din, d), din),
    })


def _split_proj(p: Params, u: torch.Tensor, cfg: ArchConfig):
    z = project(u, p["w_z"])
    x = project(u, p["w_x"])
    b_mat = project(u, p["w_b"])
    c_mat = project(u, p["w_c"])
    dt = project(u, p["w_dt"])
    return z, x, b_mat, c_mat, dt


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum``, except on the card under
    ``torch.use_deterministic_algorithms`` (the train step): PyTorch refuses
    a floating-point CUDA cumsum there, so the running sum is a product
    with a lower-triangular matrix of ones, which cuBLAS computes the same
    way on every run (and whose backward is a product too). It is an
    einsum (``aten.bmm``), not a :func:`project`: ``remat="dots"`` does
    not save it, as ``jax.checkpoint`` does not save a cumsum."""
    if not (x.is_cuda and torch.are_deterministic_algorithms_enabled()):
        return torch.cumsum(x, dim)
    n = x.shape[dim]
    tril = torch.tril(torch.ones((n, n), dtype=x.dtype, device=x.device))
    return torch.einsum("ij,j...->i...", tril, x.movedim(dim, 0)).movedim(0, dim)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis. x [B,S,Din]."""
    cw = w.shape[0]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(pad[:, i : i + x.shape[1], :] * w[i] for i in range(cw))
    return F.silu(out + b)


# The weights the SSD core reads, after the projections' outputs.
_CORE_PARAMS = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip")


def _ssd(x, b_mat, c_mat, dt_raw, conv_w, conv_b, dt_bias, a_log, d_skip, *, chunk: int,
         dtype: torch.dtype) -> torch.Tensor:
    """The chunked SSD of x [B, S, Din] (H heads of Din / H channels, H =
    ``dt_raw.shape[-1]``) with B / C [B, S, N] and the step sizes' inputs
    dt_raw [B, S, H]: the causal conv, then y [B, S, Din] in ``dtype``."""
    bsz, s, din = x.shape
    h, n, cl = dt_raw.shape[-1], b_mat.shape[-1], chunk
    pdim, nc = din // h, s // cl

    x = _causal_conv(x, conv_w, conv_b)
    dt = softplus(dt_raw.float() + dt_bias)  # [B,S,H]
    a = -torch.exp(a_log)  # [H]
    loga = dt * a  # [B,S,H] log decay per step (<=0)

    xh = x.reshape(bsz, nc, cl, h, pdim).float()
    bm = b_mat.reshape(bsz, nc, cl, n).float()
    cm = c_mat.reshape(bsz, nc, cl, n).float()
    dtc = dt.reshape(bsz, nc, cl, h)
    lg = loga.reshape(bsz, nc, cl, h)
    lcum = _cumsum(lg, dim=2)  # [B,nc,cl,H] inclusive cumulative log-decay

    # --- Intra-chunk (masked attention-like) ------------------------------
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)  # [B,nc,cl,cl]
    # decay exp(L_i - L_j) for i >= j (segment sum), per head.
    dec = torch.exp(
        torch.clamp(lcum[:, :, :, None, :] - lcum[:, :, None, :, :], -60.0, 0.0)
    )  # [B,nc,i,j,H]
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.float32, device=x.device))
    g = cb[..., None] * dec * causal[None, None, :, :, None]  # [B,nc,i,j,H]
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", g, dtc, xh)

    # --- Chunk states + inter-chunk recurrence ---------------------------
    last = lcum[:, :, -1:, :]  # [B,nc,1,H]
    decay_to_end = torch.exp(torch.clamp(last - lcum, -60.0, 0.0))  # [B,nc,cl,H]
    states = torch.einsum(
        "bclh,bclh,bclhp,bcln->bchpn", decay_to_end, dtc, xh, bm
    )  # [B,nc,H,P,N]
    chunk_decay = torch.exp(torch.clamp(last[:, :, 0, :], -60.0, 0.0))  # [B,nc,H]

    h_prev = torch.zeros((bsz, h, pdim, n), dtype=torch.float32, device=x.device)
    h_in = []  # the state *entering* each chunk
    for c in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,N]

    decay_in = torch.exp(torch.clamp(lcum, -60.0, 0.0))  # [B,nc,cl,H]
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", cm, h_in, decay_in)

    y = y_intra + y_inter + d_skip[None, None, None, :, None] * xh
    return y.reshape(bsz, s, din).to(dtype)


def _core_on_mesh(fn, args, kinds: str, out_kinds: str, cfg: ArchConfig, ctx: MeshCtx):
    """``fn(*args)`` per shard. ``kinds`` says what each argument is:
    ``h`` an activation [B, ..., C] whose last dim holds heads or their
    channels, ``n`` one without heads (B and C), ``w`` a weight whose last
    dim holds them, ``s`` a state [B, H, ...]; ``out_kinds`` the same of
    ``fn``'s outputs. Each rank takes its batch shard and, where the heads
    divide the model axis, its heads."""
    m = ctx.model_axis
    heads = cfg.ssm_heads % ctx.model_ranks == 0
    batch = ctx.batch_shard(args[0].shape[0])
    partial_b = Partial() if batch == Shard(0) else Replicate()

    def placed(kind: str, ndim: int):
        """(placements, gradient placements) of an argument."""
        on_m = Replicate()
        if heads and kind in "hw":
            on_m = Shard(ndim - 1)
        elif heads and kind == "s":
            on_m = Shard(1)
        if kind == "w":  # each batch shard's gradient of a weight is partial
            return ctx.placements(**{m: on_m}), ctx.placements(batch=partial_b, **{m: on_m})
        # a rank's gradient of B and C is partial, from its heads
        grad = Partial() if heads and kind == "n" else on_m
        return ctx.placements(batch=batch, **{m: on_m}), ctx.placements(batch=batch, **{m: grad})

    pls = [placed(k, t.ndim) for k, t in zip(kinds, args)]
    outs = [list(placed(k, 3 if k == "h" else 4)[0]) for k in out_kinds]
    return local_map(fn, out_placements=tuple(outs) if len(outs) > 1 else outs[0],
                     in_placements=[p for p, _ in pls], in_grad_placements=[g for _, g in pls],
                     device_mesh=ctx.mesh, redistribute_inputs=True)(
        *(as_dtensor(t, ctx) for t in args))


def ssm_forward(p: Params, u: torch.Tensor, cfg: ArchConfig,
                ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """Chunked SSD over a full sequence. u: [B, S, D] -> [B, S, D]."""
    s, cl = u.shape[1], cfg.ssm_chunk
    if s % cl:
        raise ValueError(f"sequence length {s} is not a multiple of ssm_chunk {cl}")
    z, x, b_mat, c_mat, dt_raw = _split_proj(p, u, cfg)
    weights = [p[k] for k in _CORE_PARAMS]
    fn = functools.partial(_ssd, chunk=cl, dtype=u.dtype)
    if ctx is None or ctx.mesh is None:
        y = fn(x, b_mat, c_mat, dt_raw, *weights)
    else:
        y = _core_on_mesh(fn, (x, b_mat, c_mat, dt_raw, *weights), "hnnh" + "w" * 5, "h", cfg,
                          ctx)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return project(y, p["out_proj"])


class SsmCache(NamedTuple):
    conv: torch.Tensor  # [B, cw-1, Din] trailing conv inputs
    state: torch.Tensor  # [B, H, P, N]


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device=None) -> SsmCache:
    return SsmCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner), dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
    )


def _ssd_step(x, conv, b_mat, c_mat, dt_raw, conv_w, conv_b, dt_bias, a_log, d_skip, state, *,
              dtype: torch.dtype):
    """One token's SSD: x [B, 1, Din] after the conv window ``conv`` [B,
    cw-1, Din], B / C [B, 1, N], dt_raw [B, 1, H], the state [B, H, P, N].
    Returns (y [B, 1, Din] in ``dtype``, the new window, the new state)."""
    bsz, _, din = x.shape
    h = dt_raw.shape[-1]
    # Causal conv over (cached window + new token).
    win = torch.cat([conv, x], dim=1)  # [B, cw, Din]
    conv_out = torch.einsum("bwd,wd->bd", win, conv_w) + conv_b
    xc = F.silu(conv_out)  # [B, Din]

    dt = softplus(dt_raw[:, 0].float() + dt_bias)  # [B,H]
    a = -torch.exp(a_log)
    decay = torch.exp(dt * a)  # [B,H]
    xh = xc.reshape(bsz, h, din // h).float()
    bv = b_mat[:, 0].float()  # [B,N]
    cv = c_mat[:, 0].float()
    state = state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, bv
    )
    y = torch.einsum("bhpn,bn->bhp", state, cv) + d_skip[None, :, None] * xh
    return y.reshape(bsz, 1, din).to(dtype), win[:, 1:], state


def ssm_decode_step(
    p: Params, u: torch.Tensor, cache: SsmCache, cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, SsmCache]:
    """One-token SSD update. u: [B, 1, D]. Returns new cache tensors and
    leaves ``cache`` as it was."""
    z, x, b_mat, c_mat, dt_raw = _split_proj(p, u, cfg)
    weights = [p[k] for k in _CORE_PARAMS]
    fn = functools.partial(_ssd_step, dtype=u.dtype)
    if ctx is None or ctx.mesh is None:
        y, conv, state = fn(x, cache.conv, b_mat, c_mat, dt_raw, *weights, cache.state)
    else:
        y, conv, state = _core_on_mesh(fn, (x, cache.conv, b_mat, c_mat, dt_raw, *weights,
                                            cache.state), "hhnnh" + "w" * 5 + "s", "hhs", cfg, ctx)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = project(y, p["out_proj"])
    return out, SsmCache(conv=conv, state=state)
