"""Mamba-2 (SSD — state-space duality) layer, with the chunked scan and
O(1) decode.

The sequence is split into chunks; intra-chunk terms are masked
attention-like products, inter-chunk terms a recurrence over per-chunk
states — a ``lax.scan`` in the JAX package, a loop over the chunks here.
The SSD arithmetic runs in float32 whatever the model's type, and ``y``
is cast back to the input's type before the gate and the norm, as in
the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.common import Params, dense_init, project, rms_norm, softplus

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


def ssm_forward(p: Params, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Chunked SSD over a full sequence. u: [B, S, D] -> [B, S, D]."""
    bsz, s, _ = u.shape
    h, pdim, n, cl = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    if s % cl:
        raise ValueError(f"sequence length {s} is not a multiple of ssm_chunk {cl}")
    nc = s // cl

    z, x, b_mat, c_mat, dt_raw = _split_proj(p, u, cfg)
    x = _causal_conv(x, p["conv_w"], p["conv_b"])
    dt = softplus(dt_raw.float() + p["dt_bias"])  # [B,S,H]
    a = -torch.exp(p["a_log"])  # [H]
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
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.float32, device=u.device))
    g = cb[..., None] * dec * causal[None, None, :, :, None]  # [B,nc,i,j,H]
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", g, dtc, xh)

    # --- Chunk states + inter-chunk recurrence ---------------------------
    last = lcum[:, :, -1:, :]  # [B,nc,1,H]
    decay_to_end = torch.exp(torch.clamp(last - lcum, -60.0, 0.0))  # [B,nc,cl,H]
    states = torch.einsum(
        "bclh,bclh,bclhp,bcln->bchpn", decay_to_end, dtc, xh, bm
    )  # [B,nc,H,P,N]
    chunk_decay = torch.exp(torch.clamp(last[:, :, 0, :], -60.0, 0.0))  # [B,nc,H]

    h_prev = torch.zeros((bsz, h, pdim, n), dtype=torch.float32, device=u.device)
    h_in = []  # the state *entering* each chunk
    for c in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,N]

    decay_in = torch.exp(torch.clamp(lcum, -60.0, 0.0))  # [B,nc,cl,H]
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", cm, h_in, decay_in)

    y = y_intra + y_inter + p["d_skip"][None, None, None, :, None] * xh
    y = y.reshape(bsz, s, cfg.d_inner).to(u.dtype)
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


def ssm_decode_step(
    p: Params, u: torch.Tensor, cache: SsmCache, cfg: ArchConfig
) -> Tuple[torch.Tensor, SsmCache]:
    """One-token SSD update. u: [B, 1, D]. Returns new cache tensors and
    leaves ``cache`` as it was."""
    bsz = u.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    z, x, b_mat, c_mat, dt_raw = _split_proj(p, u, cfg)

    # Causal conv over (cached window + new token).
    win = torch.cat([cache.conv, x], dim=1)  # [B, cw, Din]
    conv_out = torch.einsum("bwd,wd->bd", win, p["conv_w"]) + p["conv_b"]
    xc = F.silu(conv_out)  # [B, Din]
    new_conv = win[:, 1:]

    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"])  # [B,H]
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)  # [B,H]
    xh = xc.reshape(bsz, h, pdim).float()
    bv = b_mat[:, 0].float()  # [B,N]
    cv = c_mat[:, 0].float()
    state = cache.state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, bv
    )
    y = torch.einsum("bhpn,bn->bhp", state, cv) + p["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, cfg.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = project(y, p["out_proj"])
    return out, SsmCache(conv=new_conv, state=state)
