"""AdamW with cosine schedule, global-norm clipping, and optional int8
gradient compression: the JAX package's optimizer on the port's weights.

The reference keeps its state as pytrees mirroring the parameters, with
every layer's weights stacked ``[L, ...]``. The port's state mirrors the
:class:`Params` module instead (one module per block), and decides what
the reference decides per stacked leaf on that leaf
(:func:`~repro_torch.models.common.stacked_groups`):

* **Weight decay by the reference's rank.** The reference decays a leaf
  of two or more dimensions; under ``layers`` every leaf has the layer
  axis besides its own, so each block's norms and SSD vectors (1-D here)
  are decayed as they are there.
* **One int8 scale per stacked leaf**: ``max |g|`` over all the layers.
* **The schedule in float32.** The learning rate and the bias
  corrections are float32 numpy scalars on the host, computed with the
  reference's float32 operations in its order (a Python float would
  round differently), then used on the device as 0-d tensors. The
  cosine is the C library's ``cosf``, which XLA's CPU backend calls
  too; numpy's and PyTorch's float32 cosines round some inputs
  differently.
* **Noise passed in.** ``jax.random`` cannot be matched, so the int8
  quantizer draws its uniform noise from a ``torch.Generator``, or takes
  it ready-made (``uniform=``), as the tests do with JAX's own draws.

Gradients are a mapping from the weights' names (``named_parameters``)
to tensors. :func:`opt_update` updates the weights and the moments in
place, under ``torch.no_grad``. Divisors are 0-d tensors on the
weights' device: a CUDA division by a Python scalar multiplies by its
reciprocal, which rounds differently from the reference's division.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.config import TrainConfig
from repro_torch.models.common import Params, stacked_groups

__all__ = ["OptState", "init_opt", "opt_update", "cosine_lr", "global_norm", "compress_int8"]

Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


class OptState(NamedTuple):
    mu: Params  # first moment, float32, the weights' structure
    nu: Params  # second moment
    step: np.int32  # host scalar: the learning rate is computed on the host


def init_opt(params: Params) -> OptState:
    """Zero moments in float32, each placed as its weight (a DTensor
    weight's moments are DTensors of its placements)."""

    def zeros(_, p):
        return torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)

    return OptState(mu=params.map(zeros), nu=params.map(zeros), step=np.int32(0))


@functools.lru_cache(maxsize=1)
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.argtypes = [ctypes.c_float]
    libm.cosf.restype = ctypes.c_float
    return libm.cosf


def cosine_lr(cfg: TrainConfig, step) -> np.float32:
    """Linear warmup, then cosine decay to a tenth: the reference's float32
    arithmetic, operation for operation."""
    f32 = np.float32
    warm = np.minimum(f32(step) / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip(
        f32(int(step) - cfg.warmup_steps) / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
        f32(0.0), f32(1.0),
    )
    cos = f32(0.5) * (f32(1.0) + f32(_cosf()(float(f32(np.pi) * prog))))
    return f32(cfg.learning_rate) * warm * (f32(0.1) + f32(0.9) * cos)


def _named(tree: Tree) -> Dict[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def _stacked(key: str, names) -> bool:
    """Whether a group is a list of blocks' weights (``layers/…``)."""
    return names[0] != key.replace("/", ".")


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the reference's leaves, in its order, of each
    leaf's sum of squares in float32."""
    named = _named(tree)
    leaves = []
    for _, names in stacked_groups(named):
        total = None
        for n in names:
            s = torch.sum(torch.square(named[n].float()))
            total = s if total is None else total + s
        leaves.append(total)
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def compress_int8(
    grads: Tree,
    rng: Optional[torch.Generator] = None,
    *,
    uniform: Optional[Mapping[str, object]] = None,
) -> Dict[str, torch.Tensor]:
    """Int8 quantize/dequantize with stochastic rounding — the fidelity
    model of compressing the inter-pod gradient all-reduce. One scale per
    reference leaf (``max |g| / 127`` over every layer of a stacked one).
    The noise is ``uniform - 0.5``, with ``uniform[key]`` (the leaf's
    stacked shape, keys as :func:`stacked_groups` gives them) when given,
    else drawn from ``rng`` leaf by leaf in the reference's order. Returns
    float32 gradients under the same names."""
    named = _named(grads)
    out: Dict[str, torch.Tensor] = {}
    for key, names in stacked_groups(named):
        g32 = [named[n].float() for n in names]
        peak = torch.stack([g.abs().max() for g in g32]).max()
        scale = torch.clamp(peak, min=1e-12) / peak.new_tensor(127.0)
        stacked = _stacked(key, names)
        shape = (len(names), *g32[0].shape) if stacked else tuple(g32[0].shape)
        if uniform is not None:
            u = torch.tensor(np.asarray(uniform[key]), device=peak.device)
            if tuple(u.shape) != shape:
                raise ValueError(f"uniform[{key!r}]: shape {tuple(u.shape)}, expected {shape}")
        else:
            u = torch.rand(shape, generator=rng, dtype=torch.float32, device=peak.device)
        noise = u - 0.5
        for i, (n, g) in enumerate(zip(names, g32)):
            q8 = torch.clamp(torch.round(g / scale + (noise[i] if stacked else noise)),
                             -127, 127).to(torch.int8)
            out[n] = q8.float() * scale
    return out


@torch.no_grad()
def opt_update(
    params: Params,
    grads: Tree,
    state: OptState,
    cfg: TrainConfig,
    *,
    compress_rng: Optional[torch.Generator] = None,
) -> Tuple[Params, OptState, dict]:
    """One AdamW step, in place on ``params`` and ``state``'s moments.
    Returns (params, the state at ``step + 1``, {grad_norm, lr}); the
    gradient norm is taken before clipping, after compression."""
    named = _named(grads)
    if cfg.grad_compression == "int8" and compress_rng is not None:
        named = compress_int8(named, compress_rng)

    gnorm = global_norm(named)
    clip = torch.clamp(torch.div(gnorm.new_tensor(cfg.grad_clip),
                                 torch.clamp(gnorm, min=1e-12)), max=1.0)
    step = np.int32(int(state.step) + 1)
    f32 = np.float32
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = f32(1.0) - f32(b1) ** f32(step)
    bc2 = f32(1.0) - f32(b2) ** f32(step)
    lr_t, bc1_t, bc2_t = (gnorm.new_tensor(float(v)) for v in (lr, bc1, bc2))

    weights = dict(params.named_parameters())
    mus = dict(state.mu.named_parameters())
    nus = dict(state.nu.named_parameters())
    for key, names in stacked_groups(weights):
        rank_extra = 1 if _stacked(key, names) else 0
        for n in names:
            p, mu, nu = weights[n], mus[n], nus[n]
            g = named[n].float() * clip
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            delta = (mu / bc1_t) / (torch.sqrt(nu / bc2_t) + 1e-8)
            # Decoupled weight decay on matrices only: ndim >= 2 in the
            # reference's tree, where a stacked leaf has the layer axis too.
            wd = cfg.weight_decay if p.ndim + rank_extra >= 2 else 0.0
            p32 = p.float()
            p.copy_(p32 - lr_t * (delta + wd * p32))
    metrics = {"grad_norm": gnorm, "lr": lr_t}
    return params, OptState(state.mu, state.nu, step), metrics
