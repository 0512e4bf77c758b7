"""Shared model building blocks: weights as a module, math as functions.

The JAX package keeps parameters as nested dicts and computes with pure
functions over them. The port keeps the functions and puts the weights
in :class:`Params`, an ``nn.Module`` whose tensors are parameters and
whose nested dicts and lists are submodules, so ``p["wq"]`` and
``p.wq`` read the same weight as the reference's ``p["wq"]``. The casts
follow the reference exactly (``rms_norm`` in float32, ``rope``'s angles
in float32), because the card has no JAX to catch a reordering.

The JAX package stacks every layer's weights on a leading ``[L, ...]``
axis; the port keeps one module per block in the ``layers`` list.
:func:`stacked_groups` names each weight by its place in the JAX tree, so
that what the reference decides on a stacked leaf (weight decay by rank,
one int8 scale, one checkpoint array) is decided here on the same leaf.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models.mesh import token_nll, whole

__all__ = [
    "Params",
    "stacked_groups",
    "project",
    "rms_norm",
    "rope",
    "softplus",
    "dense_init",
    "embed_init",
    "cross_entropy",
    "count_params",
]


class Params(nn.Module):
    """Named weights: each tensor becomes a parameter, each mapping a
    nested ``Params`` and each list an ``nn.ModuleList`` of them.

    Parameters are made with ``requires_grad=False``: a decode step writes
    its caches in place, which autograd must not record. The train step
    (:mod:`repro_torch.train.step`) turns gradients on for the module it
    trains, for the length of the step.
    """

    def __init__(self, entries: Mapping[str, object]):
        super().__init__()
        for name, value in entries.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, Mapping):
                self.add_module(name, Params(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    v if isinstance(v, nn.Module) else Params(v) for v in value))
            elif isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                raise TypeError(f"{name}: {type(value).__name__} is not a weight")

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return getattr(self, name) if name in self else default

    def map(self, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> "Params":
        """A new module of the same structure whose weight ``name`` (as
        ``named_parameters`` gives it) is ``fn(name, weight)``."""

        def tree(m: nn.Module, prefix: str):
            if isinstance(m, nn.ModuleList):
                return [tree(sub, f"{prefix}{i}.") for i, sub in enumerate(m)]
            out: Dict[str, object] = {k: fn(prefix + k, p) for k, p in m._parameters.items()}
            out.update({k: tree(sub, f"{prefix}{k}.") for k, sub in m._modules.items()})
            return out

        return Params(tree(self, ""))


def stacked_groups(names: Iterable[str]) -> List[Tuple[str, List[str]]]:
    """The JAX tree's leaves over the port's weight names, in the order
    ``jax.tree.leaves`` gives them (dict keys sorted at every level):
    ``(key, names)`` with ``key`` the leaf's path joined by ``/`` and
    ``names`` the weights that make it up — one per layer, in layer order,
    for a leaf under a list of blocks (``layers.3.attn.wq`` is layer 3 of
    ``layers/attn/wq``), else the one weight."""
    groups: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        index = next((i for i, part in enumerate(parts) if part.isdigit()), None)
        if index is None:
            groups.setdefault(tuple(parts), []).append((-1, name))
        else:
            key = tuple(parts[:index] + parts[index + 1:])
            groups.setdefault(key, []).append((int(parts[index]), name))
    return [("/".join(key), [n for _, n in sorted(groups[key])]) for key in sorted(groups)]


def project(x: torch.Tensor, w: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """``x``'s last ``dims`` axes contracted with ``w``'s first ``dims``:
    the reference's ``jnp.einsum("bsd,df->bsf", x, w)`` and its kin, a
    product with no batch dimension. It is one ``aten.mm``, which is how
    ``remat="dots"`` tells the products it saves
    (``checkpoint_dots_with_no_batch_dims``) from the batched ones, which
    ``torch.einsum`` runs as ``aten.bmm``."""
    return torch.tensordot(x, w, dims=dims)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if isinstance(x, DTensor):
        # The residual stream enters the norm whole, and its gradient
        # leaves it whole, as Megatron's all-reduces make them: left
        # partial (a row-parallel product's output, or the gradient of
        # the column-parallel products after the norm), the products next
        # to it would gather their weights and repeat the work on every
        # rank, as DTensor's cost model weighs bytes and not operations.
        x = whole(x)
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def rope(
    x: torch.Tensor,  # [..., S, H, hd]
    positions: torch.Tensor,  # [..., S] integer
    theta: float = 1e4,
) -> torch.Tensor:
    """Rotary position embedding on the last (head) dimension. The
    products of ``x`` (any float type) with the float32 ``cos`` and
    ``sin`` promote to float32 before the cast back, as in JAX."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta**exps)  # [half]
    angles = positions[..., None].float() * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x.
    ``torch.nn.functional.softplus`` returns x itself above its threshold
    of 20, which is not the reference's function there."""
    return torch.logaddexp(x, x.new_zeros(()))


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def dense_init(
    generator: torch.Generator,
    shape: Sequence[int],
    fan_in: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in float32 on the generator's device,
    then cast to ``dtype`` and placed on ``device``. On the ``meta``
    device nothing is drawn or allocated: the weight is a stand-in of its
    shape and type, and the generator is left as it was."""
    if _is_meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, device=generator.device,
                    dtype=torch.float32) * std
    return w.to(device=device or generator.device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    if _is_meta(device):
        return torch.empty((vocab, d), dtype=dtype, device="meta")
    w = torch.randn((vocab, d), generator=generator, device=generator.device,
                    dtype=torch.float32) * 0.02
    return w.to(device=device or generator.device, dtype=dtype)


def cross_entropy(
    logits: torch.Tensor,  # [B, S, V] (any float dtype)
    labels: torch.Tensor,  # [B, S] integer
    mask: Optional[torch.Tensor] = None,  # [B, S] float
) -> torch.Tensor:
    if isinstance(logits, DTensor):
        nll = token_nll(logits, labels)  # on a mesh: the vocab-parallel loss
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
        nll = logz - gold
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def count_params(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))
