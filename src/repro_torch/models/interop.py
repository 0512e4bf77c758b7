"""Carry language-model weights across packages as numpy arrays.

The JAX package's parameters are a pytree of nested dicts whose
``layers`` entry (``enc_layers`` and ``dec_layers`` for the
encoder-decoder family) stacks every layer's weights on a leading
``[L, ...]`` axis. ``jax.tree.map(np.asarray, params)`` turns them into
numpy, and :func:`lm_from_numpy` builds the port's module from that tree;
:func:`lm_to_numpy` gives the tree back. The tests match the two
packages through these functions, not by matching their random number
generators.

numpy has no bfloat16 of its own: a bfloat16 array of the JAX package
(``ml_dtypes``) is read through float32, which holds it exactly, and
:func:`lm_to_numpy` returns a bfloat16 weight as float32 — the same
values, so a tree survives ``lm_to_numpy(lm_from_numpy(cfg, tree))``
value for value, and bit for bit when it is float32.

The optimizer's state crosses the same way: :func:`opt_to_numpy` gives
the reference's ``OptState`` fields (``mu`` and ``nu`` as stacked trees
of float32, ``step`` an int32 scalar) and :func:`opt_from_numpy` takes
them back.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.config import ArchConfig
from repro_torch.models import moe, ssm
from repro_torch.models.common import Params
from repro_torch.models.transformer import _dtype, padded_vocab
from repro_torch.optim import adamw  # OptState; adamw imports models.common in turn

__all__ = ["params_from_numpy", "lm_from_numpy", "lm_to_numpy", "opt_from_numpy",
           "opt_to_numpy"]

# Weights kept in float32 whatever the model's type.
FLOAT32_PARAMS = ssm.FLOAT32_PARAMS + moe.FLOAT32_PARAMS


def _tensor(name: str, arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    target = torch.float32 if name in FLOAT32_PARAMS else dtype
    return torch.tensor(arr).to(device=device, dtype=target)


def params_from_numpy(tree: Mapping[str, Any], dtype: torch.dtype, device) -> Params:
    """A :class:`Params` module from a nested dict of arrays (lists of
    dicts become module lists), each weight in ``dtype`` on ``device``
    except the float32 ones (the SSD's, the MoE router)."""

    def convert(name, value):
        if isinstance(value, Mapping):
            return {k: convert(k, v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [convert(name, v) for v in value]
        return _tensor(name, value, dtype, device)

    return Params(convert("", tree))


def _layer_slice(tree: Mapping[str, Any], i: int, n: int, where: str) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _layer_slice(v, i, n, f"{where}.{k}")
        else:
            v = np.asarray(v)
            if v.shape[:1] != (n,):
                raise ValueError(f"{where}.{k}: shape {v.shape} does not stack {n} layers")
            out[k] = v[i]
    return out


def _stacked_lists(cfg: ArchConfig) -> Dict[str, int]:
    """The JAX tree's stacked entries for ``cfg`` and their layer counts:
    ``enc_layers`` and ``dec_layers`` for the encoder-decoder family,
    ``layers`` for the others."""
    if cfg.family == "encdec":
        return {"enc_layers": cfg.encoder_layers, "dec_layers": cfg.num_layers}
    return {"layers": cfg.num_layers}


def _unstacked(cfg: ArchConfig, tree: Mapping[str, Any], dtype: torch.dtype, device) -> Params:
    device = resolve_device(device)
    embed_shape = tuple(np.shape(tree["embed"]))
    if embed_shape != (padded_vocab(cfg), cfg.d_model):
        raise ValueError(f"embed: shape {embed_shape} does not fit {cfg.name}")
    out = dict(tree)
    for key, n in _stacked_lists(cfg).items():
        out[key] = [_layer_slice(tree[key], i, n, key) for i in range(n)]
    return params_from_numpy(out, dtype, device)


def lm_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any], device=None) -> Params:
    """The port's module for ``cfg`` from the JAX package's parameter tree
    as numpy arrays, on the card unless ``device`` says otherwise."""
    return _unstacked(cfg, tree, _dtype(cfg), device)


def opt_from_numpy(cfg: ArchConfig, state, device=None) -> "adamw.OptState":
    """The port's optimizer state for ``cfg`` from the reference's
    ``OptState`` (or any ``(mu, nu, step)``) as numpy arrays: ``mu`` and
    ``nu`` stacked trees of float32, on the card unless ``device`` says
    otherwise."""
    mu, nu, step = state
    return adamw.OptState(_unstacked(cfg, mu, torch.float32, device),
                    _unstacked(cfg, nu, torch.float32, device), np.int32(step))


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of the weight: the train step updates
    weights in place), bfloat16 as float32. A DTensor is gathered whole
    first (a collective: every rank of its mesh calls it)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to(device="cpu", dtype=dtype, copy=True).numpy()


def _tree(module: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = {k: host_copy(p) for k, p in module._parameters.items()}
    for k, sub in module._modules.items():
        out[k] = _stack([_tree(m) for m in sub]) if isinstance(sub, nn.ModuleList) else _tree(sub)
    return out


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def lm_to_numpy(module: nn.Module) -> Dict[str, Any]:
    """The JAX package's parameter tree (``layers`` stacked ``[L, ...]``)
    as numpy arrays, from the port's module: nested dicts, each list of
    blocks stacked, bfloat16 as float32."""
    return _tree(module)


def opt_to_numpy(state: "adamw.OptState") -> "adamw.OptState":
    """The reference's ``OptState`` fields from the port's: ``mu`` and
    ``nu`` as stacked trees of float32 numpy arrays, ``step`` an int32."""
    return adamw.OptState(_tree(state.mu), _tree(state.nu), np.int32(state.step))
