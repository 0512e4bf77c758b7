"""Elastic re-scaling: resume the same logical state on a different mesh.

The port of the JAX package's ``repro/runtime/elastic.py``. Checkpoints
are mesh-agnostic (a logical layout), so scaling from f to f' units is:
checkpoint → rebuild the mesh and placements → restore → continue.

A mesh is a numpy array of ``torch.device`` (:func:`make_mesh_any`), and
a placement is a :class:`PartitionSpec`, as in JAX: ``P()`` names no
mesh axis and means *replicated*, the whole leaf on every device of the
mesh (:class:`Replicated`). That is the one placement the sparse side
uses — the serving engine re-places a plan's shard arrays on the
survivors of a unit loss. A sharded placement (a spec that names an
axis) is for the LM stack's parameters and waits for its port
(ROADMAP.md, Queue 1, item 8e): :func:`reshard_tree` raises
``NotImplementedError`` for one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = [
    "P",
    "PartitionSpec",
    "Replicated",
    "elastic_restart",
    "local_devices",
    "make_mesh_any",
    "reshard_tree",
]


class PartitionSpec(tuple):
    """How a leaf lies over a mesh: one entry per leading dimension, a
    mesh axis name or ``None``, as JAX's ``PartitionSpec``. ``P()`` — no
    entry names an axis — is the replicated placement."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    @property
    def replicated(self) -> bool:
        return all(axis is None for axis in self)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Replicated:
    """A leaf placed whole on every device of a mesh: one copy a device,
    in the mesh's flat order. ``np.asarray`` of it reads the first copy
    back to the host, as ``np.asarray`` of a replicated ``jax.Array``
    does."""

    shards: Tuple[torch.Tensor, ...]

    def __array__(self, dtype=None, copy=None):
        host = self.shards[0].cpu().numpy()
        return host if dtype is None else host.astype(dtype, copy=False)


def local_devices(device=None) -> List[torch.device]:
    """The devices of ``device``'s kind in this process: every CUDA device
    (the card when ``device`` is omitted), or the one CPU device."""
    kind = resolve_device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh of {kind!r} devices; the port runs on cuda or cpu")


def make_mesh_any(
    shape: Tuple[int, ...], axes: Tuple[str, ...], *, device=None
) -> np.ndarray:
    """A mesh of ``shape`` over the first ``prod(shape)`` local devices of
    ``device``'s kind (the card's when omitted), named by ``axes``."""
    if len(axes) != len(shape):
        raise ValueError(f"{len(axes)} axis names {axes} for a {len(shape)}-d mesh {shape}")
    n = int(np.prod(shape))
    devs = local_devices(device)
    if len(devs) < n:
        raise ValueError(f"a mesh of {shape} needs {n} devices, {len(devs)} present")
    mesh = np.empty(n, dtype=object)
    mesh[:] = devs[:n]
    return mesh.reshape(shape)


def _place(leaf, mesh: np.ndarray, spec) -> Replicated:
    if not isinstance(spec, PartitionSpec):
        raise TypeError(f"a placement is a PartitionSpec, got {type(spec).__name__}")
    if not spec.replicated:
        raise NotImplementedError(
            f"sharded placement {spec!r}: only the replicated P() is ported; a sharded "
            "one waits for the LM stack (ROADMAP.md, Queue 1, item 8e)"
        )
    if isinstance(leaf, torch.Tensor):
        src = leaf.detach()
    else:
        host = np.asarray(leaf)  # a read-only map (a lazy plan) is copied first
        src = torch.from_numpy(host if host.flags.writeable else host.copy())
    # Copies, so a placed leaf never aliases the array it came from.
    return Replicated(tuple(src.to(dev, copy=True) for dev in mesh.flat))


def reshard_tree(tree: Any, mesh: np.ndarray, spec_fn: Callable[[str, Any], Any]) -> Any:
    """Place every leaf of ``tree`` (nested dicts, lists and tuples of
    arrays) on ``mesh`` with the placement ``spec_fn(key, leaf)``, where
    ``key`` is the leaf's path joined by ``/`` (``"tiles"``,
    ``"layers/0/w"``). Returns a tree of the same structure."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        key = "/".join(path)
        return _place(node, mesh, spec_fn(key, node))

    return walk(tree, ())


def elastic_restart(
    ckpt_manager,
    template: Any,
    new_mesh: np.ndarray,
    spec_fn: Callable[[str, Any], Any],
    step: Optional[int] = None,
) -> Tuple[Any, int]:
    """Restore the latest checkpoint onto a mesh of a different size.
    ``ckpt_manager`` is any object with ``restore(template, step)``
    returning ``(state, step)``."""
    state, ck_step = ckpt_manager.restore(template, step)
    return reshard_tree(state, new_mesh, spec_fn), ck_step
