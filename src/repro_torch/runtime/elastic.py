"""Elastic re-scaling: resume the same logical state on a different mesh.

The port of the JAX package's ``repro/runtime/elastic.py``. Checkpoints
are mesh-agnostic (a logical layout), so scaling from f to f' units is:
checkpoint → rebuild the mesh and placements → restore → continue.

A placement is a :class:`PartitionSpec`, as in JAX: one entry per
leading dimension, a mesh axis name (or a tuple of them) or ``None``.
A mesh is one of two things:

* **A ``DeviceMesh``** over a process group, with named dimensions (the
  LM stack's meshes, :mod:`repro_torch.launch.mesh`): a leaf becomes a
  DTensor whose placements the spec gives (:func:`placements`), each
  rank holding its block. ``np.asarray`` of it gathers the whole leaf
  (:class:`ShardedLeaf`).
* **A numpy array of ``torch.device``** in this process
  (:func:`make_mesh_any`), what the sparse side uses: the serving engine
  re-places a plan's shard arrays on the survivors of a unit loss.
  ``P()`` — no entry names an axis — is *replicated*, the whole leaf on
  every device (:class:`Replicated`); a spec whose named axes have size
  1 places the whole leaf too, as JAX does on a one-device mesh. Blocks
  on several devices of one process are a ``DeviceMesh``'s job.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch import resolve_device

__all__ = [
    "P",
    "PartitionSpec",
    "Replicated",
    "elastic_restart",
    "local_devices",
    "make_mesh_any",
    "placements",
    "reshard_tree",
    "ShardedLeaf",
]


class PartitionSpec(tuple):
    """How a leaf lies over a mesh: one entry per leading dimension, a
    mesh axis name, a tuple of them or ``None``, as JAX's
    ``PartitionSpec`` (which also reads a tuple of one name as the name).
    ``P()`` — no entry names an axis — is the replicated placement."""

    def __new__(cls, *axes):
        axes = tuple((a[0] if len(a) == 1 else (a or None)) if isinstance(a, (tuple, list))
                     else a for a in axes)
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


class ShardedLeaf(DTensor):
    """A DTensor placed by :func:`reshard_tree`. It is a DTensor in every
    op (whose results are plain DTensors); ``np.asarray`` of it gathers
    the whole leaf to the host, as ``np.asarray`` of a sharded
    ``jax.Array`` does — a collective, so every rank of the mesh calls
    it."""

    def __array__(self, dtype=None, copy=None):
        host = self.full_tensor().detach().cpu().numpy()
        return host if dtype is None else host.astype(dtype, copy=False)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec: PartitionSpec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on a named ``DeviceMesh``: ``Shard(d)``
    on each mesh dimension whose axis the spec names at tensor dimension
    ``d``, ``Replicate()`` on the others. A tuple of axes at one dimension
    (the batch's ``("pod", "data")``) shards it over those mesh dimensions
    in the mesh's order, major first, as JAX reads it."""
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = []
        for axis in axes:
            if axis not in names:
                raise ValueError(f"{spec!r} names {axis!r}, not an axis of the mesh {names}")
            if not isinstance(out[names.index(axis)], Replicate):
                raise ValueError(f"{spec!r} names {axis!r} twice")
            idx.append(names.index(axis))
            out[names.index(axis)] = Shard(d)
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: the axes {axes} are not in the mesh's order {names}")
    return tuple(out)


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


def _source(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    host = np.asarray(leaf)  # a read-only map (a lazy plan) is copied first
    return torch.from_numpy(host if host.flags.writeable else host.copy())


def _place(leaf, mesh, spec):
    if not isinstance(spec, PartitionSpec):
        raise TypeError(f"a placement is a PartitionSpec, got {type(spec).__name__}")
    if isinstance(mesh, DeviceMesh):
        # Every rank holds the whole leaf: each keeps a copy of its block, and
        # no data moves between ranks.
        src = _source(leaf).to(mesh.device_type, copy=True)
        placed = distribute_tensor(src, mesh, placements(spec, mesh), src_data_rank=None)
        placed.__class__ = ShardedLeaf
        return placed
    if not spec.replicated and mesh.size > 1:
        raise ValueError(
            f"sharded placement {spec!r} over {mesh.size} devices of one process: place "
            "it on a DeviceMesh over a process group (repro_torch.launch.mesh)")
    # Copies, so a placed leaf never aliases the array it came from.
    src = _source(leaf)
    return Replicated(tuple(src.to(dev, copy=True) for dev in mesh.flat))


def reshard_tree(tree: Any, mesh, spec_fn: Callable[[str, Any], Any]) -> Any:
    """Place every leaf of ``tree`` (nested dicts, lists and tuples of
    arrays) on ``mesh`` — a ``DeviceMesh`` or a numpy array of devices —
    with the placement ``spec_fn(key, leaf)``, where ``key`` is the
    leaf's path joined by ``/`` (``"tiles"``, ``"layers/0/w"``). Returns
    a tree of the same structure. On a ``DeviceMesh`` every rank calls it
    with the same whole leaves."""

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
    new_mesh,
    spec_fn: Callable[[str, Any], Any],
    step: Optional[int] = None,
) -> Tuple[Any, int]:
    """Restore the latest checkpoint onto a mesh of a different size.
    ``ckpt_manager`` is any object with ``restore(template, step)``
    returning ``(state, step)``; the checkpoint holds whole leaves (a
    logical layout), so any mesh can take it."""
    state, ck_step = ckpt_manager.restore(template, step)
    return reshard_tree(state, new_mesh, spec_fn), ck_step
