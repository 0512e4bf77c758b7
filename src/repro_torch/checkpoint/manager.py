"""Mesh-agnostic checkpointing with atomic commits and retention GC, in
the JAX package's layout, so that a checkpoint written by either
package restores in the other.

Layout::

    <dir>/step_000042/            (committed by atomic rename)
        arrays.npz                (flat {path: array})
        meta.json                 (step, extra)
    <dir>/step_000042.tmp/        (in-flight write, never read)

A tree is nested dicts (keys sorted, as ``jax.tree`` orders them),
lists, tuples, named tuples (by field name), tensors, numpy arrays and
scalars, and :class:`~repro_torch.models.common.Params` modules. A
module is saved as the JAX package's tree of its weights: each list of
blocks stacked ``[L, ...]`` under one key. Keys are the tree paths
joined by ``/`` (``0/layers/attn/wq``, ``1/mu/embed``, ``1/step`` for
``(params, opt_state)``). bfloat16 arrays are stored as float32 (npz
cannot hold them) and cast back to the template's type on restore. A
DTensor is saved whole (gathered: every rank of its mesh saves) and
restored with the template's placements, so a checkpoint restores onto
a mesh of any size.

Background-thread saves overlap training compute; ``wait()`` joins. The
arrays are copied to the host before the thread starts, so the step may
update the weights in place while the write runs.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.common import Params
from repro_torch.models.interop import host_copy, lm_to_numpy

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_tree"]

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return host_copy(leaf)
    arr = np.array(leaf)  # a copy: the caller may write into its arrays
    if arr.dtype.kind not in "biufc":  # ml_dtypes (bf16 &c) -> f32;
        arr = arr.astype(np.float32)  # npz can't round-trip them
    return arr


def flatten_tree(tree: Any) -> Dict[str, np.ndarray]:
    """``{path: host array}`` of every leaf of ``tree``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, nn.Module):
            node = lm_to_numpy(node)
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), path + [f])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            flat[_SEP.join(path)] = _host(node)

    walk(tree, [])
    return flat


def _array(flat: Dict[str, np.ndarray], key: str, shape: Tuple[int, ...]) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(shape)}")
    return arr


def _like(arr: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``template``'s type and device, and of its
    placements when it is a DTensor (each rank keeps its block of the
    whole array it read: no data moves between ranks)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(template, DTensor):
        t = t.to(device=template.device_mesh.device_type, dtype=template.dtype)
        return distribute_tensor(t, template.device_mesh, template.placements,
                                 src_data_rank=None)
    return t.to(device=template.device, dtype=template.dtype)


def _module(template: nn.Module, flat: Dict[str, np.ndarray], path: List[str]) -> Params:
    """A new module like ``template`` (its types and devices) from the
    stacked arrays under ``path``."""

    def tree(mod, where, layer):
        if isinstance(mod, nn.ModuleList):
            return [tree(sub, where, (i, len(mod))) for i, sub in enumerate(mod)]
        out: Dict[str, object] = {}
        for k, p in mod._parameters.items():
            key = _SEP.join(where + [k])
            if layer is None:
                arr = _array(flat, key, p.shape)
            else:
                arr = _array(flat, key, (layer[1], *p.shape))[layer[0]]
            out[k] = _like(arr, p)
        for k, sub in mod._modules.items():
            out[k] = tree(sub, where + [k], layer)
        return out

    return Params(tree(template, path, None))


def unflatten_tree(template: Any, flat: Dict[str, np.ndarray]) -> Any:
    """A tree of ``template``'s structure, types and devices from ``flat``.
    Raises ``KeyError`` for a missing array and ``ValueError`` for a shape
    that differs from the template's."""

    def build(node, path):
        if node is None:
            return None
        if isinstance(node, nn.Module):
            return _module(node, flat, path)
        if isinstance(node, Mapping):
            return {k: build(v, path + [str(k)]) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f), path + [f]) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + [str(i)]) for i, v in enumerate(node))
        arr = _array(flat, _SEP.join(path), np.shape(node))
        if isinstance(node, torch.Tensor):
            return _like(arr, node)
        if isinstance(node, np.generic):
            return node.dtype.type(arr)
        if hasattr(node, "dtype") and arr.dtype != node.dtype:
            return arr.astype(np.dtype(node.dtype))
        return arr

    return build(template, [])


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = True, extra: Optional[dict] = None) -> None:
        """Serialize ``tree`` (device tensors copied to the host first)."""
        flat = flatten_tree(tree)  # host copies — safe to write async
        meta = {"step": int(step), "extra": extra or {}}
        self.wait()  # never two in-flight writers (same-step collisions)
        if blocking:
            self._write(step, flat, meta)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, flat, meta), daemon=True
            )
            self._thread.start()

    def _write_guarded(self, step, flat, meta):
        try:
            self._write(step, flat, meta)
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return unflatten_tree(template, flat), step

    # ---------------------------------------------------------- util
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
