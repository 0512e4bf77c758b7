"""Sharding rules: param/optimizer/batch/decode-state PartitionSpecs.

The JAX package's name-based rules over flattened tree paths,
parameterized by mesh axis sizes — a dimension is sharded only when
divisible (GQA kv-heads smaller than the model axis stay replicated
rather than padded; see DESIGN.md §6). ZeRO-1 adds the ``data`` axis to
the first free dim of optimizer-state leaves. The specs are the port's
:class:`~repro_torch.runtime.elastic.PartitionSpec`; a
:class:`NamedSharding` turns one into DTensor placements on a
``DeviceMesh`` and :func:`place` distributes a tree by them.

**Per-layer leaves.** The reference stacks each layer's weights on a
leading ``[L, ...]`` axis and gives it a leading ``None``; the port keeps
one leaf per layer (``layers/3/attn/wq``), so its spec is the
reference's with that entry dropped. One consequence differs on
purpose: where the reference's ZeRO-1 finds the stacked layer axis the
first free divisible dim (L % data == 0: 48, 32 and 64 layers on the
production meshes), it shards the moments over layers; the port's
per-layer moment has no such axis and takes its own first free divisible
dim instead. The bytes per device are the same wherever that dim exists;
a per-layer leaf with none (a vector too short to split) stays
replicated over ``data``. The decode caches are stacked ``[L, ...]`` in
both packages, and their specs are the reference's entry for entry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.config import ArchConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes_of
from repro_torch.models.common import Params
from repro_torch.runtime.elastic import P, PartitionSpec, placements

__all__ = [
    "NamedSharding",
    "param_spec",
    "param_shardings",
    "opt_shardings",
    "batch_shardings",
    "decode_state_shardings",
    "tree_path_map",
    "place",
]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh. ``placements`` are its DTensor placements, on a
    ``DeviceMesh`` (an abstract mesh has none)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _div(n: int, mesh, axis: str) -> bool:
    sizes = axis_sizes(mesh)
    return axis in sizes and n % sizes[axis] == 0


def _m(mesh, n: int) -> Optional[str]:
    """'model' if the dim divides the model axis, else replicate."""
    return "model" if _div(n, mesh, "model") else None


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf: a module's weights under their
    names (a list of blocks by index), dict keys, named tuples' fields,
    list and tuple indices."""
    if isinstance(tree, nn.ModuleList):
        for i, sub in enumerate(tree):
            yield from _walk(sub, path + (str(i),))
    elif isinstance(tree, nn.Module):
        for k, p in tree._parameters.items():
            yield "/".join(path + (k,)), p
        for k, sub in tree._modules.items():
            yield from _walk(sub, path + (k,))
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def tree_path_map(fn: Callable[[str, Any], Any], tree: Any) -> Dict[str, Any]:
    """``{path: fn(path, leaf)}`` over every leaf of ``tree``, where
    ``path`` is the leaf's place joined by ``/`` (``layers/3/attn/wq``,
    ``mu/embed``, ``kv_k``)."""
    return {path: fn(path, leaf) for path, leaf in _walk(tree)}


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def _spec(*entries) -> P:
    return P(*entries)


def _replicate(shape) -> P:
    return P(*(None,) * len(shape))


def param_spec(path: str, leaf, cfg: ArchConfig, mesh, *, kv_fsdp: bool = False) -> P:
    """The spec of the weight at ``path``: the reference's rule on a
    per-layer leaf (no leading layer axis)."""
    shape = tuple(leaf.shape)
    name = path.rsplit("/", 1)[-1]

    if name == "embed":
        # Vocab-sharded when divisible (NEZGT-balanced gather load);
        # feature-sharded fallback for awkward vocab sizes (seamless).
        if _div(shape[0], mesh, "model"):
            return P("model", None)
        return P(None, _m(mesh, shape[1]))
    if name == "lm_head":
        return P(None, _m(mesh, shape[1]))

    if "/attn/" in path or "/xattn/" in path:
        if name in ("wq", "wk", "wv"):  # [D, H, hd]
            # Head-sharded when heads divide the model axis. GQA kv
            # projections with too few heads: baseline uses input-dim
            # (row-parallel) sharding; the §Perf `kv_fsdp` optimization
            # shards them over the DATA axis instead.
            h_spec = _m(mesh, shape[1])
            if h_spec is not None:
                return _spec(None, h_spec, None)
            if kv_fsdp and _div(shape[0], mesh, "data"):
                return _spec("data", None, None)
            return _spec(_m(mesh, shape[0]), None, None)
        if name == "wo":  # [H, hd, D]
            h_spec = _m(mesh, shape[0])
            if h_spec is not None:
                return _spec(h_spec, None, None)
            if kv_fsdp and _div(shape[2], mesh, "data"):
                return _spec(None, None, "data")
            return _spec(None, None, _m(mesh, shape[2]))
        return _replicate(shape)

    if "/moe/" in path:
        if name == "router":
            return _replicate(shape)
        # expert weights [E, ...] — experts on the model axis
        return _spec(_m(mesh, shape[0]), *(None,) * (len(shape) - 1))

    if "/mlp/" in path:
        if name in ("w_gate", "w_up"):  # [D, F]
            return _spec(None, _m(mesh, shape[1]))
        if name == "w_down":  # [F, D]
            return _spec(_m(mesh, shape[0]), None)
        return _replicate(shape)

    if "/ssm/" in path:
        if name in ("w_z", "w_x", "w_dt"):  # [D, Din|H]
            return _spec(None, _m(mesh, shape[1]))
        if name in ("w_b", "w_c"):
            return _replicate(shape)
        if name == "conv_w":  # [cw, Din]
            return _spec(None, _m(mesh, shape[1]))
        if name in ("conv_b", "norm", "a_log", "d_skip", "dt_bias"):
            return _spec(_m(mesh, shape[0]))
        if name == "out_proj":  # [Din, D]
            return _spec(_m(mesh, shape[0]), None)
        return _replicate(shape)

    return _replicate(shape)


def param_shardings(params: Any, cfg: ArchConfig, mesh, *, kv_fsdp: bool = False
                    ) -> Dict[str, NamedSharding]:
    return tree_path_map(
        lambda path, leaf: NamedSharding(mesh, param_spec(path, leaf, cfg, mesh,
                                                          kv_fsdp=kv_fsdp)),
        params,
    )


def opt_shardings(
    opt_state: Any,
    params_template: Any,
    cfg: ArchConfig,
    mesh,
    *,
    zero1: bool = True,
    kv_fsdp: bool = False,
) -> Dict[str, NamedSharding]:
    """Optimizer-state shardings: mirror the param spec, then (ZeRO-1)
    shard the first still-replicated dim over ``data`` when divisible —
    of the per-layer leaf (see the module's docstring)."""
    sizes = axis_sizes(mesh)

    def spec_for(path: str, leaf) -> NamedSharding:
        # mu/nu paths look like 'mu/<param path>' / 'nu/<param path>'.
        parts = path.split("/", 1)
        ppath = parts[1] if len(parts) > 1 else path
        if ppath == "step" or _ndim(leaf) == 0:
            return NamedSharding(mesh, P())
        base = param_spec(ppath, leaf, cfg, mesh, kv_fsdp=kv_fsdp)
        entries = list(base) + [None] * (_ndim(leaf) - len(base))
        data = sizes.get("data")
        if zero1 and data and "data" not in entries:
            for i, e in enumerate(entries):
                if e is None and leaf.shape[i] % data == 0 and leaf.shape[i] >= data:
                    entries[i] = "data"
                    break
        return NamedSharding(mesh, P(*entries))

    return tree_path_map(spec_for, opt_state)


def _batch_count(mesh) -> Tuple[Tuple[str, ...], int]:
    baxes = batch_axes_of(mesh)
    sizes = axis_sizes(mesh)
    return baxes, int(np.prod([sizes[a] for a in baxes])) if baxes else 1


def batch_shardings(batch: Any, mesh) -> Dict[str, NamedSharding]:
    """Token batches shard over (pod, data) when divisible; a batch of 1
    (long_500k) stays replicated — its KV/state shards over data/seq."""
    baxes, nb = _batch_count(mesh)

    def spec_for(path: str, leaf) -> NamedSharding:
        nd = _ndim(leaf)
        if nd == 0:
            return NamedSharding(mesh, P())
        if leaf.shape[0] % nb == 0 and leaf.shape[0] >= nb:
            return NamedSharding(mesh, P(baxes, *(None,) * (nd - 1)))
        return NamedSharding(mesh, P(*(None,) * nd))

    return tree_path_map(spec_for, batch)


def decode_state_shardings(state: Any, cfg: ArchConfig, mesh) -> Dict[str, NamedSharding]:
    """Decode caches: batch-shard when possible; otherwise sequence-shard
    KV over ``data`` (long-context) and head/channel-shard SSM state over
    ``model`` — the paper's partial-Y reduction pattern (DESIGN.md §3)."""
    baxes, nb = _batch_count(mesh)

    def spec_for(path: str, leaf) -> NamedSharding:
        name = path.rsplit("/", 1)[-1]
        if _ndim(leaf) == 0:
            return NamedSharding(mesh, P())
        if name in ("kv_k", "kv_v"):
            l, b, t, kv, hd = leaf.shape
            bspec = baxes if (b % nb == 0 and b >= nb) else None
            kvspec = _m(mesh, kv)
            # Sequence-shard the cache when neither batch (long-context)
            # nor kv-heads (GQA < model ranks) can take an axis.
            if bspec is None and _div(t, mesh, "data"):
                tspec = "data"
            elif kvspec is None and _div(t, mesh, "model"):
                tspec = "model"
            else:
                tspec = None
            return NamedSharding(mesh, P(None, bspec, tspec, kvspec, None))
        if name == "ssm":
            l, b, h, pd, n = leaf.shape
            bspec = baxes if (b % nb == 0 and b >= nb) else None
            hspec = _m(mesh, h)
            pspec = _m(mesh, pd) if hspec is None else None
            return NamedSharding(mesh, P(None, bspec, hspec, pspec, None))
        if name == "conv":
            l, b, w, din = leaf.shape
            bspec = baxes if (b % nb == 0 and b >= nb) else None
            return NamedSharding(mesh, P(None, bspec, None, _m(mesh, din)))
        if name == "mem":
            b, t, d = leaf.shape
            bspec = baxes if (b % nb == 0 and b >= nb) else None
            tspec = "data" if (bspec is None and _div(t, mesh, "data")) else None
            return NamedSharding(mesh, P(bspec, tspec, None))
        # pos and misc
        return NamedSharding(mesh, P(*(None,) * _ndim(leaf)))

    return tree_path_map(spec_for, state)


def _put(leaf: torch.Tensor, sharding: NamedSharding):
    # A dim of size 1 "sharded" over mesh axes of size 1 (a batch of one on
    # a mesh whose batch axes have one rank) is the same layout replicated,
    # and DTensor lets a view merge or drop it only so.
    pl = tuple(Replicate() if p.is_shard() and leaf.shape[p.dim] == 1 and sharding.mesh.size(i) == 1
               else p for i, p in enumerate(sharding.placements))
    if isinstance(leaf, DTensor):
        return leaf.detach().redistribute(sharding.mesh, pl)
    # Every rank holds the whole leaf (or a meta stand-in): each keeps its
    # block and no data moves between ranks.
    return distribute_tensor(leaf.detach(), sharding.mesh, pl, src_data_rank=None)


def place(tree: Any, shardings: Mapping[str, NamedSharding], path: Tuple[str, ...] = ()) -> Any:
    """``tree`` with every tensor distributed by ``shardings[path]`` (as
    the ``*_shardings`` functions give them; a DTensor is redistributed):
    a :class:`Params` module
    becomes one of DTensor weights, named tuples, dicts, lists and tuples
    keep their structure, and what is not a tensor (a host step count, a
    decode position) stays as it is. The counterpart of
    ``jax.device_put(tree, shardings)``."""
    if isinstance(tree, Params):
        prefix = "/".join(path) + "/" if path else ""
        return tree.map(lambda name, p: _put(p, shardings[prefix + name.replace(".", "/")]))
    if isinstance(tree, Mapping):
        return {k: place(v, shardings, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(place(getattr(tree, f), shardings, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, shardings, path + (str(i),)) for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return _put(tree, shardings["/".join(path)])
    return tree
