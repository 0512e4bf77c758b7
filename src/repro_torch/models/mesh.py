"""The device-mesh context the models run in, and their mesh helpers.

:class:`MeshCtx` is the JAX package's (``repro.models.moe.MeshCtx``, also
exported from :mod:`repro_torch.models.moe`): a mesh and its axis names,
the mesh a ``torch.distributed`` ``DeviceMesh`` with named dimensions.
On one, the weights and the batch are DTensors, and the models run under
:func:`mesh_scope`. What DTensor cannot propagate as the reference's
GSPMD does runs per shard through ``local_map`` with explicit
collectives: the MoE layer's branches, the attention core and the
decode step, the SSD, and the vocab-sharded embedding
(:func:`embed_lookup`) and loss (:func:`token_nll`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

__all__ = ["MeshCtx", "mesh_scope", "as_dtensor", "sum_over_ranks", "wait", "embed_lookup",
           "token_nll", "whole"]


class MeshCtx:
    """Mesh + axis-name context threaded through models.

    ``batch_axes`` shard the token batch; ``model_axis`` shards heads /
    ffn / experts. ``mesh`` is a ``DeviceMesh`` with named dimensions, or
    ``None`` for the single-device path (smoke tests).
    """

    def __init__(
        self,
        mesh=None,
        batch_axes: Tuple[str, ...] = ("data",),
        model_axis: str = "model",
    ):
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.model_axis = model_axis

    def axis_size(self, name: str) -> int:
        """The mesh's size along ``name``; 1 for an axis it lacks."""
        names = tuple(self.mesh.mesh_dim_names or ())
        return self.mesh.size(names.index(name)) if name in names else 1

    @property
    def model_ranks(self) -> int:
        if self.mesh is None:
            return 1
        if self.model_axis not in (self.mesh.mesh_dim_names or ()):
            raise KeyError(self.model_axis)
        return self.axis_size(self.model_axis)

    @property
    def batch_ranks(self) -> int:
        """The number of batch shards: the product of the batch axes' sizes."""
        n = 1
        for a in self.batch_axes:
            n *= self.axis_size(a)
        return n

    def batch_shard(self, n: int):
        """The placement over the batch axes of a batch of ``n``: sharded
        where it divides, as the sharding rules place it, else (and for a
        batch of one) replicated."""
        return Shard(0) if n > 1 and n % self.batch_ranks == 0 else Replicate()

    def placements(self, **by_axis) -> tuple:
        """DTensor placements over the mesh: ``by_axis[name]`` on each named
        dimension (``batch=`` for every batch axis), ``Replicate()`` on
        the others."""
        batch = by_axis.pop("batch", None)
        out = []
        for name in self.mesh.mesh_dim_names:
            if name in by_axis:
                out.append(by_axis[name])
            elif batch is not None and name in self.batch_axes:
                out.append(batch)
            else:
                out.append(Replicate())
        return tuple(out)


def as_dtensor(t, ctx: MeshCtx):
    """A plain tensor on a mesh is the same on every rank: replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ctx.mesh, ctx.placements(), run_check=False)


_scopes = threading.local()


@contextlib.contextmanager
def _implicit_replication() -> Iterator[None]:
    """``torch.distributed.tensor.experimental.implicit_replication``, but
    nestable: only the outermost block of a thread enters it (the
    library's turns the setting off on leaving, which would end an
    enclosing block's too)."""
    depth = getattr(_scopes, "depth", 0)
    _scopes.depth = depth + 1
    try:
        if depth:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _scopes.depth = depth


def mesh_scope(ctx: Optional[MeshCtx]):
    """The context a model runs in: on a mesh, implicit replication, under
    which the plain tensors a model makes for itself (rope tables, masks,
    zeros) enter DTensor ops as replicated; without one, nothing. The
    train step runs its backward pass inside it too."""
    if ctx is None or ctx.mesh is None:
        return contextlib.nullcontext()
    return _implicit_replication()


def wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _SumOverRanks(torch.autograd.Function):
    """``psum`` of the ranks' partial outputs into the replicated output.
    Its backward is the identity: each rank's partial output reaches the
    sum once, and the sum's gradient is already whole on every rank (the
    inputs' gradients are then partial over the axis, which ``local_map``
    is told)."""

    @staticmethod
    def forward(ctx, y, group):
        return wait(funcol.all_reduce(y, "sum", group))

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def _done(t: DTensor) -> Optional[DTensor]:
    """``t`` with every sum still pending over a mesh axis done (Partial
    made Replicate), or None when none is pending."""
    if not any(p.is_partial() for p in t.placements):
        return None
    return t.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in t.placements])


def whole(t: DTensor) -> DTensor:
    """``t`` made whole, and its gradient made whole when it comes back,
    as Megatron's all-reduces do around a tensor-parallel block. Left
    partial (a row-parallel product's output, or the gradient of the
    column-parallel products that read ``t``), the products next to it
    would gather their weights and repeat the work on every rank:
    DTensor's cost model weighs the bytes it moves, not the operations."""
    done = _done(t)
    t = t if done is None else done
    if t.requires_grad:
        t.register_hook(_done)
    return t


def sum_over_ranks(y: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial ``y`` summed over ``group`` (a ``psum``), with
    the identity as its backward (:class:`_SumOverRanks`)."""
    return _SumOverRanks.apply(y, group)


def _vocab_rows(embed, ids, *, first: int, group) -> torch.Tensor:
    """This rank's rows ``[first, first + len(embed))`` of a vocab-sharded
    embedding looked up for ``ids``, zeros for the others, summed over
    the model axis: each token's row comes from one rank and zeros from
    the rest, so the sum is the row exactly."""
    mine = (ids >= first) & (ids < first + embed.shape[0])
    rows = embed[torch.where(mine, ids - first, 0)] * mine[..., None].to(embed.dtype)
    return sum_over_ranks(rows, group)


def embed_lookup(embed: torch.Tensor, tokens, ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """``embed[tokens]`` for integer ``tokens`` (a tensor or numpy array,
    moved to the embedding's device). Without a mesh, the gather. On a
    mesh the lookup runs per shard (``local_map``) with the embedding's
    own placement: a vocab-sharded one (``P("model", None)``) as the
    Megatron vocab-parallel lookup (masked rows, summed over the model
    axis), a feature-sharded or replicated one as a local gather. The
    tokens keep their batch sharding; each batch shard's gradient of the
    embedding is partial over the batch axes."""
    ids = torch.as_tensor(tokens, device=embed.device).long()
    if ctx is None or ctx.mesh is None:
        return embed[ids]
    embed, ids = as_dtensor(embed, ctx), as_dtensor(ids, ctx)
    names = tuple(ctx.mesh.mesh_dim_names)
    m = names.index(ctx.model_axis)
    on_model = embed.placements[m]
    batch = Shard(0) if any(ids.placements[names.index(a)] == Shard(0)
                            for a in ctx.batch_axes if a in names) else Replicate()
    ids_pl = ctx.placements(batch=batch)
    embed_grad = ctx.placements(batch=Partial() if batch == Shard(0) else Replicate(),
                                **{ctx.model_axis: on_model})
    if on_model == Shard(0):
        rows = embed.shape[0] // ctx.model_ranks
        fn = functools.partial(_vocab_rows, first=ctx.mesh.get_local_rank(ctx.model_axis) * rows,
                               group=ctx.mesh.get_group(ctx.model_axis))
        out = ctx.placements(batch=batch)
    else:
        def fn(e, i):
            return e[i]
        out = ctx.placements(batch=batch, **{ctx.model_axis: Shard(2) if on_model == Shard(1)
                                             else Replicate()})
    return local_map(fn, out_placements=list(out), in_placements=(embed.placements, ids_pl),
                     in_grad_placements=(embed_grad, ids_pl), device_mesh=ctx.mesh,
                     redistribute_inputs=True)(embed, ids)


def _local_nll(logits, labels, *, first: int, group) -> torch.Tensor:
    """-log softmax at ``labels`` over a vocab split across ``group``:
    this rank holds columns ``[first, first + V_loc)``. The max and the
    sum of exponentials are reduced over the ranks, the label's logit
    comes from the rank that holds it."""
    lf = logits.float()
    m = wait(funcol.all_reduce(lf.amax(dim=-1).detach(), "max", group))
    total = sum_over_ranks(torch.exp(lf - m[..., None]).sum(dim=-1), group)
    mine = (labels >= first) & (labels < first + lf.shape[-1])
    idx = torch.where(mine, labels - first, 0).long()
    gold = torch.take_along_dim(lf, idx[..., None], dim=-1)[..., 0] * mine.to(lf.dtype)
    return torch.log(total) + m - sum_over_ranks(gold, group)


def token_nll(logits: DTensor, labels) -> DTensor:
    """-log p(label) per token of DTensor logits [..., V] (float32), the
    reference's cross-entropy before its mean. Logits sharded over the
    vocab stay so: each rank reduces its columns and the ranks combine
    the max, the sum of exponentials and the label's logit (the
    vocab-parallel loss); others are made whole over the vocab first."""
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = tuple(Replicate() if p.is_partial() else p for p in logits.placements)
    vocab = [i for i, p in enumerate(pl) if p.is_shard(last)]
    if len(vocab) != 1:
        pl = tuple(Replicate() if p.is_shard(last) else p for p in pl)
    label_pl = tuple(Replicate() if p.is_shard(last) else p for p in pl)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if len(vocab) != 1:
        logits = logits.redistribute(mesh, pl).float()
        labels = labels.redistribute(mesh, label_pl)
        logz = torch.logsumexp(logits, dim=-1)
        return logz - torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    d = vocab[0]
    per_rank = -(-logits.shape[-1] // mesh.size(d))
    fn = functools.partial(_local_nll, first=mesh.get_local_rank(d) * per_rank,
                           group=mesh.get_group(d))
    return local_map(fn, out_placements=list(label_pl), in_placements=(pl, label_pl),
                     in_grad_placements=(pl, label_pl), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)
