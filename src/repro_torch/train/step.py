"""Train step: loss, gradient accumulation, remat, optimizer update.

The JAX package's ``make_train_step`` with autograd in place of
``jax.value_and_grad``: the weights of the module being trained require
gradients for the length of the step only (they are made without, so
that decoding never records a graph), and the step updates them and the
optimizer's moments in place.

**Determinism.** The reference's loop promises a bit-exact resume. On
the card the backward of a gather may accumulate with atomics, and a
floating-point ``cumsum`` has no deterministic CUDA kernel, so the step
runs under ``torch.use_deterministic_algorithms(True)``: PyTorch then
takes a deterministic kernel for every op that has one and raises for
any that has not, instead of falling back (the SSD's cumsum takes a
product in that mode, :func:`repro_torch.models.ssm._cumsum`). cuBLAS
is deterministic on one stream only with ``CUBLAS_WORKSPACE_CONFIG`` set
to ``:4096:8`` or ``:16:8``, which PyTorch checks once, at the process's
first cuBLAS call: importing :mod:`repro_torch` sets ``:4096:8`` unless
the caller set it before.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import TrainConfig
from repro_torch.models.api import Model
from repro_torch.models.common import Params, cross_entropy
from repro_torch.models.moe import MeshCtx, mesh_scope
from repro_torch.optim.adamw import OptState, opt_update

__all__ = ["loss_fn", "value_and_grad", "make_train_step", "deterministic", "TrainState"]

TrainState = Tuple[Params, OptState]  # (params, opt_state)


_MODE_LOCK = threading.Lock()
_mode_holders = 0  # blocks inside deterministic(), across threads
_mode_before: Tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """``torch.use_deterministic_algorithms(True)`` for the block. The
    mode is process-wide, so the blocks of all threads share it: the
    first block to enter saves the setting it found and turns the mode
    on, and the last to leave restores that setting. Another thread
    running a model meanwhile runs under the mode too."""
    global _mode_holders, _mode_before
    with _MODE_LOCK:
        if _mode_holders == 0:
            _mode_before = (torch.are_deterministic_algorithms_enabled(),
                            torch.is_deterministic_algorithms_warn_only_enabled())
            torch.use_deterministic_algorithms(True)
        _mode_holders += 1
    try:
        yield
    finally:
        with _MODE_LOCK:
            _mode_holders -= 1
            if _mode_holders == 0:
                mode, warn_only = _mode_before
                torch.use_deterministic_algorithms(mode, warn_only=warn_only)


@contextlib.contextmanager
def _trainable(params: Params) -> Iterator[list]:
    """The module's weights with gradients on for the block, each weight's
    previous flag restored after it."""
    weights = list(params.parameters())
    before = [w.requires_grad for w in weights]
    for w in weights:
        w.requires_grad_(True)
    try:
        yield weights
    finally:
        for w, flag in zip(weights, before):
            w.requires_grad_(flag)


def loss_fn(
    model: Model,
    params: Params,
    batch: Dict[str, Any],
    ctx: Optional[MeshCtx],
    train_cfg: TrainConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = model.forward(params, batch, ctx, remat=train_cfg.remat)
    tokens = torch.as_tensor(batch["tokens"], device=logits.device)
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
    loss = ce + train_cfg.moe_aux_weight * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def value_and_grad(
    model: Model,
    params: Params,
    batch: Dict[str, Any],
    ctx: Optional[MeshCtx],
    train_cfg: TrainConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(loss, metrics, gradients by weight name): ``jax.value_and_grad``
    of :func:`loss_fn` with ``has_aux``, deterministic. A weight the loss
    does not reach gets a zero gradient, as in JAX."""
    names = [n for n, _ in params.named_parameters()]
    with deterministic(), torch.enable_grad(), _trainable(params) as weights:
        loss, metrics = loss_fn(model, params, batch, ctx, train_cfg)
        grads = torch.autograd.grad(loss, weights, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))


def make_train_step(
    model: Model,
    train_cfg: TrainConfig,
    ctx: Optional[MeshCtx] = None,
):
    """Returns step(params, opt_state, batch, rng) -> (params, opt, metrics).

    ``rng`` is a ``torch.Generator`` on the weights' device (or None): the
    int8 compression's noise is drawn from it. ``params`` and the state's
    moments are updated in place; the returned state holds the new step.

    Gradient accumulation: every leaf of the global batch (the tokens,
    and the frames of the encoder-decoder family) is split into
    ``train_cfg.microbatches`` equal microbatches of consecutive rows, run
    in sequence; their gradients are summed in float32 and divided by the
    count, as are the losses. The metrics are then the reference's:
    ``ce`` is the mean loss and ``aux`` is 0. A batch with a leaf whose
    rows do not split evenly is refused with ``ValueError`` before any
    work (the reference's reshape raises ``TypeError`` for it).

    On a mesh (``ctx`` over a ``DeviceMesh``, weights and batch DTensors
    placed by :mod:`repro_torch.launch.shardings`) the whole step runs
    under :func:`~repro_torch.models.moe.mesh_scope`; the metrics come
    back whole, as plain tensors.
    """

    def step(params: Params, opt_state: OptState, batch, rng=None):
        m = train_cfg.microbatches
        if m > 1:
            uneven = {k: v.shape[0] for k, v in batch.items() if v.shape[0] % m}
            if uneven:
                raise ValueError(f"microbatches={m} does not divide the batch's rows: "
                                 + ", ".join(f"{k} has {n}" for k, n in uneven.items()))
        with deterministic(), mesh_scope(ctx):
            if m <= 1:
                loss, metrics, grads = value_and_grad(model, params, batch, ctx, train_cfg)
            else:
                split = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])
                         for k, v in batch.items()}
                acc: Dict[str, torch.Tensor] = {}
                loss_sum = None
                for i in range(m):
                    micro = {k: v[i] for k, v in split.items()}
                    loss, _, g = value_and_grad(model, params, micro, ctx, train_cfg)
                    for n, gn in g.items():
                        acc[n] = gn.float() if i == 0 else acc[n] + gn.float()
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                count = loss_sum.new_tensor(float(m))
                grads = {n: a / count for n, a in acc.items()}
                loss = loss_sum / count
                metrics = {"loss": loss, "ce": loss, "aux": torch.zeros_like(loss)}
            params, opt_state, opt_metrics = opt_update(
                params, grads, opt_state, train_cfg, compress_rng=rng
            )
            metrics = dict(metrics)
            metrics.update(opt_metrics)
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return params, opt_state, metrics

    return step
