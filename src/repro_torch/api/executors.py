"""Executor registry: how a planned PMVC actually runs.

An executor is a factory ``(session: SparseSession) -> Callable[[x],
y]``; the returned closure is **batch-first**: it maps a length-M numpy
vector to the length-N product, or a ``[B, M]`` stack of right-hand
sides to the ``[B, N]`` stack of products through one SpMM.

Built-ins:

* ``"simulate"`` — every unit on the session's device, through the
  hand-written Block-ELL SpMM kernel (one launch per contraction for all
  units): the ``shard_map`` step below over one rank with no process
  group (:class:`repro_torch.pmvc.dist.LocalCommunicator`). Honors the
  session's exchange strategy: replicated, the emulated selective
  all_to_all, or the overlapped local/halo split.
  Plan arrays are hoisted to the device once, when the executor is
  built.
* ``"shard_map"`` — the units over the ranks of a ``torch.distributed``
  process group, one rank per card (units stacked when a rank holds
  several): the JAX package's executor of that name, on
  :func:`repro_torch.pmvc.dist.make_pmvc_step`. SPMD: every rank plans
  the same matrix and calls ``spmv`` with the same x, and every rank
  gets the whole y. Building it without an initialised process group
  raises ``RuntimeError``; nothing runs the units on one device in its
  place.
* ``"reference"`` — the thesis' sequential CSR algorithm (ch.1 §5),
  accumulated in float64 on the host: the oracle every other cell is
  pinned against.

Executors are built at a session's first ``spmv`` through them, so an
archive whose meta names ``shard_map`` loads anywhere and runs in a
process group.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from repro_torch.api.registry import Registry
from repro_torch.pmvc.dist import make_pmvc_step, make_unit_mesh, pad_x, unblock_y
from repro_torch.sparse.formats import csr_from_coo

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.api.session import SparseSession

__all__ = ["EXECUTORS", "register_executor"]

EXECUTORS = Registry("executor")
register_executor = EXECUTORS.register

SpmvFn = Callable[[np.ndarray], np.ndarray]


@EXECUTORS.register("reference")
def reference_executor(session: "SparseSession") -> SpmvFn:
    csr = csr_from_coo(session.matrix)
    val64 = csr.val.astype(np.float64)
    col = np.asarray(csr.col)
    nrows = csr.shape[0]
    # Segment boundaries for the row-sum: starts of the non-empty rows.
    # Consecutive non-empty starts bound exactly one row's elements (empty
    # rows contribute no entries in between), so one reduceat replaces the
    # per-row Python loop; empty rows keep their zero.
    lengths = np.diff(csr.ptr)
    nonempty = np.nonzero(lengths > 0)[0]
    starts = np.asarray(csr.ptr[:-1])[nonempty]

    def spmv(x: np.ndarray) -> np.ndarray:
        xf = np.asarray(x, dtype=np.float64)
        squeeze = xf.ndim == 1
        x2 = xf[None] if squeeze else xf
        y = np.zeros((x2.shape[0], nrows), dtype=np.float64)
        if starts.size:
            y[:, nonempty] = np.add.reduceat(val64 * x2[:, col], starts, axis=1)
        out = y.astype(np.float32)
        return out[0] if squeeze else out

    return spmv


@EXECUTORS.register("simulate")
def simulate_executor(session: "SparseSession") -> SpmvFn:
    mv = session.device_spmm()
    device = session.device

    def spmv(x: np.ndarray) -> np.ndarray:
        xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
        # Row-major out, as the JAX package's arrays are: numpy's reductions
        # over axis -1 (the steppers' norms and dots) sum a row in an order
        # that depends on the layout, so a transposed [B, N] view would
        # round row j of a batch apart from the same row alone.
        return mv(xt).contiguous().cpu().numpy()

    return spmv


@EXECUTORS.register("shard_map")
def shard_map_executor(session: "SparseSession") -> SpmvFn:
    dp = session.device_plan
    step = make_pmvc_step(
        dp,
        make_unit_mesh(dp.num_units),
        selective=session.selective,
        device=session.device,
        transform=session.tile_transform,
    )
    n, ncb, bn = dp.shape[0], dp.num_col_blocks, dp.bn
    device = session.device

    def spmv(x: np.ndarray) -> np.ndarray:
        xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return unblock_y(step(pad_x(xt, ncb, bn)), n).contiguous().cpu().numpy()

    return spmv
