"""Executor registry: how a planned PMVC actually runs.

An executor is a factory ``(session: SparseSession) -> Callable[[x],
y]``; the returned closure is **batch-first**: it maps a length-M numpy
vector to the length-N product, or a ``[B, M]`` stack of right-hand
sides to the ``[B, N]`` stack of products through one SpMM.

Built-ins:

* ``"simulate"`` — every unit on the session's device, through the
  hand-written Block-ELL SpMM kernel (one launch per contraction for all
  units). Honors the session's exchange strategy: replicated, the
  emulated selective all_to_all, or the overlapped local/halo split.
  Plan arrays are hoisted to the device once, when the executor is
  built.
* ``"reference"`` — the thesis' sequential CSR algorithm (ch.1 §5),
  accumulated in float64 on the host: the oracle every other cell is
  pinned against.

The JAX package's ``"shard_map"`` (one unit per device) is not
registered yet; asking for it raises ``KeyError``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from repro_torch.api.registry import Registry
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
