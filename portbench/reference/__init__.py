"""The plain reference: the program's solvers over a CSR-free COO
product in plain PyTorch, in float64 (the reference) or in TF32 (the
control: the nearest precision below the float32 that the
configurations state, with float32 vectors and dots).

It is built from the matrices that :mod:`portbench.matrices` made and
imports nothing of the program. One module a solver
(``reference/<solver>.py``, found by the traffic's ``solver`` in the
cell's checkout, as its generator and readers are) follows the
arithmetic that the program's solver of that name documents, iteration
for iteration, with ``tol`` 0.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench import load
from portbench.matrices import Matrix

__all__ = ["Operator", "round_tf32", "solve", "PRECISIONS"]

PRECISIONS = ("float64", "tf32")
# Rows of x gathered at once: the product of a chunk is [chunk, nnz].
_CHUNK_ELEMS = 64 * 2**20


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 stored mantissa bits, to nearest,
    ties to even: what a TF32 tensor core reads of a float32 input."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32)


class Operator:
    """``x -> A x`` over ``[B, n]`` blocks. float64: every product and sum
    in float64. tf32: A's values and x rounded to TF32, products summed
    in float32."""

    def __init__(self, m: Matrix, precision: str, device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.n = m.n
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.row = torch.as_tensor(m.row.astype(np.int64), device=device)
        self.col = torch.as_tensor(m.col.astype(np.int64), device=device)
        v = torch.as_tensor(m.val, device=device)
        self.val = v.double() if precision == "float64" else round_tf32(v.float())

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.precision == "tf32":
            x = round_tf32(x)
        y = torch.zeros(x.shape[0], self.n, dtype=self.dtype, device=x.device)
        step = max(1, _CHUNK_ELEMS // max(1, self.val.shape[0]))
        for lo in range(0, x.shape[0], step):
            prod = x[lo:lo + step, self.col] * self.val
            y[lo:lo + step].index_add_(1, self.row, prod)
        return y


def solve(solver: str, m: Matrix, payload: np.ndarray, iters: int, precision: str,
          device, root: Optional[str] = None) -> np.ndarray:
    """The reference's answer ``[B, n]`` (float64 numpy) to ``solver`` on
    ``m`` for the payload block ``[B, n]``, by ``reference/<solver>.py``
    of the checkout ``root`` or of this package (:func:`portbench.load`)."""
    x = torch.as_tensor(np.asarray(payload, np.float32), device=device)
    with torch.no_grad():
        out = load("reference", solver, root).solve(m, x, iters, precision)
    return out.double().cpu().numpy()
