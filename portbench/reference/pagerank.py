"""PageRank as the program's ``pagerank(normalize="auto")`` documents it
(``repro_torch.api.solvers.pagerank``), with ``tol`` 0:
``r ← d·(P r + m(r)·s) + (1 − d)·s`` over the column-stochastic link
matrix ``P = |A|·D⁻¹``, ``D = diag(Σᵢ |Aᵢⱼ|)``, where ``m(r)`` is the mass
on the dangling columns (those with no entry, restarted at the
teleport), damping ``d`` 0.85, each row of the teleport ``s`` normalised
to L1 mass 1, the start at ``s``, and ``r`` renormalised to L1 mass 1
after every step, for a fixed ``iters``.

It departs from the program in its arithmetic alone: the product runs
over the COO matrix (:class:`~portbench.reference.Operator`, no tiles,
no plan), and ``D⁻¹``, the teleport and the dangling mass are in the
reference's precision (float64), where the program keeps them in
float32. In TF32 (the control) ``|A|`` and ``P``'s input are rounded to
TF32 and the rest is float32.
"""
import numpy as np
import torch

from portbench.matrices import Matrix
from portbench.reference import Operator

DAMPING = 0.85


def solve(m: Matrix, seeds: torch.Tensor, iters: int, precision: str) -> torch.Tensor:
    op = Operator(Matrix(m.n, m.row, m.col, np.abs(m.val)), precision, seeds.device)
    colsum = np.bincount(m.col, weights=np.abs(m.val.astype(np.float64)), minlength=m.n)
    inv = np.where(colsum > 0, 1.0 / np.maximum(colsum, 1e-300), 0.0)
    inv = torch.as_tensor(inv, dtype=op.dtype, device=seeds.device)
    dangling = torch.as_tensor(colsum == 0, dtype=op.dtype, device=seeds.device)
    s = seeds.to(op.dtype)
    s = s / s.abs().sum(dim=-1, keepdim=True)
    r = s
    for _ in range(iters):
        mass = (r * dangling).sum(dim=-1, keepdim=True)
        r = DAMPING * (op(r * inv) + mass * s) + (1.0 - DAMPING) * s
        r = r / r.abs().sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return r
