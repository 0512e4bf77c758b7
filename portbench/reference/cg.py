"""Conjugate gradients from ``z = 0``, as the program's device-loop CG
computes them: a row whose ``pᵀAp`` is under 1e-30 stops moving."""
import torch

from portbench.matrices import Matrix
from portbench.reference import Operator


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(dim=-1)


def solve(m: Matrix, b: torch.Tensor, iters: int, precision: str) -> torch.Tensor:
    op = Operator(m, precision, b.device)
    b = b.to(op.dtype)
    z = torch.zeros_like(b)
    r = b - op(z)
    p = r.clone()
    rs = _dot(r, r)
    for _ in range(iters):
        ap = op(p)
        denom = _dot(p, ap)
        ok = denom.abs() >= 1e-30
        alpha = torch.where(ok, rs / torch.where(ok, denom, torch.ones_like(denom)), 0.0)
        z_new = z + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        rs_new = _dot(r_new, r_new)
        p_new = r_new + (rs_new / rs.clamp(min=1e-30))[:, None] * p
        sel = ok[:, None]
        z, r, p = torch.where(sel, z_new, z), torch.where(sel, r_new, r), torch.where(sel, p_new, p)
        rs = torch.where(ok, rs_new, rs)
    return z
