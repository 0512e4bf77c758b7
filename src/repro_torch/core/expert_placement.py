"""MoE expert→device placement via the paper's machinery (DESIGN.md §3).

A copy of the JAX package's ``repro/core/expert_placement.py`` on the
port's own ``nezgt``, ``hypergraph`` and ``sparse.formats``, so that both
packages place experts identically; :func:`apply_placement` permutes
numpy arrays or tensors.

The token→expert assignment matrix is sparse (tokens = rows, experts =
columns). Placing experts on devices is its column-distribution problem:

* **Balance** — NEZGT_colonne over expert load estimates (tokens routed
  per expert) balances active-expert load per device; imbalance
  materializes as capacity-overflow token drops, the MoE analogue of the
  paper's LB_cores.
* **Communication** — experts frequently co-activated by the same token
  (top-k routing picks k experts per token) should share a device: each
  token's activation is then sent to fewer devices. We build the
  co-activation hypergraph (vertices = experts, nets = tokens) and
  partition it under the NEZGT balance bound; the (λ−1) cut counts the
  duplicate token sends — exactly the paper's C_Xk fan-out volume.

``plan_placement`` returns the permutation applied to the stacked expert
weights so device r owns experts ``perm[r*E_loc:(r+1)*E_loc]``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hypergraph import (
    Hypergraph,
    connectivity_cut,
    hypergraph_from_coo,
    partition_hypergraph,
)
from repro_torch.core.nezgt import nezgt_partition
from repro_torch.sparse.formats import COO

__all__ = ["PlacementResult", "plan_placement", "coactivation_hypergraph", "apply_placement"]


@dataclasses.dataclass(frozen=True)
class PlacementResult:
    perm: np.ndarray  # [E] expert order; device r owns perm[r*E_loc:(r+1)*E_loc]
    device_of_expert: np.ndarray  # [E]
    loads: np.ndarray  # [ranks] routed-token load per device
    lb: float  # max/avg device load
    cut: int  # co-activation (λ-1) cut (token fan-out duplicates)
    cut_naive: int  # cut of the contiguous (unpermuted) placement


def coactivation_hypergraph(
    expert_of_token: np.ndarray,  # [T, k] top-k expert ids per token
    num_experts: int,
) -> Hypergraph:
    """Vertices = experts, nets = tokens (each net pins its k experts)."""
    t, k = expert_of_token.shape
    row = expert_of_token.reshape(-1).astype(np.int32)  # vertex (expert)
    col = np.repeat(np.arange(t, dtype=np.int32), k)  # net (token)
    coo = COO((num_experts, t), row, col, np.ones(t * k, np.float32))
    return hypergraph_from_coo(coo, mode="rows")


def plan_placement(
    expert_of_token: np.ndarray,  # [T, k] router sample (host statistics)
    num_experts: int,
    ranks: int,
    *,
    mode: str = "hyper",  # 'hyper' (balance+comm) | 'nezgt' (balance only)
    seed: int = 0,
) -> PlacementResult:
    if num_experts % ranks:
        raise ValueError(f"E={num_experts} not divisible by ranks={ranks}")
    e_loc = num_experts // ranks
    loads_per_expert = np.bincount(
        expert_of_token.reshape(-1), minlength=num_experts
    ).astype(np.int64)

    if mode == "nezgt":
        res = nezgt_partition(loads_per_expert, ranks)
        device_of_expert = res.assignment.copy()
    else:
        graph = coactivation_hypergraph(expert_of_token, num_experts)
        res = partition_hypergraph(graph, ranks, epsilon=0.15, seed=seed)
        device_of_expert = res.assignment.copy()

    # Enforce exactly E/ranks experts per device (SPMD equal shapes):
    # move surplus experts (lightest first) to deficient devices.
    counts = np.bincount(device_of_expert, minlength=ranks)
    order = np.argsort(loads_per_expert)  # lightest first
    for e in order:
        d = device_of_expert[e]
        if counts[d] > e_loc:
            tgt = int(np.argmin(counts))
            if counts[tgt] < e_loc:
                device_of_expert[e] = tgt
                counts[d] -= 1
                counts[tgt] += 1

    perm = np.argsort(device_of_expert, kind="stable").astype(np.int32)
    dev_loads = np.bincount(
        device_of_expert, weights=loads_per_expert, minlength=ranks
    )
    avg = dev_loads.mean()
    lb = float(dev_loads.max() / avg) if avg > 0 else 1.0

    graph = coactivation_hypergraph(expert_of_token, num_experts)
    cut = connectivity_cut(graph, device_of_expert, ranks)
    naive = np.arange(num_experts) // e_loc
    cut_naive = connectivity_cut(graph, naive.astype(np.int32), ranks)
    return PlacementResult(
        perm=perm,
        device_of_expert=device_of_expert.astype(np.int32),
        loads=dev_loads.astype(np.int64),
        lb=lb,
        cut=cut,
        cut_naive=cut_naive,
    )


def apply_placement(params_moe: dict, perm: np.ndarray) -> dict:
    """Statically permute stacked expert weights (and router columns) so
    contiguous expert slots land on the NEZGT/hypergraph-chosen device.
    The weights are numpy arrays or tensors (the index goes to a tensor's
    device)."""
    out = dict(params_moe)
    router = params_moe["router"]
    p = (torch.as_tensor(np.asarray(perm, np.int64), device=router.device)
         if isinstance(router, torch.Tensor) else np.asarray(perm))
    out["router"] = router[:, p]
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = params_moe[k][p]
    return out
