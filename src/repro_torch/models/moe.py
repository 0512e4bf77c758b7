"""Mixture-of-Experts layer and the mesh context threaded through models.

The JAX package's MoE layer on one device. Token→expert assignment is a
sparse matrix (tokens = rows, experts = columns):

* **Routing**: a float32 router picks each token's top-k experts
  (:func:`router_topk`, ties to the lower expert id as ``lax.top_k``) and
  gives the Switch-style load-balance loss.
* **Dispatch**: each token's copy is ranked within its expert's queue
  (:func:`_rank_within`: a one-hot cumsum, or a stable sort with
  ``moe_sort_dispatch``) and gathered into an ``[E, C, D]`` buffer;
  copies past the capacity ``C`` are dropped (:func:`_capacity`: the
  capacity factor in training and prefill, dropless in decode).
* **Compute and combine**: the experts' SwiGLU MLP as batched products,
  the outputs gathered back and summed with the gates.

:func:`moe_ffn_dense` computes the same function with every expert on
every token, as an oracle. The expert-parallel paths over a device mesh
(``shard_map`` with a ``psum``, and the ``all_to_all`` dispatch) are not
ported yet (ROADMAP.md, Queue 1, item 8e): a mesh raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.common import Params, dense_init, project

__all__ = ["init_moe", "moe_ffn", "moe_ffn_dense", "router_topk", "MeshCtx",
           "FLOAT32_PARAMS"]

_MESH_NOT_PORTED = "sharded model paths are not ported yet (ROADMAP.md, Queue 1, item 8e)"

# Parameters kept in float32 whatever the model's type: the router, so
# that top-k picks experts on float32 probabilities.
FLOAT32_PARAMS = ("router",)


class MeshCtx:
    """Mesh + axis-name context threaded through models.

    ``batch_axes`` shard the token batch; ``model_axis`` shards heads /
    ffn / experts. ``mesh=None`` is the single-device path, the only one
    the port has: a device mesh raises ``NotImplementedError``.
    """

    def __init__(
        self,
        mesh=None,
        batch_axes: Tuple[str, ...] = ("data",),
        model_axis: str = "model",
    ):
        if mesh is not None:
            raise NotImplementedError(f"{_MESH_NOT_PORTED}: pass mesh=None")
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.model_axis = model_axis


def init_moe(generator: torch.Generator, cfg: ArchConfig, dtype, device=None) -> Params:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return Params({
        "router": dense_init(generator, (d, e), fan_in=d, dtype=torch.float32, device=device),
        "w_gate": dense_init(generator, (e, d, f), fan_in=d, dtype=dtype, device=device),
        "w_up": dense_init(generator, (e, d, f), fan_in=d, dtype=dtype, device=device),
        "w_down": dense_init(generator, (e, f, d), fan_in=f, dtype=dtype, device=device),
    })


def router_topk(
    p: Params, x: torch.Tensor, cfg: ArchConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates [B,S,k] in x's type, expert ids [B,S,k], aux
    load-balance loss). The top k are the first k of a stable descending
    sort: of equal probabilities the lower expert id comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` promises no order among ties)."""
    logits = project(x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    e_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    e_idx = e_idx[..., : cfg.experts_per_token]
    gates = torch.gather(probs, -1, e_idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E * Σ_e (fraction_tokens_e * mean_prob_e) —
    # the differentiable surrogate of the paper's LB criterion.
    e = cfg.num_experts
    onehot = (e_idx[..., 0, None] == torch.arange(e, device=x.device)).float()
    frac = onehot.mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac * mean_prob)
    return gates.to(x.dtype), e_idx, aux


def _expert_mlp(x_e: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    h = torch.einsum("ecd,edf->ecf", x_e, wg)
    u = torch.einsum("ecd,edf->ecf", x_e, wu)
    h = F.silu(h) * u
    return torch.einsum("ecf,efd->ecd", h, wd)


def _rank_within(ids: torch.Tensor, n: int, sort_based: bool) -> torch.Tensor:
    """Position of each element in its id's queue (stable): a one-hot
    cumsum over ``n`` ids, or a stable sort and ``searchsorted``
    (O(m log m) work and O(m) memory instead of O(m·n))."""
    m = ids.shape[0]
    arange = torch.arange(m, device=ids.device)
    if sort_based:
        order = torch.sort(ids, stable=True).indices
        sorted_ids = ids[order]
        ranks_sorted = arange - torch.searchsorted(sorted_ids, sorted_ids, side="left")
        return torch.empty_like(ranks_sorted).index_put((order,), ranks_sorted)
    onehot = (ids[:, None] == torch.arange(n, device=ids.device)).to(torch.int32)
    return (torch.cumsum(onehot, dim=0) - 1)[arange, ids]


def _dispatch_compute_combine(
    x: torch.Tensor,  # [B, S, D]
    gates: torch.Tensor,  # [B, S, k]
    e_idx: torch.Tensor,  # [B, S, k]
    wg,  # [E, D, F]
    wu,
    wd,
    *,
    num_experts: int,
    capacity: int,
    sort_dispatch: bool = False,
) -> torch.Tensor:
    """Gather each token's k copies into ``[E, C, D]`` expert slots, run the
    experts, gather the outputs back and sum them with the gates. A copy
    ranked at or past ``capacity`` in its expert's queue is dropped: its
    slot is the buffer's extra last row, which every dropped copy writes
    with zeros and nothing reads."""
    b, s, k = e_idx.shape
    d = x.shape[-1]
    e_loc = wg.shape[0]
    t = b * s
    xf = x.reshape(t, d)
    ef = e_idx.reshape(t * k)
    gf = gates.reshape(t * k)
    tok = torch.arange(t * k, device=x.device) // k

    pos_in_e = _rank_within(ef, num_experts, sort_dispatch)
    mine = (ef >= 0) & (ef < e_loc) & (pos_in_e < capacity)
    slot = torch.where(mine, ef * capacity + pos_in_e, e_loc * capacity)

    buf = x.new_zeros((e_loc * capacity + 1, d))
    buf = buf.index_put((slot,), xf[tok] * mine[:, None].to(x.dtype))
    x_e = buf[:-1].reshape(e_loc, capacity, d)

    y_e = _expert_mlp(x_e, wg, wu, wd).reshape(e_loc * capacity, d)
    y_e = torch.cat([y_e, y_e.new_zeros((1, d))], dim=0)

    yk = y_e[slot] * (gf * mine.to(gf.dtype))[:, None]  # [T*k, D]
    return yk.reshape(t, k, d).sum(dim=1).reshape(b, s, d)


def _capacity(t_loc: int, cfg: ArchConfig, decode: bool) -> int:
    """Per-expert slot budget. Decode is dropless (tiny buffers anyway);
    train/prefill uses the capacity factor — overflow drops realize the
    paper's load imbalance (DESIGN.md §3)."""
    k, e = cfg.experts_per_token, cfg.num_experts
    if decode:
        return max(1, t_loc * k)  # worst case: every token picks one expert
    return max(1, int(-(-t_loc * k // e) * cfg.moe_capacity_factor))


def _dispatch_a2a(*args, **kwargs):
    """The reference's sequence-sharded ``all_to_all`` expert parallelism
    (``moe_a2a``) needs a device mesh."""
    raise NotImplementedError(f"the all_to_all MoE dispatch: {_MESH_NOT_PORTED}")


def moe_ffn(
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on one device (a :class:`MeshCtx` holds no mesh).
    Returns (out, aux_loss)."""
    gates, e_idx, aux = router_topk(p, x, cfg)
    b, s, _ = x.shape
    cap = _capacity(b * s, cfg, decode=s == 1)
    y = _dispatch_compute_combine(
        x, gates, e_idx, p["w_gate"], p["w_up"], p["w_down"],
        num_experts=cfg.num_experts, capacity=cap, sort_dispatch=cfg.moe_sort_dispatch,
    )
    return y, aux


def moe_ffn_dense(
    p: Params, x: torch.Tensor, cfg: ArchConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: every expert applied to every token, masked by gates."""
    gates, e_idx, aux = router_topk(p, x, cfg)
    dense_gates = torch.zeros(x.shape[:-1] + (cfg.num_experts,), dtype=torch.float32,
                              device=x.device)
    experts = torch.arange(cfg.num_experts, device=x.device)
    for j in range(cfg.experts_per_token):
        dense_gates = dense_gates + (e_idx[..., j, None] == experts).float() * gates[
            ..., j : j + 1].float()
    h = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"])
    y = torch.einsum("bsef,efd->bsed", F.silu(h) * u, p["w_down"])
    out = torch.einsum("bsed,bse->bsd", y, dense_gates.to(y.dtype))
    return out, aux
