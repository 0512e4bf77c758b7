"""Mixture-of-Experts layer and the mesh context threaded through models.

The JAX package's MoE layer. Token→expert assignment is a sparse matrix
(tokens = rows, experts = columns):

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

On a device mesh (a :class:`MeshCtx` over a ``DeviceMesh``) the experts
are sharded over the ``model`` axis and the reference's two
expert-parallel branches run through ``local_map``, the counterpart of
``shard_map``, with its in / out specs:

* **Replicated activations**: each rank takes the tokens of its batch
  shard, gathers those routed to its own ``E / ranks`` experts, and the
  partial outputs are summed over the model axis (a functional
  ``all_reduce``) — the paper's fan-in of partial Y vectors.
* **``moe_a2a``**: tokens sequence-sharded over the model axis travel to
  the rank owning their expert by a static-capacity ``all_to_all`` and
  return the same way (:func:`_dispatch_a2a`).

:func:`moe_ffn_dense` computes the same function with every expert on
every token, as an oracle.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ArchConfig
from repro_torch.models.common import Params, dense_init, project
from repro_torch.models.mesh import MeshCtx, as_dtensor, mesh_scope, sum_over_ranks, wait

__all__ = ["init_moe", "moe_ffn", "moe_ffn_dense", "router_topk", "MeshCtx", "mesh_scope",
           "FLOAT32_PARAMS"]

# Parameters kept in float32 whatever the model's type: the router, so
# that top-k picks experts on float32 probabilities.
FLOAT32_PARAMS = ("router",)


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
    rank: int = 0,
) -> torch.Tensor:
    """Gather each token's k copies into ``[E_loc, C, D]`` expert slots,
    run the experts, gather the outputs back and sum them with the gates.
    The experts are those of model rank ``rank`` (``E_loc`` = ``wg``'s
    first dim, from ``rank * E_loc``); a copy routed elsewhere, or ranked
    at or past ``capacity`` in its expert's queue, is dropped: its slot is
    the buffer's extra last row, which every dropped copy writes with
    zeros and nothing reads. On a mesh the caller sums the ranks' partial
    outputs."""
    b, s, k = e_idx.shape
    d = x.shape[-1]
    e_loc = wg.shape[0]
    t = b * s
    xf = x.reshape(t, d)
    ef = e_idx.reshape(t * k)
    gf = gates.reshape(t * k)
    tok = torch.arange(t * k, device=x.device) // k

    pos_in_e = _rank_within(ef, num_experts, sort_dispatch)
    local_e = ef - rank * e_loc
    mine = (local_e >= 0) & (local_e < e_loc) & (pos_in_e < capacity)
    slot = torch.where(mine, local_e * capacity + pos_in_e, e_loc * capacity)

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


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(t, axis, 0, 0)``: the rows in ``ranks`` equal
    blocks, block j to rank j, the received blocks in rank order.
    Differentiable (its backward is the reverse exchange)."""
    if t.requires_grad:
        return wait(funcol.all_to_all_single_autograd(t, None, None, group))
    return wait(funcol.all_to_all_single(t, None, None, group))


def _dispatch_a2a(
    x: torch.Tensor,  # [B_loc, S_loc, D] — tokens sharded over the model axis
    gates: torch.Tensor,  # [B_loc, S_loc, k]
    e_idx: torch.Tensor,  # [B_loc, S_loc, k]
    wg,  # [E_loc, D, F]
    wu,
    wd,
    *,
    num_experts: int,
    cap_route: int,  # per (src,dst)-rank route capacity
    cap_expert: int,  # per-expert buffer capacity on the owning rank
    group,  # the model axis's process group
    me: int,  # this rank's index on the model axis
    ranks: int,
    sort_dispatch: bool,
) -> torch.Tensor:
    """§Perf `moe_a2a`: DeepSeek-style expert parallelism.

    Tokens are sequence-sharded over the model axis; each token travels
    to the rank owning its expert via a static-capacity ``all_to_all``
    and its output returns the same way. Wire volume per rank is
    O(k · T_loc · D / ranks) instead of the replicated-activation psum's
    O(T_loc · D) — the paper's selective exchange (only send the x
    entries a fragment actually needs) applied to expert fragments.
    Route overflow drops tokens, so NEZGT expert placement (balance)
    directly bounds the drop rate.
    """
    b, s, k = e_idx.shape
    d = x.shape[-1]
    e_loc = wg.shape[0]
    t = b * s
    xf = x.reshape(t, d)
    ef = e_idx.reshape(t * k)
    gf = gates.reshape(t * k)
    tok = torch.arange(t * k, device=x.device) // k

    # --- route to destination ranks -----------------------------------
    dest = torch.div(ef, e_loc, rounding_mode="floor")  # owning rank per (token, slot)
    pos_r = _rank_within(dest, ranks, sort_dispatch)
    keep_r = pos_r < cap_route
    slot_r = torch.where(keep_r, dest * cap_route + pos_r, ranks * cap_route)

    send_x = x.new_zeros((ranks * cap_route + 1, d))
    send_x = send_x.index_put((slot_r,), xf[tok] * keep_r[:, None].to(x.dtype))
    send_e = torch.full((ranks * cap_route + 1,), -1, dtype=ef.dtype, device=x.device)
    send_e = send_e.index_put((slot_r,), torch.where(keep_r, ef, -1))

    recv_x = _all_to_all(send_x[:-1], group)
    recv_e = _all_to_all(send_e[:-1], group)

    # --- local dispatch into my experts --------------------------------
    local_e = recv_e - me * e_loc
    valid = recv_e >= 0
    safe_e = torch.where(valid, torch.clamp(local_e, 0, e_loc - 1), 0)
    pos_e = _rank_within(torch.where(valid, safe_e, e_loc), e_loc + 1, sort_dispatch)
    keep_e = valid & (pos_e < cap_expert)
    slot_e = torch.where(keep_e, safe_e * cap_expert + pos_e, e_loc * cap_expert)

    buf = x.new_zeros((e_loc * cap_expert + 1, d))
    buf = buf.index_put((slot_e,), recv_x * keep_e[:, None].to(x.dtype))
    x_e = buf[:-1].reshape(e_loc, cap_expert, d)
    y_e = _expert_mlp(x_e, wg, wu, wd).reshape(e_loc * cap_expert, d)
    y_e = torch.cat([y_e, y_e.new_zeros((1, d))], dim=0)

    # --- return trip ----------------------------------------------------
    y_back = y_e[slot_e] * keep_e[:, None].to(y_e.dtype)
    ret = _all_to_all(y_back, group)
    ret = torch.cat([ret, ret.new_zeros((1, d))], dim=0)
    yk = ret[slot_r] * (gf * keep_r.to(gf.dtype))[:, None]
    return yk.reshape(t, k, d).sum(dim=1).reshape(b, s, d).to(x.dtype)


def _replicated_branch(x, gates, e_idx, wg, wu, wd, *, group, me, **kw) -> torch.Tensor:
    """Each rank's experts on its batch shard's tokens, summed over the
    model axis."""
    y = _dispatch_compute_combine(x, gates, e_idx, wg, wu, wd, rank=me, **kw)
    return sum_over_ranks(y, group)


def _mesh_moe(p: Params, x, gates, e_idx, cfg: ArchConfig, ctx: MeshCtx, ranks: int):
    """The reference's ``shard_map`` branches as ``local_map`` over the
    mesh, with its in / out specs. The gradient placements say what the
    specs leave implicit: an input replicated over an axis whose ranks
    each use part of it gets a partial gradient there (a token's
    activations over the model axis, the experts' weights over the batch
    axes)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    decode = x.shape[1] == 1
    t_loc = (x.shape[0] // ctx.batch_ranks) * x.shape[1]
    cap = _capacity(t_loc, cfg, decode)
    m = ctx.model_axis
    group = ctx.mesh.get_group(m)
    me = ctx.mesh.get_local_rank(m)
    experts = ctx.placements(**{m: Shard(0)})
    experts_grad = ctx.placements(batch=Partial(), **{m: Shard(0)})
    if cfg.moe_a2a and not decode and x.shape[1] % ranks == 0:
        # Sequence-sharded all_to_all expert parallelism (§Perf moe_a2a).
        t_m = t_loc // ranks  # tokens per model rank
        cap_route = max(1, int(-(-t_m * k // ranks) * cfg.moe_capacity_factor))
        tokens = ctx.placements(batch=Shard(0), **{m: Shard(1)})
        fn = functools.partial(
            _dispatch_a2a, num_experts=e, cap_route=cap_route, cap_expert=cap,
            group=group, me=me, ranks=ranks, sort_dispatch=cfg.moe_sort_dispatch)
        in_grad = (tokens, tokens, tokens, experts_grad, experts_grad, experts_grad)
    else:
        tokens = ctx.placements(batch=Shard(0))
        tokens_grad = ctx.placements(batch=Shard(0), **{m: Partial()})
        fn = functools.partial(
            _replicated_branch, num_experts=e, capacity=cap, group=group, me=me,
            sort_dispatch=cfg.moe_sort_dispatch)
        in_grad = (tokens_grad, tokens_grad, tokens, experts_grad, experts_grad, experts_grad)
    mapped = local_map(fn, out_placements=list(tokens),
                       in_placements=(tokens, tokens, tokens, experts, experts, experts),
                       in_grad_placements=in_grad, device_mesh=ctx.mesh,
                       redistribute_inputs=True)
    args = (x, gates, e_idx, p["w_gate"], p["w_up"], p["w_down"])
    return mapped(*(as_dtensor(a, ctx) for a in args))


def _one_device(x, gates, e_idx, wg, wu, wd, *, cfg: ArchConfig) -> torch.Tensor:
    b, s, _ = x.shape
    cap = _capacity(b * s, cfg, decode=s == 1)
    return _dispatch_compute_combine(
        x, gates, e_idx, wg, wu, wd,
        num_experts=cfg.num_experts, capacity=cap, sort_dispatch=cfg.moe_sort_dispatch,
    )


def moe_ffn(
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    cfg: ArchConfig,
    ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN. Returns (out, aux_loss).

    Without a mesh, or on a mesh whose model axis has one rank, the
    one-device branch, where every token competes for the global
    capacity; on a mesh it runs on the whole batch on every rank
    (``local_map`` over replicated inputs), so the queues are the
    reference's global ones."""
    gates, e_idx, aux = router_topk(p, x, cfg)
    args = (x, gates, e_idx, p["w_gate"], p["w_up"], p["w_down"])
    if ctx is None or ctx.mesh is None:
        return _one_device(*args, cfg=cfg), aux
    ranks = ctx.model_ranks
    if ranks > 1:
        return _mesh_moe(p, x, gates, e_idx, cfg, ctx, ranks), aux
    whole = ctx.placements()
    mapped = local_map(functools.partial(_one_device, cfg=cfg), out_placements=list(whole),
                       in_placements=(whole,) * 6, device_mesh=ctx.mesh,
                       redistribute_inputs=True)
    return mapped(*(as_dtensor(a, ctx) for a in args)), aux


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
