"""Distributed PMVC executor on one device — the paper's runtime in PyTorch.

The port of the JAX package's ``repro/pmvc/dist.py``. Phases mirror
ch.4's measurement decomposition:

* **Scatter** (fan-out of x): replicated (``échange total``, every unit
  reads the whole x) or the **selective exchange** — the static
  all_to_all schedule of :class:`repro_torch.pmvc.plan_device.SelectivePlan`,
  emulated here by index gathers on one device.
* **Compute**: the per-unit Block-ELL SpMM, all units in one launch of
  the hand-written kernel (:func:`repro_torch.kernels.spmv.bell_spmm`).
* **Gather + construction of Y**: the partial y of every unit summed.

Everything is batch-first: x is one vector ``[N]`` or a stack
``[B, N]``; block-padded x carries the batch as a trailing axis
(``[NCB, bn, B]``), so one exchange and one launch serve all B
right-hand sides.

The **overlap** regime (DESIGN.md §9, §13) splits every unit's tiles at
plan time into a local set (x block owned by the unit) and K halo waves
(x blocks delivered by wave k's exchange): one launch for the local set
from the owned x shard, then one per wave from its workspace.

Entry points: ``make_simulate_fn`` (a reusable closure over hoisted
plan arrays — what the ``simulate`` executor and the device-resident
solver loops build on) and ``pmvc_simulate`` /
``pmvc_simulate_selective`` / ``pmvc_simulate_overlap``. ``phase_costs``
is the analytic per-phase model, copied from the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.spmv import bell_spmm, bell_tiles
from repro_torch.pmvc.plan_device import (
    DevicePlan,
    ExchangePlan,
    OverlapPlan,
    SelectivePlan,
)

__all__ = [
    "pmvc_simulate",
    "pmvc_simulate_selective",
    "pmvc_simulate_overlap",
    "make_simulate_fn",
    "hoist_tiles",
    "phase_costs",
    "unblock_y",
    "pad_x",
    "scatter_x_owned",
    "MESSAGE_OVERHEAD_BYTES",
    "MODEL_LINK_BYTES_PER_S",
    "MODEL_UNIT_FLOPS_PER_S",
]

# α term of the exchange cost model: fixed per-message overhead (header +
# rendezvous), in byte-equivalents at the link's β. Amortized over the
# batch — the reason bytes-per-RHS shrinks as B grows (ch.4's
# startup-vs-payload decomposition).
MESSAGE_OVERHEAD_BYTES = 512

# β and peak terms of the analytic time model (DESIGN.md §9): a 10 GbE
# commodity link (the paper's cluster class) and one unit's sustained
# SpMM rate. Only *ratios* of the derived times are meaningful — the
# constants pin t_* terms so the overlap_efficiency projection and its
# golden tests are deterministic.
MODEL_LINK_BYTES_PER_S = 1.25e9
MODEL_UNIT_FLOPS_PER_S = 5.0e10


# Host ufuncs with a device twin: applying the twin *after* the host→
# device transfer keeps the value-view fast path copy-free on the host.
_DEVICE_UFUNC = {np.absolute: torch.abs, abs: torch.abs, np.sign: torch.sign,
                 np.negative: torch.neg, np.square: torch.square}


def hoist_tiles(tiles: np.ndarray, transform=None, *, device) -> torch.Tensor:
    """Move a tile payload to ``device``, applying an optional elementwise
    value transform (a :meth:`SparseSession.with_value_map` view): known
    ufuncs run on the device after the transfer, anything else is applied
    to the host array on the way in (one transient host copy, never a
    persistent one)."""
    if transform is None:
        return torch.as_tensor(tiles, device=device)
    dev = _DEVICE_UFUNC.get(transform)
    if dev is not None:
        return dev(torch.as_tensor(tiles, device=device))
    return torch.as_tensor(
        np.asarray(transform(np.asarray(tiles)), np.float32), device=device
    )


def pad_x(x: torch.Tensor, ncb: int, bn: int) -> torch.Tensor:
    """Zero-pad x to ``ncb * bn`` on its device and block it: ``[N] ->
    [NCB, bn]``, ``[B, N] -> [NCB, bn, B]`` (trailing batch axis) — the
    tensor twin of :func:`repro_torch.sparse.bell.pad_x_blocks`."""
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be [N] or [B, N], got shape {tuple(x.shape)}")
    x2 = x[None] if x.dim() == 1 else x
    b, n = x2.shape
    xp = torch.zeros((b, ncb * bn), dtype=torch.float32, device=x.device)
    xp[:, :n] = x2
    xb = xp.reshape(b, ncb, bn)
    return xb[0] if x.dim() == 1 else xb.permute(1, 2, 0).contiguous()


def unblock_y(y: torch.Tensor, n: int) -> torch.Tensor:
    """Undo the block layout: ``[NRB, bm] -> [n]`` or ``[NRB, bm, B] ->
    [B, n]`` (row-major batch, matching the ``[B, N]`` input layout)."""
    if y.dim() == 2:
        return y.reshape(-1)[:n]
    return y.reshape(-1, y.shape[-1]).T[:, :n]


def scatter_x_owned(sp: SelectivePlan, xb: torch.Tensor) -> torch.Tensor:
    """Place padded x blocks into the block-col-sharded ``[U, per, bn]``
    (or ``[U, per, bn, B]``) layout the selective executors start from
    (unit u owns ``owned[u]``)."""
    owned = torch.as_tensor(sp.owned, device=xb.device).long()
    return _owned_blocks(owned, xb)


def _owned_blocks(owned: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    omask = (owned >= 0).reshape(owned.shape + (1,) * (xb.dim() - 1))
    return torch.where(omask, xb[owned.clamp(min=0)], 0.0)


def _emulated_exchange(owned, send_idx, xb):
    """Device-side ownership scatter + emulated static all_to_all:
    ``recv[u, v, l] = send[v, u, l]`` — the exact routing of the
    multi-device executors (−1 slots masked to zero blocks). ``owned`` is
    ``[U, per]``, ``send_idx`` ``[U, U, L]``, ``xb`` the padded global x
    ``[NCB, bn(, B)]``. Returns ``(x_owned, recv)``: the block-col-sharded
    x ``[U, per, bn(, B)]`` and the per-unit receive workspace ``[U(dst),
    U(src), L, bn(, B)]`` (a view)."""
    x_owned = _owned_blocks(owned, xb)
    smask = (send_idx >= 0).reshape(send_idx.shape + (1,) * (xb.dim() - 1))
    units = torch.arange(owned.shape[0], device=xb.device)
    send = torch.where(
        smask, x_owned[units[:, None, None], send_idx.clamp(min=0)], 0.0
    )  # [U(src), U(dst), L, bn(, B)]
    return x_owned, send.transpose(0, 1)


def _emulated_wave_exchange(owned, wave_send_idx, xb):
    """Wave variant of :func:`_emulated_exchange`: ``wave_send_idx`` is
    ``[U(src), K, U(dst), L]`` (one all_to_all schedule per halo wave).
    Returns ``(x_owned, recv)`` with ``recv`` ``[U(dst), K, U(src), L,
    bn(, B)]`` — the same swap on the src/dst axes, wave axis carried
    through."""
    x_owned = _owned_blocks(owned, xb)
    smask = (wave_send_idx >= 0).reshape(wave_send_idx.shape + (1,) * (xb.dim() - 1))
    units = torch.arange(owned.shape[0], device=xb.device)
    send = torch.where(
        smask, x_owned[units[:, None, None, None], wave_send_idx.clamp(min=0)], 0.0
    )  # [U(src), K, U(dst), L, bn(, B)]
    return x_owned, send.transpose(0, 2)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device).long()


def make_simulate_fn(
    plan: DevicePlan,
    selective: ExchangePlan = None,
    *,
    device,
    transform=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``run(xb) -> y_blocks``, the PMVC over all units on one
    device, on padded x blocks (``[NCB, bn]`` or ``[NCB, bn, B]`` →
    ``[NRB, bm(, B)]``).

    ``selective`` picks the exchange regime: ``None`` (replicated), a
    :class:`SelectivePlan` (blocking selective all_to_all) or an
    :class:`OverlapPlan` (local tiles contract from the owned x shard,
    each halo wave from its delivered workspace).

    Plan arrays are hoisted to ``device`` once, here, so callers that
    keep the closure never re-pay the host→device copy. ``transform`` is
    the optional value-view map applied to tile payloads at hoist time
    (see :func:`hoist_tiles`). Every contraction is one launch of
    :func:`repro_torch.kernels.spmv.bell_spmm` over all units.
    """
    nrb = plan.num_row_blocks
    if isinstance(selective, OverlapPlan):
        return _make_simulate_overlap_fn(plan, selective, device=device, transform=transform)
    tiles = hoist_tiles(plan.tiles, transform, device=device)

    if selective is None:
        bt = bell_tiles(tiles, plan.tile_row, plan.tile_col, plan.real_tiles, nrb)

        def run(xb: torch.Tensor) -> torch.Tensor:
            x4 = xb if xb.dim() == 3 else xb[..., None]
            y = bell_spmm(bt, x4[None]).sum(dim=0)
            return y if xb.dim() == 3 else y[..., 0]

        return run

    sp = selective
    bt = bell_tiles(tiles, plan.tile_row, sp.tile_col_local, plan.real_tiles, nrb)
    owned = _index(sp.owned, device)  # [U, per]
    send_idx = _index(sp.send_idx, device)  # [U, U, L]
    recv_src = _index(sp.recv_src, device)  # [U, W]
    recv_lane = _index(sp.recv_lane, device)
    units = torch.arange(sp.num_units, device=device)[:, None]

    def run_selective(xb: torch.Tensor) -> torch.Tensor:
        x4 = xb if xb.dim() == 3 else xb[..., None]
        _, recv = _emulated_exchange(owned, send_idx, x4)
        ws = recv[units, recv_src, recv_lane]  # [U, W, bn, B] compact workspaces
        y = bell_spmm(bt, ws).sum(dim=0)
        return y if xb.dim() == 3 else y[..., 0]

    return run_selective


def _make_simulate_overlap_fn(
    plan: DevicePlan, op: OverlapPlan, *, device, transform=None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Overlapped path: the local tiles contract straight from the owned
    x shard (no dependency on the emulated all_to_all), the halo tiles —
    one wave at a time, one launch each — from the delivered per-wave
    workspaces. Every unit's partial is local + wave 0 + … + wave K−1, in
    that order, as in the JAX package."""
    nrb = plan.num_row_blocks
    sp = op.selective
    local = bell_tiles(
        hoist_tiles(op.local_tiles, transform, device=device),
        op.local_row, op.local_slot, op.local_counts, nrb,
    )
    waves = [
        bell_tiles(
            hoist_tiles(np.ascontiguousarray(op.halo_tiles[:, k]), transform, device=device),
            op.halo_row[:, k], op.halo_slot[:, k], op.halo_wave_counts[:, k], nrb,
        )
        for k in range(op.waves)
    ]
    owned = _index(sp.owned, device)  # [U, per]
    wave_send_idx = _index(op.wave_send_idx, device)  # [U, K, U, L]
    wave_recv_src = _index(op.wave_recv_src, device)  # [U, K, W]
    wave_recv_lane = _index(op.wave_recv_lane, device)
    units = torch.arange(sp.num_units, device=device)[:, None]

    def run_overlap(xb: torch.Tensor) -> torch.Tensor:
        x4 = xb if xb.dim() == 3 else xb[..., None]
        x_owned, recv = _emulated_wave_exchange(owned, wave_send_idx, x4)
        partials = bell_spmm(local, x_owned)
        for k, bt in enumerate(waves):
            ws = recv[units, k, wave_recv_src[:, k], wave_recv_lane[:, k]]
            partials = partials + bell_spmm(bt, ws)
        y = partials.sum(dim=0)
        return y if xb.dim() == 3 else y[..., 0]

    return run_overlap


def _run_on_host(plan: DevicePlan, selective: ExchangePlan, x: np.ndarray, device) -> np.ndarray:
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    run = make_simulate_fn(plan, selective, device=device)
    y = run(pad_x(xt, plan.num_col_blocks, plan.bn))
    return unblock_y(y, plan.shape[0]).cpu().numpy()


def pmvc_simulate(plan: DevicePlan, x: np.ndarray, *, device) -> np.ndarray:
    """All units on one device; ``x`` is ``[N]`` or a batch ``[B, N]``;
    returns y with the same leading shape."""
    return _run_on_host(plan, None, x, device)


def pmvc_simulate_selective(
    plan: DevicePlan, sp: SelectivePlan, x: np.ndarray, *, device
) -> np.ndarray:
    """The *selective* exchange on one device; one emulated all_to_all
    carries all B right-hand sides."""
    return _run_on_host(plan, sp, x, device)


def pmvc_simulate_overlap(
    plan: DevicePlan, op: OverlapPlan, x: np.ndarray, *, device
) -> np.ndarray:
    """The *overlapped* local/halo exchange on one device."""
    return _run_on_host(plan, op, x, device)


def _message_counts(plan: DevicePlan, selective: Optional[SelectivePlan]) -> int:
    """Point-to-point messages per exchange (the α-cost multiplier)."""
    u = plan.num_units
    if selective is None:
        return u * (u - 1)  # all-gather: every unit hears every other
    off_diag = (selective.send_idx >= 0).any(axis=-1)
    np.fill_diagonal(off_diag, False)
    return int(off_diag.sum())


def phase_costs(
    plan: DevicePlan,
    selective: ExchangePlan = None,
    bytes_per: int = 4,
    batch: int = 1,
    *,
    link_bytes_per_s: Optional[float] = None,
    unit_flops_per_s: Optional[float] = None,
) -> Dict[str, float]:
    """Analytic per-phase volumes and model times for the benchmark
    tables (paper ch.4; overlap model DESIGN.md §9/§13). Copied from the
    JAX package: pure numpy over the plan arrays.

    ``batch`` is the SpMM width B: payload volumes scale with B while
    the per-message overhead (``MESSAGE_OVERHEAD_BYTES`` × messages) is
    paid once per exchange — so the ``*_per_rhs`` keys shrink as B
    grows.

    Time terms (seconds under the α-β-peak constants; only ratios are
    meaningful): ``t_scatter`` / ``t_gather`` are the wire times,
    ``t_compute`` the padded per-unit contraction.
    ``link_bytes_per_s`` / ``unit_flops_per_s`` override the model's β
    and peak terms; ``None`` keeps the pinned ``MODEL_*`` defaults.

    When ``selective`` is an :class:`OverlapPlan` the dict additionally
    carries the pipelined model — ``t_local`` / ``t_halo`` (the two
    contraction phases) and ``t_iter_overlap`` vs ``t_iter_blocking =
    t_scatter + t_compute + t_gather``. For a single halo wave
    ``t_iter_overlap = max(t_scatter, t_local) + t_halo + t_gather``;
    for K waves the K-stage pipeline recursion applies:

    .. code-block:: text

        comm_end[k] = comm_end[k-1] + t_wave_scatter[k]
        comp_end[k] = max(comp_end[k-1], comm_end[k]) + t_wave_halo
        t_iter_overlap = comp_end[K-1] + t_gather

    ``overlap_efficiency`` is the fraction of the total exchange time
    hidden behind contractions and ``overlap_speedup`` the projected
    blocking/overlap ratio.
    """
    link = float(link_bytes_per_s) if link_bytes_per_s else MODEL_LINK_BYTES_PER_S
    peak = float(unit_flops_per_s) if unit_flops_per_s else MODEL_UNIT_FLOPS_PER_S
    op = selective if isinstance(selective, OverlapPlan) else None
    sp = op.selective if op is not None else selective
    u = plan.num_units
    b = max(int(batch), 1)
    blk = plan.bm * plan.bn * bytes_per
    scatter_naive = (u - 1) * plan.num_col_blocks * plan.bn * bytes_per * b
    scatter = (
        sp.wire_blocks * plan.bn * bytes_per * b if sp is not None else scatter_naive
    )
    msgs = _message_counts(plan, sp)
    overhead = msgs * MESSAGE_OVERHEAD_BYTES
    flops = 2.0 * u * plan.t * plan.bm * plan.bn * b  # padded (realized) FLOPs
    useful = 2.0 * float(plan.real_tiles.sum()) * plan.bm * plan.bn * b
    gather = u * plan.num_row_blocks * plan.bm * bytes_per * b  # psum volume
    gather_overhead = u * MESSAGE_OVERHEAD_BYTES
    t_scatter = float(scatter + overhead) / link
    t_gather = float(gather + gather_overhead) / link
    # Units run the padded tile count in lockstep → per-unit time.
    t_compute = 2.0 * plan.t * plan.bm * plan.bn * b / peak
    out = {
        "batch": float(b),
        "scatter_bytes": float(scatter),
        "scatter_bytes_naive": float(scatter_naive),
        "scatter_messages": float(msgs),
        "scatter_overhead_bytes": float(overhead),
        "scatter_bytes_per_rhs": float(scatter + overhead) / b,
        "compute_flops": flops,
        "useful_flops": useful,
        "flop_efficiency": useful / flops if flops else 1.0,
        "gather_bytes": float(gather),
        "gather_bytes_per_rhs": float(gather + gather_overhead) / b,
        "tile_bytes_resident": float(u * plan.t * blk),
        "t_scatter": t_scatter,
        "t_gather": t_gather,
        "t_compute": t_compute,
        "t_iter_blocking": t_scatter + t_compute + t_gather,
    }
    if op is None:
        return out
    # Pipelined model: the halo payload is exactly the wire volume (the
    # self-routed owned blocks never leave the unit); local x bytes are
    # the owned-and-referenced blocks read straight from the shard.
    diag = np.arange(op.num_units)
    local_blocks = int((op.selective.send_idx[diag, diag] >= 0).sum())
    nw = op.waves
    t_local = 2.0 * op.t_local * plan.bm * plan.bn * b / peak
    t_halo = 2.0 * op.t_halo * plan.bm * plan.bn * b / peak
    if nw == 1:
        t_iter_overlap = max(t_scatter, t_local) + t_halo + t_gather
        hidden = min(t_scatter, t_local)
        efficiency = hidden / t_scatter if t_scatter > 0 else 1.0
    else:
        # K-stage pipeline: wave k's α-β transfer queues behind wave
        # k-1's on the link; its contraction starts once both the wave
        # landed and the previous contraction finished. Each wave pads
        # to the common t_halo tile count (lockstep units).
        wave_bytes = op.wave_wire_blocks * plan.bn * bytes_per * b
        wave_overhead = op.wave_messages * MESSAGE_OVERHEAD_BYTES
        t_wave_scatter = (wave_bytes + wave_overhead).astype(np.float64) / link
        comm_end = np.cumsum(t_wave_scatter)
        comp_end = t_local
        for k in range(nw):
            comp_end = max(comp_end, float(comm_end[k])) + t_halo
        t_iter_overlap = comp_end + t_gather
        total_comm = float(t_wave_scatter.sum())
        exposed = comp_end - (t_local + nw * t_halo)
        efficiency = (
            (total_comm - exposed) / total_comm if total_comm > 0 else 1.0
        )
    out.update(
        {
            "halo_bytes": float(scatter),
            "local_x_bytes": float(local_blocks * plan.bn * bytes_per * b),
            "local_tile_fraction": op.local_fraction,
            "waves": float(nw),
            "t_local": t_local,
            "t_halo": t_halo,
            "t_iter_overlap": t_iter_overlap,
            "overlap_efficiency": efficiency,
        }
    )
    out["overlap_speedup"] = out["t_iter_blocking"] / out["t_iter_overlap"]
    return out
