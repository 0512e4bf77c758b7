"""Distributed PMVC executor on one device — the paper's runtime in PyTorch.

The port of the JAX package's ``repro/pmvc/dist.py``. Phases mirror
ch.4's measurement decomposition:

* **Scatter** (fan-out of x): replicated (``échange total``, every unit
  reads the whole x) or the **selective exchange** — the static
  all_to_all schedule of :class:`repro_torch.pmvc.plan_device.SelectivePlan`.
  On one device the schedule's owned → send → receive → workspace chain
  is composed when the step is built into one gather of x a call.
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
``pmvc_simulate_selective`` / ``pmvc_simulate_overlap``. They are the
step below over a :class:`LocalCommunicator` — one rank holding every
unit, its collectives the identity — so one code path serves one device
and many ranks. ``phase_costs`` is the analytic per-phase model, copied
from the JAX package.

**Across ranks** — the counterpart of the JAX package's ``shard_map``
step: :func:`make_unit_mesh` lays the plan's units over the ranks of a
``torch.distributed`` process group (rank r holds units ``[r·U/W,
(r+1)·U/W)``, stacked), and :func:`make_pmvc_step` builds one rank's
step, SPMD: every rank plans the same matrix and calls the step with the
same x. A rank contracts its units in one launch of the kernel per
contraction, sums its units' partials in ascending unit order, and
``all_reduce`` takes the place of ``psum``; the selective exchange is
one ``all_to_all_single``, and overlap:K issues every wave's
``all_to_all_single`` before the local contraction. The step reaches
its collectives and contractions through a :class:`Communicator`; the
schedule audit (:mod:`repro_torch.analysis.schedule_audit`) records a
:class:`LocalCommunicator`'s calls.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device, trace
from repro_torch.kernels.spmv import BellTiles, bell_spmm, bell_tiles, host_tensor
from repro_torch.kernels.spmv.gather import gather_rows
from repro_torch.pmvc.plan_device import (
    DevicePlan,
    ExchangePlan,
    OverlapPlan,
    SelectivePlan,
)

__all__ = [
    "Communicator",
    "Event",
    "LocalCommunicator",
    "UnitMesh",
    "make_pmvc_step",
    "make_unit_mesh",
    "pmvc_simulate",
    "pmvc_simulate_selective",
    "pmvc_simulate_overlap",
    "make_simulate_fn",
    "hoist_tiles",
    "phase_costs",
    "unblock_y",
    "pad_x",
    "scatter_x_owned",
    "unit_sum",
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
        return host_tensor(tiles, device)
    dev = _DEVICE_UFUNC.get(transform)
    if dev is not None:
        return dev(host_tensor(tiles, device))
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


def _index(a: np.ndarray, device) -> torch.Tensor:
    return host_tensor(np.asarray(a), device).long()


# -- across ranks: the shard_map counterpart on torch.distributed ------------


@dataclasses.dataclass(frozen=True)
class Event:
    """One call a step made through its :class:`Communicator`: ``"a2a"``,
    ``"dot"`` (with the dtypes of the tiles and of the x source) or
    ``"psum"``."""

    op: str
    dtypes: Tuple[torch.dtype, ...] = ()


class Communicator:
    """One rank's collectives and contractions: ``torch.distributed`` on
    ``group`` (the default group when ``None``) and the hand-written
    kernel. When ``log`` is a list, every call is appended to it as an
    :class:`Event`, in issue order.

    Raises ``RuntimeError`` when no process group is initialised: the
    units of a plan are never run on one device in its place."""

    def __init__(self, group=None, *, log: Optional[List[Event]] = None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "no torch.distributed process group is initialised: the shard_map "
                "step runs one rank per card (call torch.distributed."
                "init_process_group first); it never runs the units on one device "
                "in its place"
            )
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.log = log

    def _record(self, op: str, *dtypes: torch.dtype) -> None:
        if self.log is not None:
            self.log.append(Event(op, dtypes))

    def all_to_all(self, send: torch.Tensor):
        """Issue ``all_to_all_single`` on ``send`` (dim 0 split evenly
        over the ranks) without waiting; returns ``(recv, work)``, and
        ``recv`` is ready once ``work.wait()`` returns."""
        self._record("a2a")
        send = send.contiguous()
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.group, async_op=True)
        return recv, work

    def dot(self, bt: BellTiles, xsrc: torch.Tensor) -> torch.Tensor:
        """One contraction: the kernel over the rank's stacked units."""
        self._record("dot", bt.tiles.dtype, xsrc.dtype)
        with trace.span("spmv.kernel"):
            return bell_spmm(bt, xsrc)

    def psum(self, y: torch.Tensor) -> torch.Tensor:
        """Sum ``y`` over the ranks, in place."""
        self._record("psum")
        dist.all_reduce(y, group=self.group)
        return y


class _Done:
    """A finished collective's handle."""

    def wait(self) -> None:
        return None


class LocalCommunicator(Communicator):
    """A :class:`Communicator` over one rank and no process group: every
    unit of a plan on one device, which is the ``simulate`` executor.
    ``all_to_all`` hands back what it is given, ``psum`` its input, and
    contractions launch the kernel as on a group; ``log`` as for
    :class:`Communicator`."""

    def __init__(self, *, log: Optional[List[Event]] = None):
        self.group = None
        self.world = 1
        self.rank = 0
        self.log = log

    def all_to_all(self, send: torch.Tensor):
        self._record("a2a")
        return send, _Done()

    def psum(self, y: torch.Tensor) -> torch.Tensor:
        self._record("psum")
        return y


@dataclasses.dataclass(frozen=True)
class UnitMesh:
    """A plan's units over the ranks of a communicator's group: rank r
    holds the ``U / W`` units ``[r·U/W, (r+1)·U/W)``, stacked."""

    num_units: int
    comm: Communicator

    @property
    def units(self) -> range:
        per = self.num_units // self.comm.world
        return range(self.comm.rank * per, (self.comm.rank + 1) * per)


def make_unit_mesh(num_units: int, *, comm: Optional[Communicator] = None) -> UnitMesh:
    """Lay ``num_units`` units over the ranks of ``comm`` (a
    :class:`Communicator` on the default process group when omitted: one
    rank per unit, or per card with units stacked). Raises ``ValueError``
    when the units do not split evenly over the ranks, as the JAX
    package's ``make_unit_mesh`` raises without enough devices."""
    comm = Communicator() if comm is None else comm
    if num_units % comm.world:
        raise ValueError(
            f"{num_units} units do not split evenly over {comm.world} ranks; "
            "the ranks must divide the plan's units"
        )
    return UnitMesh(num_units, comm)


def unit_sum(partials: torch.Tensor) -> torch.Tensor:
    """A rank's partial y from its units' stacked partials ``[Lr, NRB,
    bm(, B)]``, added in ascending unit order by a loop of elementwise
    adds (a reduction's order is not fixed, and PyTorch has no
    deterministic floating-point CUDA ``cumsum``, so none is used). Each
    element's sum is one chain, so column b does not depend on B. A
    float32 sum runs in float64 on the CPU and in float32 on CUDA, as
    PyTorch's ``cumsum`` accumulates there, so the result is bitwise the
    last prefix of ``partials.cumsum(dim=0)``."""
    on_cpu = partials.device.type == "cpu" and partials.dtype == torch.float32
    first, *rest = partials.unbind(0)
    acc = first.to(torch.float64 if on_cpu else partials.dtype, copy=True)
    for p in rest:
        acc.add_(p)
    return acc.to(partials.dtype)


def _send_buffer(x_owned: torch.Tensor, send_idx: torch.Tensor, world: int) -> torch.Tensor:
    """The ``all_to_all_single`` input of a rank: ``send_idx`` ``[Lr, U,
    L]`` names, for each local unit and destination unit, the slots of
    the local x shard ``x_owned`` ``[Lr, per, bn(, B)]`` it sends (−1 =
    unused lane, a zero block). Laid out ``[W, Lr(dst), Lr(src), L,
    bn(, B)]``, so dim 0's W pieces go to the ranks in order."""
    lr, u = send_idx.shape[0], send_idx.shape[1]
    smask = (send_idx >= 0).reshape(send_idx.shape + (1,) * (x_owned.dim() - 2))
    local = torch.arange(lr, device=x_owned.device)[:, None, None]
    send = torch.where(smask, x_owned[local, send_idx.clamp(min=0)], 0.0)
    send = send.reshape(lr, world, u // world, *send.shape[2:])
    return send.permute(1, 2, 0, *range(3, send.dim()))


def _by_source(recv: torch.Tensor) -> torch.Tensor:
    """The received ``[W, Lr(dst), Lr(src), L, bn(, B)]`` as one stack of
    x blocks ``[Lr·W·Lr·L, bn(, B)]``, destination unit first, then the
    source unit numbered across the ranks in order, then the lane."""
    return recv.permute(1, 0, 2, *range(3, recv.dim())).reshape(-1, *recv.shape[4:])


def _workspace(blocks: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Each local unit's compact workspace ``[Lr, W', bn(, B)]``: one
    gather along dim 0 of the stacked x blocks ``blocks`` ``[M, bn(,
    B)]`` by ``index`` ``[Lr, W']``, a zero block where it is −1
    (:func:`repro_torch.kernels.spmv.gather.gather_rows`: one launch on
    the card)."""
    return gather_rows(blocks, index)


def _recv_index(recv_src: np.ndarray, recv_lane: np.ndarray, world: int, lanes: int) -> np.ndarray:
    """``recv_src`` / ``recv_lane`` ``[Lr, W']`` (source unit and lane of
    each slot) as one index into :func:`_by_source`'s stack."""
    lr = recv_src.shape[0]
    dst = np.arange(lr, dtype=np.int64)[:, None] * (world * lr)
    return (dst + recv_src) * lanes + recv_lane


def _composed_index(owned: np.ndarray, send_idx: np.ndarray, recv: np.ndarray, ncb: int):
    """The one-rank exchange composed into one gather: ``[Lr, W']``, the
    x block of each workspace slot, −1 for a zero block. Made by running
    the owned → send → workspace chain once on block ids (1-based, 0 for
    a zero block; float64 holds them exactly), with ``all_to_all`` the
    identity, so it is that chain by construction. ``recv`` is the
    chain's index into :func:`_by_source`."""
    ids = torch.arange(1, ncb + 1, dtype=torch.float64)[:, None]
    x_owned = _owned_blocks(torch.tensor(owned, dtype=torch.long), ids)
    sent = _send_buffer(x_owned, torch.tensor(send_idx, dtype=torch.long), 1)
    ws = _workspace(_by_source(sent), torch.tensor(recv, dtype=torch.long))
    return ws[..., 0].long() - 1


class _Exchange:
    """One exchange of a step (one wave's, under overlap) with its index
    arrays on the device: :meth:`send` issues it from x and the owned
    blocks, :meth:`receive` makes the workspaces ``[Lr, W', bn(, B)]``
    of what arrived.

    Over a :class:`LocalCommunicator` (one rank, no process group,
    ``all_to_all`` the identity) the exchange is composed: :meth:`send`
    gathers x straight into the workspaces, one launch on the card, and
    hands them to ``all_to_all``. Otherwise the owned blocks go out in a
    send buffer and :meth:`receive` gathers the workspaces from the
    received one."""

    def __init__(self, comm: Communicator, owned: np.ndarray, send_idx: np.ndarray,
                 recv_src: np.ndarray, recv_lane: np.ndarray, ncb: int, device):
        self.comm = comm
        self.composed = isinstance(comm, LocalCommunicator)
        lr, lanes = recv_src.shape[0], send_idx.shape[-1]
        if recv_src.size and not (0 <= recv_src.min() and recv_src.max() < comm.world * lr
                                  and 0 <= recv_lane.min() and recv_lane.max() < lanes):
            raise ValueError("recv_src / recv_lane name blocks outside the received buffer")
        recv = _recv_index(recv_src, recv_lane, comm.world, lanes)
        self.slots = recv.size  # x blocks written a call
        if self.composed:
            index = _composed_index(owned, send_idx, recv, ncb)
            rows = ncb  # x's blocks
        else:
            index = torch.as_tensor(recv)
            rows = lr * comm.world * lr * lanes  # _by_source's stack
            self.send_idx = _index(send_idx, device)
            self.slots += send_idx.size
        # gather_rows does not check its index on the card: check it here,
        # once, where it is fixed.
        if index.numel() and not (-1 <= int(index.min()) and int(index.max()) < rows):
            raise ValueError(f"the exchange's index names blocks outside [-1, {rows})")
        self.index = index.to(device=device, dtype=torch.long)

    def send(self, x4: torch.Tensor, x_owned: Optional[torch.Tensor]):
        """Issue the exchange; ``(recv, work)`` of its collective.
        ``x_owned`` may be ``None`` when composed."""
        if self.composed:
            return self.comm.all_to_all(_workspace(x4, self.index))
        return self.comm.all_to_all(_send_buffer(x_owned, self.send_idx, self.comm.world))

    def receive(self, recv: torch.Tensor) -> torch.Tensor:
        return recv if self.composed else _workspace(_by_source(recv), self.index)


def make_pmvc_step(
    plan: DevicePlan,
    mesh: UnitMesh,
    *,
    selective: ExchangePlan = None,
    overlap: Optional[bool] = None,
    device=None,
    transform=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build one rank's distributed PMVC step, ``step(xb) -> y blocks``.

    ``xb`` is the padded global x, ``[NCB, bn]`` or ``[NCB, bn, B]``, the
    same on every rank; the step returns the y blocks ``[NRB, bm(, B)]``,
    replicated on every rank. Each contraction is one launch of the
    kernel over the rank's units (:meth:`Communicator.dot`); the rank
    sums its units' partials in ascending unit order, then one
    ``all_reduce`` sums over the ranks. One collective carries all B
    vectors. By exchange:

    * replicated (``selective=None``): contraction, ``all_reduce``;
    * selective (a :class:`SelectivePlan`): one ``all_to_all_single`` of
      the owned x blocks each unit needs, the contraction from each
      unit's compact workspace, ``all_reduce``;
    * overlap:K (an :class:`OverlapPlan`, or ``overlap=True``): every
      wave's ``all_to_all_single`` issued before the local contraction
      (from the unit's own x shard); wave k's halo is contracted after
      waiting on wave k alone; ``all_reduce``. ``overlap=False`` with an
      :class:`OverlapPlan` runs its selective schedule blocking.

    The rank's plan arrays are hoisted to ``device`` (the card when
    omitted) once, here; ``transform`` is the value-view map of
    :func:`hoist_tiles`. ``step.exchanges`` lists the step's exchanges
    (:class:`_Exchange`: none replicated, one selective, one a wave
    under overlap), each with its gather's ``index`` on the device.
    """
    dev = resolve_device(device)
    comm = mesh.comm
    lo, hi = mesh.units.start, mesh.units.stop
    nrb = plan.num_row_blocks
    if overlap is None:
        overlap = isinstance(selective, OverlapPlan)
    if not overlap and isinstance(selective, OverlapPlan):
        selective = selective.selective

    def finish(partials: torch.Tensor) -> torch.Tensor:
        with trace.span("spmv.unit_sum"):
            return comm.psum(unit_sum(partials))

    def count_exchange(exchanges: List[_Exchange], x4: torch.Tensor) -> None:
        # The bytes the gathers write: x blocks, each [bn, B], of the
        # send buffers and workspaces, or of the composed workspaces.
        slots = sum(ex.slots for ex in exchanges)
        trace.count("spmv.exchange_bytes", slots * x4[0].numel() * x4.element_size())
        if any(ex.composed for ex in exchanges):
            trace.count("spmv.exchange_composed", 1)

    def batched(run, exchanges=()):
        def step(xb: torch.Tensor) -> torch.Tensor:
            y = run(xb if xb.dim() == 3 else xb[..., None])
            return y if xb.dim() == 3 else y[..., 0]

        step.exchanges = list(exchanges)
        return step

    def hoist(tiles: np.ndarray) -> torch.Tensor:
        return hoist_tiles(np.ascontiguousarray(tiles), transform, device=dev)

    if overlap:
        op = selective
        owned = _index(op.selective.owned[lo:hi], dev)  # [Lr, per]
        local = bell_tiles(hoist(op.local_tiles[lo:hi]), op.local_row[lo:hi],
                           op.local_slot[lo:hi], op.local_counts[lo:hi], nrb)
        waves = [
            bell_tiles(hoist(op.halo_tiles[lo:hi, k]), op.halo_row[lo:hi, k],
                       op.halo_slot[lo:hi, k], op.halo_wave_counts[lo:hi, k], nrb)
            for k in range(op.waves)
        ]
        wave_ex = [
            _Exchange(comm, op.selective.owned[lo:hi], op.wave_send_idx[lo:hi, k],
                      op.wave_recv_src[lo:hi, k], op.wave_recv_lane[lo:hi, k],
                      plan.num_col_blocks, dev)
            for k in range(op.waves)
        ]

        def run_overlap(x4: torch.Tensor) -> torch.Tensor:
            if trace.on:
                count_exchange(wave_ex, x4)
            # Every wave's collective issued before any contraction; wave
            # k's halo waits on wave k alone.
            with trace.span("spmv.exchange"):
                x_owned = _owned_blocks(owned, x4)
                sent = [ex.send(x4, x_owned) for ex in wave_ex]
            partials = comm.dot(local, x_owned)
            for (recv, work), ex, bt in zip(sent, wave_ex, waves):
                with trace.span("spmv.exchange"):
                    work.wait()
                    ws = ex.receive(recv)
                partials = partials + comm.dot(bt, ws)
            return finish(partials)

        return batched(run_overlap, wave_ex)

    tiles = hoist(plan.tiles[lo:hi])
    if selective is None:
        bt = bell_tiles(tiles, plan.tile_row[lo:hi], plan.tile_col[lo:hi],
                        plan.real_tiles[lo:hi], nrb)
        return batched(lambda x4: finish(comm.dot(bt, x4[None])))

    sp = selective
    bt = bell_tiles(tiles, plan.tile_row[lo:hi], sp.tile_col_local[lo:hi],
                    plan.real_tiles[lo:hi], nrb)
    ex = _Exchange(comm, sp.owned[lo:hi], sp.send_idx[lo:hi], sp.recv_src[lo:hi],
                   sp.recv_lane[lo:hi], plan.num_col_blocks, dev)
    owned = None if ex.composed else _index(sp.owned[lo:hi], dev)  # [Lr, per]

    def run_selective(x4: torch.Tensor) -> torch.Tensor:
        if trace.on:
            count_exchange([ex], x4)
        with trace.span("spmv.exchange"):
            recv, work = ex.send(x4, None if owned is None else _owned_blocks(owned, x4))
            work.wait()
            ws = ex.receive(recv)
        return finish(comm.dot(bt, ws))

    return batched(run_selective, [ex])


def make_simulate_fn(
    plan: DevicePlan,
    selective: ExchangePlan = None,
    *,
    device,
    transform=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``run(xb) -> y_blocks``, the PMVC over all units on one
    device, on padded x blocks (``[NCB, bn]`` or ``[NCB, bn, B]`` →
    ``[NRB, bm(, B)]``): :func:`make_pmvc_step` over a
    :class:`LocalCommunicator`, so each exchange is the same index
    gathers as across ranks, with the collectives the identity.

    ``selective`` picks the exchange regime: ``None`` (replicated), a
    :class:`SelectivePlan` (blocking selective all_to_all) or an
    :class:`OverlapPlan` (local tiles contract from the owned x shard,
    each halo wave from its delivered workspace). Plan arrays are
    hoisted to ``device`` once, here; ``transform`` is the value-view
    map of :func:`hoist_tiles`.
    """
    mesh = make_unit_mesh(plan.num_units, comm=LocalCommunicator())
    return make_pmvc_step(plan, mesh, selective=selective, device=device, transform=transform)


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
