"""Device-side packing of a two-level plan (host → stacked unit arrays).

Takes the element-level (node, core) assignment from
:class:`repro_torch.core.combined.TwoLevelPlan` and emits equal-shaped stacked
BELL arrays, one leading ``unit`` axis entry per compute unit — the form
both the vmap simulator and the shard_map executor consume. Padding to
the global max tile count per unit realizes the paper's load imbalance
as wasted FLOPs (DESIGN.md §5.3).

Also builds the **selective-exchange plan** (DESIGN.md §2.2): with x
sharded by block-column over units, a static all_to_all send/receive
schedule moves only the x blocks each unit actually needs — the paper's
``C_Xk`` fan-out volume realized on a TPU mesh.

The **overlap plan** (DESIGN.md §9, §13) refines the selective plan with
a plan-time split of every unit's tiles into a *local* set (x block owned
by the unit — contractable while the all_to_all is in flight) and K
prioritized **halo waves** (x blocks delivered by per-wave exchanges,
nearest ring neighbours first), so the runtime can pipeline each wave's
transfer behind the previous wave's contraction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.sparse.bell import (
    split_tiles_local_halo,
    stack_ragged,
    x_block_owner,
)
from repro_torch.sparse.formats import COO

__all__ = [
    "DevicePlan",
    "SelectivePlan",
    "OverlapPlan",
    "ExchangePlan",
    "pack_units",
    "build_selective_plan",
    "build_overlap_plan",
    "tile_col_local_from",
]


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Stacked per-unit BELL arrays (leading axis = unit)."""

    shape: Tuple[int, int]
    bm: int
    bn: int
    num_units: int
    tiles: np.ndarray  # [U, T, bm, bn] f32
    tile_row: np.ndarray  # [U, T] int32 — GLOBAL block-row
    tile_col: np.ndarray  # [U, T] int32 — global block-col
    real_tiles: np.ndarray  # [U] tiles before padding

    @property
    def t(self) -> int:
        return int(self.tiles.shape[1])

    @property
    def num_row_blocks(self) -> int:
        return -(-self.shape[0] // self.bm)

    @property
    def num_col_blocks(self) -> int:
        return -(-self.shape[1] // self.bn)

    @property
    def lb_tiles(self) -> float:
        avg = self.real_tiles.mean()
        return float(self.real_tiles.max() / avg) if avg > 0 else 1.0

    @property
    def padding_flop_waste(self) -> float:
        tot = self.num_units * self.t
        real = int(self.real_tiles.sum())
        return 1.0 - real / tot if tot else 0.0


@dataclasses.dataclass(frozen=True)
class SelectivePlan:
    """Static all_to_all schedule for the selective x fan-out.

    ``x`` lives block-column-sharded: unit ``u`` owns global block-cols
    ``owned[u]`` (padded with -1). ``send_idx[u, v, l]`` is the l-th
    *local* block index that u sends to v (-1 = padding). After the
    all_to_all, unit u holds, for each source v, the blocks it asked for;
    ``recv_slot[u]`` maps each of u's needed global block-cols to its
    (source, lane) position; the executor scatters them into a compact
    local x workspace indexed by ``tile_col_local``.
    """

    num_units: int
    blocks_per_unit: int  # owned block-cols per unit (padded)
    lanes: int  # L = max blocks on any (src,dst) route
    owned: np.ndarray  # [U, blocks_per_unit] global block-col or -1
    send_idx: np.ndarray  # [U, U, L] local idx into owned, or -1
    recv_src: np.ndarray  # [U, W] source unit per needed block
    recv_lane: np.ndarray  # [U, W] lane per needed block
    needed: np.ndarray  # [U, W] global block-col ids (-1 pad)
    tile_col_local: np.ndarray  # [U, T] per-tile index into the workspace
    wire_blocks: int  # realized blocks on the wire (sum over routes)
    naive_blocks: int  # all-gather equivalent volume

    @property
    def workspace(self) -> int:
        return int(self.needed.shape[1])

    @property
    def volume_ratio(self) -> float:
        """Realized / all-gather fan-out volume (<1 == paper's FR_X win)."""
        return self.wire_blocks / max(self.naive_blocks, 1)


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Selective plan + the plan-time local/halo-wave tile split
    (DESIGN.md §9, §13).

    Every real tile of the :class:`DevicePlan` lands in exactly one of
    the padded stacked sets:

    * **local** — ``tile_col`` is owned by the tile's unit; the
      contraction reads ``x_owned[u][local_slot]`` and needs no
      communication, so the runtime schedules it *while the first wave's
      all_to_all is in flight*.
    * **halo wave k ∈ [0, K)** — ``tile_col`` arrives with wave k's own
      all_to_all (``wave_send_idx[:, k]``). Each unit's remote blocks
      are ranked by ring distance to their owner and split into K
      near-first groups, so early waves land while later transfers are
      still in flight. ``halo_slot[u, k]`` indexes wave k's compact
      per-wave workspace (gathered via ``wave_recv_src/lane[u, k]``).

    ``waves == 1`` reproduces the original two-phase local→halo split
    (one wave carrying the whole halo). Padding entries are all-zero
    tiles (slot/row 0), contributing nothing — the same trick the
    blocking path uses, so the split costs only the extra padding to the
    per-set maxima.
    """

    selective: SelectivePlan
    local_tiles: np.ndarray  # [U, TL, bm, bn] f32
    local_row: np.ndarray  # [U, TL] int32 — global block-row
    local_slot: np.ndarray  # [U, TL] int32 — slot into owned[u]
    halo_tiles: np.ndarray  # [U, K, TH, bm, bn] f32
    halo_row: np.ndarray  # [U, K, TH] int32 — global block-row
    halo_slot: np.ndarray  # [U, K, TH] int32 — slot into wave k's workspace
    local_counts: np.ndarray  # [U] real local tiles per unit
    halo_wave_counts: np.ndarray  # [U, K] real halo tiles per (unit, wave)
    wave_send_idx: np.ndarray  # [U, K, U, L] src-major: what u sends to v in wave k
    wave_recv_src: np.ndarray  # [U, K, W] source unit per wave-workspace slot
    wave_recv_lane: np.ndarray  # [U, K, W] lane per wave-workspace slot

    @property
    def num_units(self) -> int:
        return self.selective.num_units

    @property
    def waves(self) -> int:
        """K — number of prioritized halo waves."""
        return int(self.halo_tiles.shape[1])

    @property
    def halo_counts(self) -> np.ndarray:
        """[U] real halo tiles per unit (summed over waves)."""
        return self.halo_wave_counts.sum(axis=1)

    @property
    def t_local(self) -> int:
        """Padded local tiles per unit (the synchronized local phase)."""
        return int(self.local_tiles.shape[1])

    @property
    def t_halo(self) -> int:
        """Padded halo tiles per unit *per wave*."""
        return int(self.halo_tiles.shape[2])

    @property
    def wave_wire_blocks(self) -> np.ndarray:
        """[K] x blocks on the wire per wave (all wave routes are
        remote; self-needed owned blocks are read in place, never sent)."""
        return (self.wave_send_idx >= 0).sum(axis=(0, 2, 3))

    @property
    def wave_messages(self) -> np.ndarray:
        """[K] (src, dst) point-to-point messages per wave."""
        return (self.wave_send_idx >= 0).any(axis=3).sum(axis=(0, 2))

    @property
    def local_fraction(self) -> float:
        """Real local tiles / real tiles — how much work the exchange
        can hide behind (1.0 == fully local, nothing to overlap)."""
        tot = int(self.local_counts.sum() + self.halo_wave_counts.sum())
        return float(self.local_counts.sum() / tot) if tot else 1.0


# An exchange plan argument, as every executor understands it: None ==
# replicated, SelectivePlan == the blocking selective all_to_all,
# OverlapPlan == pipelined local/halo (defined once, next to the plan
# classes; repro_torch.pmvc.dist and repro_torch.api re-export it).
ExchangePlan = Optional[Union[SelectivePlan, OverlapPlan]]


def build_overlap_plan(
    plan: DevicePlan,
    selective: Optional[SelectivePlan] = None,
    *,
    waves: int = 1,
) -> OverlapPlan:
    """Split every unit's tiles into local + K halo-wave sets over
    ``selective``'s x ownership (derived from ``plan`` when not
    supplied).

    Wave assignment: per destination unit, the needed *remote* blocks
    are ranked ascending by ``(ring distance to owner, block id)`` and
    cut into ``waves`` equal near-first groups — nearest-neighbour
    transfers land in wave 0 while far-owner transfers ride later waves
    the runtime hides behind earlier contractions. Each wave gets its
    own all_to_all schedule and compact workspace; the union of the
    waves is exactly the halo set, and self-needed owned blocks are read
    in place (never shipped, unlike the blocking selective schedule
    which routes them through the collective).
    """
    if waves < 1:
        raise ValueError(f"need waves >= 1, got {waves}")
    sp = selective if selective is not None else build_selective_plan(plan)
    u_n = plan.num_units
    ncb = plan.num_col_blocks
    nw = int(waves)
    owner_of_block = x_block_owner(ncb, u_n)
    local_of_block = (np.arange(ncb, dtype=np.int64) % sp.blocks_per_unit).astype(
        np.int32
    )

    splits = [
        split_tiles_local_halo(plan.tile_col[u], int(plan.real_tiles[u]), sp.owned[u])
        for u in range(u_n)
    ]
    local_counts = np.array([s[0].shape[0] for s in splits], dtype=np.int64)

    # ---- Wave assignment over the needed remote (unit, block) pairs ----
    uu, ii = np.nonzero(sp.needed >= 0)
    gg = sp.needed[uu, ii].astype(np.int64)
    own = owner_of_block[gg]
    remote = own != uu
    ru, rg, ro = uu[remote].astype(np.int64), gg[remote], own[remote]
    dist = np.minimum((ro - ru) % u_n, (ru - ro) % u_n)
    order = np.lexsort((rg, dist, ru))  # (unit, distance, block) ascending
    ru, rg = ru[order], rg[order]
    cnt = np.bincount(ru, minlength=u_n)
    off = np.zeros(u_n + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    rank = np.arange(ru.shape[0], dtype=np.int64) - off[ru]
    wave = rank * nw // np.maximum(cnt[ru], 1)
    # Workspace slot within (unit, wave): pairs are (unit, wave)-run
    # contiguous (wave is monotone in rank), so a run-boundary scan gives
    # each pair's position inside its wave — ascending (distance, block).
    wkey = ru * nw + wave
    new_run = np.ones(wkey.shape[0], dtype=bool)
    new_run[1:] = wkey[1:] != wkey[:-1]
    run_start = np.nonzero(new_run)[0]
    run_id = np.cumsum(new_run) - 1
    slot = np.arange(wkey.shape[0], dtype=np.int64) - run_start[run_id]
    wave_block_counts = (
        np.bincount(wkey, minlength=u_n * nw).reshape(u_n, nw).astype(np.int64)
    )
    w_wave = max(int(wave_block_counts.max(initial=0)), 1)

    # (unit, block) → (wave, slot) lookup for the halo tile scatter.
    lut_wave = np.zeros((u_n, ncb), dtype=np.int32)
    lut_slot = np.zeros((u_n, ncb), dtype=np.int32)
    lut_wave[ru, rg] = wave.astype(np.int32)
    lut_slot[ru, rg] = slot.astype(np.int32)

    # ---- Per-wave all_to_all schedules (shared routing helper) ----
    per_wave = []
    lanes_w = 1
    for k in range(nw):
        m = wave == k
        send_k, rs_k, rl_k, lk = _route_pairs(
            ru[m], rg[m].astype(np.int32), slot[m],
            owner_of_block, local_of_block, u_n, w_wave,
        )
        per_wave.append((send_k, rs_k, rl_k, lk))
        lanes_w = max(lanes_w, lk)
    wave_send_idx = np.full((u_n, nw, u_n, lanes_w), -1, dtype=np.int32)
    wave_recv_src = np.zeros((u_n, nw, w_wave), dtype=np.int32)
    wave_recv_lane = np.zeros((u_n, nw, w_wave), dtype=np.int32)
    for k, (send_k, rs_k, rl_k, lk) in enumerate(per_wave):
        wave_send_idx[:, k, :, :lk] = send_k
        wave_recv_src[:, k] = rs_k
        wave_recv_lane[:, k] = rl_k

    # ---- Stacked tile sets ----
    # Per-(unit, wave) halo *tile* indices first (several tiles can
    # reference the same needed block, so the tile padding TH is the max
    # over these, not over the block-pair counts).
    halo_by_wave = []
    halo_fill = np.zeros((u_n, nw), dtype=np.int64)
    for u, (_, halo) in enumerate(splits):
        hcols = plan.tile_col[u, halo].astype(np.int64)
        hw = lut_wave[u, hcols]
        sets = [halo[hw == k] for k in range(nw)]
        halo_by_wave.append(sets)
        halo_fill[u] = [s.shape[0] for s in sets]
    tl = max(int(local_counts.max(initial=0)), 1)
    th = max(int(halo_fill.max(initial=0)), 1)
    bm, bn = plan.bm, plan.bn
    local_tiles = np.zeros((u_n, tl, bm, bn), dtype=np.float32)
    local_row = np.zeros((u_n, tl), dtype=np.int32)
    local_slot = np.zeros((u_n, tl), dtype=np.int32)
    halo_tiles = np.zeros((u_n, nw, th, bm, bn), dtype=np.float32)
    halo_row = np.zeros((u_n, nw, th), dtype=np.int32)
    halo_slot = np.zeros((u_n, nw, th), dtype=np.int32)
    for u, (loc, _) in enumerate(splits):
        k = loc.shape[0]
        local_tiles[u, :k] = plan.tiles[u, loc]
        local_row[u, :k] = plan.tile_row[u, loc]
        local_slot[u, :k] = local_of_block[plan.tile_col[u, loc]]
        for k, sel in enumerate(halo_by_wave[u]):
            n_k = sel.shape[0]
            halo_tiles[u, k, :n_k] = plan.tiles[u, sel]
            halo_row[u, k, :n_k] = plan.tile_row[u, sel]
            halo_slot[u, k, :n_k] = lut_slot[u, plan.tile_col[u, sel].astype(np.int64)]
    # The waves exactly partition the halo set: every halo tile's block
    # is a remote needed pair and lands in exactly one wave.
    assert int(halo_fill.sum()) == sum(int(s[1].shape[0]) for s in splits)
    return OverlapPlan(
        selective=sp,
        local_tiles=local_tiles,
        local_row=local_row,
        local_slot=local_slot,
        halo_tiles=halo_tiles,
        halo_row=halo_row,
        halo_slot=halo_slot,
        local_counts=local_counts,
        halo_wave_counts=halo_fill,
        wave_send_idx=wave_send_idx,
        wave_recv_src=wave_recv_src,
        wave_recv_lane=wave_recv_lane,
    )


def _tile_index(
    elem_unit: np.ndarray,
    rb: np.ndarray,
    cb: np.ndarray,
    num_units: int,
    nrb: int,
    ncb: int,
):
    """Unique ``(unit, block-row, block-col)`` tile triples in ascending
    composite-key order plus each element's tile rank — exactly
    ``np.unique(key, return_inverse=True)`` on the flattened int64 key,
    without paying its cost. Every realistic plan's key space
    (``units × row-blocks × col-blocks``) fits 32 bits, so the bucket id
    is composed narrow, sorted with one 32-bit argsort (numpy's
    vectorized introsort — roughly half the int64 sort), and the
    ascending unique set plus the inverse fall out of a run-boundary
    scan with a 32-bit rank scatter (``np.unique`` builds both at 64
    bits). Oversized key spaces fall back to ``np.unique`` unchanged.
    Returns ``(t_unit, t_rb, t_cb, tile_of_elem)``.
    """
    n = rb.shape[0]
    if n and num_units * nrb * ncb <= 2**31:
        key = (
            elem_unit.astype(np.int32) * np.int32(nrb) + rb.astype(np.int32)
        ) * np.int32(ncb) + cb.astype(np.int32)
        order = np.argsort(key)
        skey = key[order]
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        np.not_equal(skey[1:], skey[:-1], out=boundary[1:])
        ranks = np.cumsum(boundary, dtype=np.int32)
        ranks -= 1
        tile_of_elem = np.empty(n, dtype=np.int32)
        tile_of_elem[order] = ranks
        uniq = skey[boundary].astype(np.int64)
        t_unit = uniq // (nrb * ncb)
        t_rb = ((uniq // ncb) % nrb).astype(np.int32)
        t_cb = (uniq % ncb).astype(np.int32)
        return t_unit, t_rb, t_cb, tile_of_elem
    key = (
        elem_unit.astype(np.int64) * nrb + rb.astype(np.int64)
    ) * ncb + cb.astype(np.int64)
    uniq, tile_of_elem = np.unique(key, return_inverse=True)
    t_unit = (uniq // (nrb * ncb)).astype(np.int64)
    t_rb = ((uniq // ncb) % nrb).astype(np.int32)
    t_cb = (uniq % ncb).astype(np.int32)
    return t_unit, t_rb, t_cb, tile_of_elem


def pack_units(
    a: COO,
    elem_unit: np.ndarray,
    num_units: int,
    bm: int,
    bn: int,
) -> DevicePlan:
    """Stack every unit's non-empty tiles, padded to the global max."""
    nrb = -(-a.shape[0] // bm)
    ncb = -(-a.shape[1] // bn)
    # The tile identity includes the owning unit: the same (rb,cb) tile
    # may exist on two units when the element partition splits a tile
    # (cost recorded by the benchmark as tile duplication).
    t_unit, t_rb, t_cb, tile_of_elem = _tile_index(
        elem_unit, a.row // bm, a.col // bn, num_units, nrb, ncb
    )
    num_tiles = t_unit.shape[0]
    all_tiles = np.zeros((num_tiles, bm, bn), dtype=np.float32)
    all_tiles[tile_of_elem, a.row % bm, a.col % bn] = a.val.astype(np.float32)

    counts = np.bincount(t_unit, minlength=num_units)
    t_max = max(int(counts.max(initial=0)), 1)
    # `uniq` is ascending, i.e. (unit, block-row, block-col)-ordered: each
    # unit's tiles already sit consecutively in the stable by-row order
    # the old per-unit argsort produced, so one ragged scatter replaces
    # the Python loop over units (bit-identical output).
    tiles = stack_ragged(all_tiles, counts, t_max)
    tile_row = stack_ragged(t_rb, counts, t_max)
    tile_col = stack_ragged(t_cb, counts, t_max)
    return DevicePlan(
        shape=a.shape,
        bm=bm,
        bn=bn,
        num_units=num_units,
        tiles=tiles,
        tile_row=tile_row,
        tile_col=tile_col,
        real_tiles=counts.astype(np.int64),
    )


def tile_col_local_from(
    needed: np.ndarray, tile_col: np.ndarray, num_col_blocks: int
) -> np.ndarray:
    """Per-tile index into the compact W workspace, rebuilt from the
    ``needed`` rows (each unit's sorted unique block-cols, −1 padded) and
    the padded ``[U, T]`` ``tile_col`` — the derivation
    :func:`build_selective_plan` uses, exposed so the sparse plan-store
    format can drop ``tile_col_local`` from the archive and reconstruct
    it bitwise on load."""
    u_n = needed.shape[0]
    lut = np.zeros((u_n, num_col_blocks), dtype=np.int32)
    uu, ii = np.nonzero(needed >= 0)
    lut[uu, needed[uu, ii]] = ii.astype(np.int32)
    return np.take_along_axis(lut, tile_col.astype(np.int64), axis=1)


def _route_pairs(
    pu: np.ndarray,
    pg: np.ndarray,
    slot: np.ndarray,
    owner_of_block: np.ndarray,
    local_of_block: np.ndarray,
    u_n: int,
    w_max: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """All_to_all schedule for a set of needed ``(dst unit, block)``
    pairs with precomputed workspace slots.

    The lane of a block is its rank inside its (src, dst) route —
    sorting the pairs by (dst, src, block) makes each route a contiguous
    run. Returns ``(send_idx [U, U, L], recv_src [U, w_max],
    recv_lane [U, w_max], lanes)``. Shared by the full selective
    schedule and each overlap wave's schedule.
    """
    src = owner_of_block[pg].astype(np.int64)
    order = np.lexsort((pg, src, pu))
    run_key = pu[order] * u_n + src[order]
    new_run = np.ones(run_key.shape[0], dtype=bool)
    new_run[1:] = run_key[1:] != run_key[:-1]
    run_start = np.nonzero(new_run)[0]
    run_id = np.cumsum(new_run) - 1
    lane_sorted = np.arange(run_key.shape[0], dtype=np.int64) - run_start[run_id]
    lanes = max(int(lane_sorted.max(initial=-1)) + 1, 1)

    send_idx = np.full((u_n, u_n, lanes), -1, dtype=np.int32)
    send_idx[src[order], pu[order], lane_sorted] = local_of_block[pg[order]]

    recv_src = np.zeros((u_n, w_max), dtype=np.int32)
    recv_lane = np.zeros((u_n, w_max), dtype=np.int32)
    recv_src[pu, slot] = src.astype(np.int32)
    lane_of_pair = np.empty(pu.shape[0], dtype=np.int64)
    lane_of_pair[order] = lane_sorted
    recv_lane[pu, slot] = lane_of_pair.astype(np.int32)
    return send_idx, recv_src, recv_lane, lanes


def build_selective_plan(plan: DevicePlan) -> SelectivePlan:
    """Derive the static all_to_all schedule from the tile structure.

    Fully vectorized (numpy segment ops over the sorted (unit, block)
    pairs — no per-needed-block Python); output is bit-identical to the
    original per-unit loop, which `tests/test_pack_golden.py` pins.
    """
    u_n = plan.num_units
    ncb = plan.num_col_blocks
    # x ownership: contiguous block-col ranges (matches how an iterative
    # solver leaves y sharded by rows == next x sharded by the same map).
    # Trailing units own nothing when NCB < U * per.
    per = -(-ncb // u_n)
    blocks = np.arange(ncb, dtype=np.int64)
    owned = np.full((u_n, per), -1, dtype=np.int32)
    owner_of_block = x_block_owner(ncb, u_n).astype(np.int32)
    local_of_block = (blocks % per).astype(np.int32)
    owned[owner_of_block, local_of_block] = blocks.astype(np.int32)

    # Needed block-cols per unit (C_Xk at tile granularity): unique
    # (unit, block) pairs over the real tiles. The sorted pair keys give
    # every unit's needed set contiguously, in ascending block order —
    # exactly the old per-unit np.unique output.
    t_idx = np.arange(plan.tile_col.shape[1], dtype=np.int64)
    real = t_idx[None, :] < plan.real_tiles[:, None]
    pair_key = (np.arange(u_n, dtype=np.int64)[:, None] * ncb + plan.tile_col)[real]
    pairs = np.unique(pair_key)
    pu = pairs // ncb  # destination unit of each needed block
    pg = (pairs % ncb).astype(np.int32)  # global block-col
    w_counts = np.bincount(pu, minlength=u_n)
    w_max = max(int(w_counts.max(initial=0)), 1)
    w_off = np.zeros(u_n + 1, dtype=np.int64)
    np.cumsum(w_counts, out=w_off[1:])
    slot = np.arange(pairs.shape[0], dtype=np.int64) - w_off[pu]

    needed = np.full((u_n, w_max), -1, dtype=np.int32)
    needed[pu, slot] = pg

    # Routes: blocks unit v must send to unit u, ascending block order.
    send_idx, recv_src, recv_lane, lanes = _route_pairs(
        pu, pg, slot, owner_of_block, local_of_block, u_n, w_max
    )

    tile_col_local = tile_col_local_from(needed, plan.tile_col, ncb).astype(
        plan.tile_col.dtype
    )

    wire = int((owner_of_block[pg].astype(np.int64) != pu).sum())
    naive = (u_n - 1) * ncb  # all-gather: every unit receives all remote blocks
    return SelectivePlan(
        num_units=u_n,
        blocks_per_unit=per,
        lanes=lanes,
        owned=owned,
        send_idx=send_idx,
        recv_src=recv_src,
        recv_lane=recv_lane,
        needed=needed,
        tile_col_local=tile_col_local,
        wire_blocks=wire,
        naive_blocks=naive,
    )
