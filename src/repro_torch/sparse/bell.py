"""Block-ELL (BELL) packing helpers — the PMVC matrix layout.

A copy of the JAX package's ``repro/sparse/bell.py``, cut to what the
port uses, so that both packages plan bit-identically: the stacked
per-unit helpers of the planner and the per-shard packing
(:func:`pack_bell`) behind the single-shard kernel entry points. DESIGN.md §2: A
is re-blocked into dense (bm × bn) tiles, empty tiles are dropped, and
every unit's tile list is padded to the global maximum T — the padding
ratio realizes the paper's load-balance metric as wasted FLOPs.

Per-unit arrays handed to the Block-ELL SpMM kernel
(:mod:`repro_torch.kernels.spmv`):

* ``tiles    [T, bm, bn]``  dense tile values (zero-padded)
* ``tile_row [T]``          local block-row index of each tile
* ``tile_col [T]``          global block-col index (x gather index)

Tiles are sorted by ``tile_row`` so the kernel can stream-accumulate.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.sparse.formats import COO

__all__ = [
    "BellShard",
    "BellMatrix",
    "pack_bell",
    "tile_counts",
    "pad_x_blocks",
    "split_tiles_local_halo",
    "stack_ragged",
    "ragged_from_stacked",
    "repad_stacked",
    "x_block_owner",
]


def x_block_owner(num_col_blocks: int, num_units: int) -> np.ndarray:
    """The x-ownership map every exchange plan assumes: block-cols are
    assigned to units in contiguous ``ceil(NCB / U)`` runs. Returns the
    ``[NCB]`` int64 owner-unit array. Both
    :func:`repro_torch.pmvc.plan_device.build_selective_plan` and the
    locality-affinity tables in :mod:`repro_torch.core.combined` derive
    ownership from this single definition, so the partitioner optimizes
    exactly the layout the runtime distributes."""
    per = -(-num_col_blocks // num_units)
    return np.arange(num_col_blocks, dtype=np.int64) // per


def stack_ragged(
    flat: np.ndarray, counts: np.ndarray, t: int | None = None
) -> np.ndarray:
    """Scatter a unit-major ragged concatenation into zero-padded stacked
    form: ``flat`` holds unit 0's ``counts[0]`` entries, then unit 1's,
    ...; the result is ``[U, T, ...]`` with each unit's entries in their
    original order and zero padding past ``counts[u]`` (``T =
    max(counts, 1)`` unless given). The shared re-pad primitive behind
    the vectorized :func:`repro_torch.pmvc.plan_device.pack_units` and the
    sparse (v2) plan-store format, which persists only real tiles and
    rebuilds padding on load.
    """
    counts = np.asarray(counts, dtype=np.int64)
    u = counts.shape[0]
    if t is None:
        t = max(int(counts.max(initial=0)), 1)
    offsets = np.zeros(u + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])
    if flat.shape[0] != total:
        raise ValueError(f"flat has {flat.shape[0]} entries, counts sum to {total}")
    unit = np.repeat(np.arange(u, dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - offsets[unit]
    out = np.zeros((u * t,) + flat.shape[1:], dtype=flat.dtype)
    out[unit * t + within] = flat
    return out.reshape((u, t) + flat.shape[1:])


def ragged_from_stacked(stacked: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Inverse of :func:`stack_ragged`: drop the padding, returning the
    unit-major concatenation of each unit's first ``counts[u]`` entries."""
    counts = np.asarray(counts, dtype=np.int64)
    mask = np.arange(stacked.shape[1], dtype=np.int64)[None, :] < counts[:, None]
    return stacked[mask]


def repad_stacked(
    stacked: np.ndarray, counts: np.ndarray, t: int
) -> np.ndarray:
    """Re-pad a ``[U, T, ...]`` stacked-ragged array to a new capacity ``t``
    with zeroed padding: row ``u`` keeps its first ``min(counts[u], t)``
    entries in order; everything past that is zero.  The growth/shrink
    primitive behind :func:`repro_torch.pmvc.plan_device.patch_device_plan`, which
    re-pads untouched units' tile runs when a streaming delta changes the
    global tile capacity."""
    counts = np.asarray(counts, dtype=np.int64)
    out = np.zeros((stacked.shape[0], t) + stacked.shape[2:], dtype=stacked.dtype)
    t_copy = min(stacked.shape[1], t)
    mask = np.arange(t_copy, dtype=np.int64)[None, :] < counts[:, None]
    out[:, :t_copy][mask] = stacked[:, :t_copy][mask]
    return out


def pad_x_blocks(x: np.ndarray, num_col_blocks: int, bn: int) -> np.ndarray:
    """Zero-pad ``x`` to ``num_col_blocks * bn`` and reshape to the
    block-column layout every BELL consumer gathers from: ``[NCB, bn]``
    for a single vector ``[N]``, ``[NCB, bn, B]`` (trailing batch axis,
    the SpMM right-hand-side stack) for a batch ``[B, N]``.

    The single block-pad implementation — the distributed executor
    (:mod:`repro_torch.pmvc.dist`) and the per-shard kernel entry
    (:func:`repro_torch.kernels.spmv.ops.pack_inputs`) both route here.
    """
    x = np.asarray(x)
    if x.ndim == 1:
        xp = np.zeros(num_col_blocks * bn, dtype=np.float32)
        xp[: x.shape[0]] = x
        return xp.reshape(num_col_blocks, bn)
    if x.ndim != 2:
        raise ValueError(f"x must be [N] or [B, N], got shape {x.shape}")
    b, n = x.shape
    xp = np.zeros((b, num_col_blocks * bn), dtype=np.float32)
    xp[:, :n] = x
    return np.moveaxis(xp.reshape(b, num_col_blocks, bn), 0, -1)


def split_tiles_local_halo(
    tile_col: np.ndarray,
    num_real: int,
    owned_blocks: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Partition one shard's *real* tiles into the **local** set (tile
    column's x block is owned by the shard's unit — computable before any
    exchange completes) and the **halo** set (x block arrives with the
    selective all_to_all). DESIGN.md §9: the plan-time split behind the
    overlapped execution mode.

    ``tile_col`` is the shard's ``[T]`` global block-col array (entries at
    index ≥ ``num_real`` are padding and ignored); ``owned_blocks`` lists
    the global block-cols the unit owns (−1 entries are padding).

    Returns ``(local_idx, halo_idx)`` — int32 tile indices, each sorted
    ascending, that exactly partition ``arange(num_real)``: their union
    covers every real tile, they are disjoint, and every ``local_idx``
    tile references an owned x block (every ``halo_idx`` tile a remote
    one).
    """
    k = int(num_real)
    tc = np.asarray(tile_col)[:k]
    owned = np.asarray(owned_blocks).reshape(-1)
    owned = owned[owned >= 0]
    is_local = np.isin(tc, owned)
    idx = np.arange(k, dtype=np.int32)
    return idx[is_local], idx[~is_local]


@dataclasses.dataclass(frozen=True)
class BellShard:
    """One compute unit's padded tile set."""

    tiles: np.ndarray  # [T, bm, bn] float32
    tile_row: np.ndarray  # [T] int32, local block-row of the tile
    tile_col: np.ndarray  # [T] int32, global block-col of the tile
    row_blocks: np.ndarray  # [R] int32, global block-row ids owned (local r -> global)
    num_real: int  # tiles before padding

    @property
    def t(self) -> int:
        return int(self.tiles.shape[0])


@dataclasses.dataclass(frozen=True)
class BellMatrix:
    """All shards of one matrix + global metadata."""

    shape: Tuple[int, int]
    bm: int
    bn: int
    shards: List[BellShard]
    lb_tiles: float  # max/avg real tiles per shard (LB realized as padding)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def t(self) -> int:
        return self.shards[0].t if self.shards else 0

    @property
    def padded_tile_total(self) -> int:
        return sum(s.t for s in self.shards)

    @property
    def real_tile_total(self) -> int:
        return sum(s.num_real for s in self.shards)


def tile_counts(a: COO, bm: int, bn: int) -> np.ndarray:
    """Non-empty (bm × bn) tiles per block-row — the NEZGT weight vector of
    the TPU adaptation (DESIGN.md §5.2)."""
    rb = a.row // bm
    cb = a.col // bn
    nrb = -(-a.shape[0] // bm)
    key = rb.astype(np.int64) * (-(-a.shape[1] // bn)) + cb
    uniq = np.unique(key)
    counts = np.bincount((uniq // (-(-a.shape[1] // bn))).astype(np.int64), minlength=nrb)
    return counts.astype(np.int64)


def pack_bell(
    a: COO,
    owner_of_block_row: Sequence[int] | np.ndarray,
    num_shards: int,
    bm: int,
    bn: int,
) -> BellMatrix:
    """Pack ``a`` into per-shard BELL arrays given a block-row → shard map
    (produced by NEZGT over :func:`tile_counts`)."""
    n, m = a.shape
    nrb = -(-n // bm)
    ncb = -(-m // bn)
    owner = np.asarray(owner_of_block_row, dtype=np.int32)
    assert owner.shape[0] == nrb, (owner.shape, nrb)

    rb = (a.row // bm).astype(np.int64)
    cb = (a.col // bn).astype(np.int64)
    tile_key = rb * ncb + cb
    order = np.argsort(tile_key, kind="stable")
    tk_sorted = tile_key[order]
    uniq_keys, first = np.unique(tk_sorted, return_index=True)

    # Dense tile construction: scatter elements into their tile.
    tile_of_elem = np.searchsorted(uniq_keys, tile_key)
    num_tiles = uniq_keys.shape[0]
    all_tiles = np.zeros((num_tiles, bm, bn), dtype=np.float32)
    all_tiles[tile_of_elem, a.row % bm, a.col % bn] = a.val.astype(np.float32)
    tile_rb = (uniq_keys // ncb).astype(np.int64)
    tile_cb = (uniq_keys % ncb).astype(np.int32)

    # Group tiles per shard.
    shard_of_tile = owner[tile_rb]
    real_counts = np.bincount(shard_of_tile, minlength=num_shards)
    t_max = max(int(real_counts.max(initial=0)), 1)

    shards: List[BellShard] = []
    for s in range(num_shards):
        sel = np.nonzero(shard_of_tile == s)[0]
        # Local block-row numbering: global block-rows owned by shard s,
        # in ascending order (rows this shard produces y for).
        my_rows = np.nonzero(owner == s)[0].astype(np.int32)
        g2l = {int(g): i for i, g in enumerate(my_rows)}
        loc_row = np.array([g2l[int(g)] for g in tile_rb[sel]], dtype=np.int32)
        # Sort by local row so the kernel accumulates contiguously.
        srt = np.argsort(loc_row, kind="stable")
        sel = sel[srt]
        loc_row = loc_row[srt]
        pad = t_max - sel.shape[0]
        tiles = np.concatenate(
            [all_tiles[sel], np.zeros((pad, bm, bn), dtype=np.float32)], axis=0
        )
        tile_row = np.concatenate(
            [loc_row, np.zeros(pad, dtype=np.int32)]
        )
        tile_col = np.concatenate([tile_cb[sel], np.zeros(pad, dtype=np.int32)])
        shards.append(
            BellShard(
                tiles=tiles,
                tile_row=tile_row.astype(np.int32),
                tile_col=tile_col.astype(np.int32),
                row_blocks=my_rows,
                num_real=int(sel.shape[0]),
            )
        )

    avg = real_counts.mean() if num_shards else 0.0
    lb = float(real_counts.max() / avg) if avg > 0 else 1.0
    return BellMatrix(shape=a.shape, bm=bm, bn=bn, shards=shards, lb_tiles=lb)
