"""The Block-ELL SpMM kernel's wrapper: hoisted tile sets and the launch.

:func:`bell_tiles` puts one stacked tile set on a device in the layout
the kernel reads — each unit's real tiles in stable block-row order plus
a per-unit row pointer — and :func:`bell_spmm` computes, for all units
in one launch,

    ``out[u, r] = Σ_{t: tile_row[u, t] = r} tiles[u, t] @ xsrc[u or 0, tile_src[u, t]]``

the JAX package's ``repro/kernels/spmv/kernel.py::bell_spmm``, stacked
over the unit axis. On a CUDA tensor it launches one of the hand-written
kernels of ``csrc/bell_spmm.cu`` (built at first use), the variant that
:func:`spmm_variant` names from type and shape alone, before the launch:

* ``ring`` — the ``stream`` shapes at narrow batch widths (B up to
  ``RING_MAX_BATCH``): a persistent grid walks pieces of whole block-rows
  (:func:`ring_pieces`), a producer warp streams each piece's tiles
  through a TMA ring, a thread per output keeps its chain in a register;
* ``stream`` — ``bm`` a multiple of 8 up to 32 and ``bn`` in {8, 16,
  32}, the wider B: a block per span of block-rows (:func:`row_spans`),
  tiles streamed through a ``cp.async`` ring, a register patch of
  outputs a thread;
* ``simt`` — every other shape, within its shared memory
  (:func:`simt_limit`): a block per (unit, block-row, column chunk).

All keep one summation order, so column b of a result is bitwise the
same whatever B and whichever variant ran. On a CPU tensor it runs the
plain version :func:`repro_torch.kernels.spmv.ref.bell_spmm_plain`.
There is no other path: a tensor elsewhere raises.

The single-shard entry points of the JAX package's
``repro/kernels/spmv/ops.py`` sit on top: :func:`pack_inputs` puts one
:class:`repro_torch.sparse.bell.BellShard` and its x on a device,
:func:`spmm_shard` / :func:`spmv_shard` run the kernel on it as one
unit, and :func:`spmm_shard_ref` / :func:`spmv_shard_ref` are the plain
version on the same arguments.
"""
from __future__ import annotations

import ctypes
import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.build import load
from repro_torch.kernels.spmv.ref import bell_spmm_plain
from repro_torch.sparse.bell import BellShard, pad_x_blocks

__all__ = ["BLOCK_SIZES", "VARIANTS", "BellTiles", "bell_tiles", "bell_spmm", "host_tensor",
           "pack_inputs", "ring_pieces",
           "row_spans", "simt_limit", "spmm_shard", "spmm_shard_ref", "spmm_variant",
           "spmv_shard", "spmv_shard_ref"]

# The tile sides of chip_smoke.py's kernel sweep. Any bm, bn >= 1 is taken:
# the stream variant's shapes below, every other one on simt.
BLOCK_SIZES = (8, 16, 32, 64, 128)
_TYPES = {torch.float32: "f32", torch.float16: "f16"}
VARIANTS = ("ring", "stream", "simt")
# The shapes csrc/bell_spmm.cu instantiates for stream (launch_stream), and
# for ring at batch widths up to RING_MAX_BATCH (launch_ring).
STREAM_MAX_BM = 32  # bm a multiple of 8 up to this
STREAM_BN = (8, 16, 32)
# ring beat stream at B = 1 to 3 on the banded and the 64^3 stencil plans,
# float32 and float16; at B = 4 stream's 1 x 4 patch won on float16 banded
# tiles (measured on an H100; PERF.md, Findings).
RING_MAX_BATCH = 3
# The simt kernel's limits (csrc/bell_spmm.cu): a block holds at most
# SIMT_MAX_OUTPUTS outputs (bm x its column chunk) and SIMT_MAX_SMEM_BYTES
# of float32 tile and x block in shared memory.
SIMT_MAX_OUTPUTS = 1024
SIMT_MAX_SMEM_BYTES = 96 * 1024
# A span holds at most this many output rows (64 // bm block-rows: a
# block's threads, csrc/bell_spmm.cu kSpanOutRows) and, unless it is one
# row, at most SPAN_TILES_PER_ROW tiles for each of them.
SPAN_OUT_ROWS = 64
SPAN_TILES_PER_ROW = 4
# A ring piece holds about RING_PIECE_BYTES of tiles and at most
# RING_PIECE_ROWS block-rows (a run of empty rows stays one piece's work).
RING_PIECE_BYTES = 32 * 1024
RING_PIECE_ROWS = 256


def spmm_variant(dtype: torch.dtype, bm: int, bn: int, batch: int) -> str:
    """The CUDA kernel that takes ``dtype`` tiles of ``bm × bn`` at batch
    width ``batch``: for the shapes ``ring`` and ``stream`` are
    instantiated for (bm a multiple of 8 up to 32, bn in {8, 16, 32}),
    ``ring`` up to ``RING_MAX_BATCH`` columns and ``stream`` past it;
    ``simt`` otherwise. Pure: type and shape alone decide."""
    if dtype in _TYPES and bm % 8 == 0 and bm <= STREAM_MAX_BM and bn in STREAM_BN:
        return "ring" if batch <= RING_MAX_BATCH else "stream"
    return "simt"


def simt_limit(bm: int, bn: int, batch: int) -> str | None:
    """Why the ``simt`` kernel cannot take ``bm × bn`` tiles at batch width
    ``batch``, or None when it can. It gives a block ``max(1, 1024 // bm)``
    columns (at most B) and stages the float32 tile and that x block in
    shared memory, so a tile taller than ``SIMT_MAX_OUTPUTS`` rows, or a
    tile and x block over ``SIMT_MAX_SMEM_BYTES``, does not fit."""
    if bm > SIMT_MAX_OUTPUTS:
        return f"bm={bm} exceeds the simt kernel's {SIMT_MAX_OUTPUTS} outputs a block"
    chunk = min(max(1, SIMT_MAX_OUTPUTS // bm), batch)
    smem = 4 * (bm * bn + bn * chunk)
    if smem > SIMT_MAX_SMEM_BYTES:
        return (f"a {bm}x{bn} float32 tile and its {bn}x{chunk} x block take {smem} bytes, "
                f"over the simt kernel's {SIMT_MAX_SMEM_BYTES} bytes of shared memory")
    return None


def row_spans(row_ptr: np.ndarray, bm: int) -> np.ndarray:
    """``[NS, 3]`` int32 rows ``(unit, r0, r1)``: every unit's block-rows
    cut into spans of consecutive rows, each of which one block of the
    ``stream`` kernel owns (its tiles are the contiguous run
    ``row_ptr[u, r0] : row_ptr[u, r1]``). Every (unit, row) lies in
    exactly one span, empty rows included, and a row is never split.

    Greedy in row order: a span takes rows until it holds
    ``SPAN_OUT_ROWS // bm`` of them, or until the next row would carry
    its tiles past ``SPAN_TILES_PER_ROW`` per row of that limit — so
    spans hold about the same number of tiles, and one longer row stands
    alone."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    max_rows = max(1, SPAN_OUT_ROWS // bm)
    max_tiles = SPAN_TILES_PER_ROW * max_rows
    spans = []
    for u, per_row in enumerate(np.diff(row_ptr, axis=1).tolist()):
        r0, held = 0, 0
        for r, c in enumerate(per_row):
            if r > r0 and (r - r0 == max_rows or held + c > max_tiles):
                spans.append((u, r0, r))
                r0, held = r, 0
            held += c
        if per_row:
            spans.append((u, r0, len(per_row)))
    return np.asarray(spans, dtype=np.int32).reshape(-1, 3)


def ring_pieces(row_ptr: np.ndarray, tiles_per_piece: int) -> np.ndarray:
    """``[NP, 5]`` int32 rows ``(unit, r0, r1, t0, t1)``: every unit's
    block-rows cut into pieces of consecutive rows, the work list that
    the ``ring`` kernel's blocks walk. A piece's tiles are the contiguous
    run ``t0 = row_ptr[u, r0] : t1 = row_ptr[u, r1]``. Every (unit, row)
    lies in exactly one piece, empty rows included, and a row is never
    split.

    A row joins the piece of the row before it unless it starts a unit,
    is a multiple of ``RING_PIECE_ROWS``, or its first tile lies past a later
    multiple of ``tiles_per_piece`` than that row's first tile: so a
    piece's rows start within ``tiles_per_piece`` tiles of each other,
    and a piece holds about that many tiles, more only by its last
    row's. Vectorised: one pass over the row pointer."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    u_n, nrb = row_ptr.shape[0], row_ptr.shape[1] - 1
    if u_n == 0 or nrb == 0:
        return np.zeros((0, 5), np.int32)
    bucket = row_ptr[:, :-1] // max(1, int(tiles_per_piece))
    new = np.zeros((u_n, nrb), bool)
    new[:, 1:] = bucket[:, 1:] != bucket[:, :-1]
    new[:, ::RING_PIECE_ROWS] = True
    unit, r0 = np.nonzero(new)  # units in order, rows ascending
    r1 = np.append(r0[1:], nrb)
    r1[np.append(unit[1:] != unit[:-1], True)] = nrb  # a unit's last piece
    return np.stack([unit, r0, r1, row_ptr[unit, r0], row_ptr[unit, r1]],
                    axis=1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BellTiles:
    """One stacked tile set on a device, as the kernel reads it.

    Within each unit the ``counts[u]`` real tiles come first, in stable
    block-row order; ``row_ptr[u, r] : row_ptr[u, r + 1]`` is block-row
    r's run. Padding tiles sit past ``counts[u]`` and are never read.
    ``spans`` is :func:`row_spans` of that row pointer, the ``stream``
    kernel's grid, and ``pieces`` :func:`ring_pieces` of it, the ``ring``
    kernel's work list, both computed once here."""

    tiles: torch.Tensor  # [U, T, bm, bn] float32 or float16
    tile_row: torch.Tensor  # [U, T] int32 global block-row
    tile_src: torch.Tensor  # [U, T] int32 index into the unit's x source
    row_ptr: torch.Tensor  # [U, NRB + 1] int32
    spans: torch.Tensor  # [NS, 3] int32 (unit, r0, r1)
    pieces: torch.Tensor  # [NP, 5] int32 (unit, r0, r1, t0, t1)
    counts: np.ndarray  # [U] int64 real tiles per unit (host)
    nrb: int
    src_bound: int  # 1 + the largest tile_src of a real tile (0 if none)

    @property
    def real_tiles(self) -> int:
        return int(self.counts.sum())


def host_tensor(a: np.ndarray, device) -> torch.Tensor:
    """``torch.as_tensor(a, device=device)`` for plan arrays. A plan
    loaded lazily from its archive holds read-only memory maps: on the
    CPU the tensor aliases the map, on the card the bytes are copied.
    torch warns that it cannot write into such a map; nothing does, as
    plan tensors are only ever read, so the warning is not shown."""
    if getattr(a, "flags", None) is not None and not a.flags.writeable:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, device=device)


def bell_tiles(
    tiles: torch.Tensor,
    tile_row: np.ndarray,
    tile_src: np.ndarray,
    counts: np.ndarray,
    nrb: int,
) -> BellTiles:
    """Check one stacked tile set and lay it out for :func:`bell_spmm`.

    ``tiles`` is already on its device; the index arrays are host numpy
    and go to the same device. Each unit's real tiles are sorted by
    block-row with a stable sort, which keeps the plan's index order
    within a row; the plans the port builds are sorted already, and then
    nothing is copied."""
    tile_row = np.asarray(tile_row)
    tile_src = np.asarray(tile_src)
    counts = np.asarray(counts, dtype=np.int64)
    if tile_row.ndim != 2 or tile_src.shape != tile_row.shape:
        raise ValueError(
            f"tile_row and tile_src must both be [U, T], got {tile_row.shape} "
            f"and {tile_src.shape}"
        )
    u_n, t_n = tile_row.shape
    if tiles.dim() != 4 or tuple(tiles.shape[:2]) != (u_n, t_n):
        raise ValueError(f"tiles must be [U={u_n}, T={t_n}, bm, bn], got {tuple(tiles.shape)}")
    bm, bn = int(tiles.shape[2]), int(tiles.shape[3])
    if bm < 1 or bn < 1:
        raise ValueError(f"tile shape ({bm}, {bn}) must be at least 1 x 1")
    if tiles.dtype not in _TYPES:
        raise TypeError(f"tiles must be float32 or float16, got {tiles.dtype}")
    if counts.shape != (u_n,) or (counts < 0).any() or (counts > t_n).any():
        raise ValueError(f"counts must be [U={u_n}] in [0, {t_n}], got {counts}")
    real = np.arange(t_n)[None, :] < counts[:, None]
    rows = tile_row.astype(np.int64)
    if real.any():
        if rows[real].min() < 0 or rows[real].max() >= nrb:
            raise ValueError(f"tile_row of a real tile outside [0, {nrb})")
        if tile_src[real].min() < 0:
            raise ValueError("tile_src of a real tile is negative")
    src_bound = int(tile_src[real].max()) + 1 if real.any() else 0

    order = np.argsort(np.where(real, rows, nrb), axis=1, kind="stable")
    if not (order == np.arange(t_n)[None, :]).all():
        idx = torch.as_tensor(order, device=tiles.device)
        tiles = torch.take_along_dim(tiles, idx[:, :, None, None], dim=1)
        tile_row = np.take_along_axis(tile_row, order, axis=1)
        tile_src = np.take_along_axis(tile_src, order, axis=1)
        rows = tile_row.astype(np.int64)

    unit = np.broadcast_to(np.arange(u_n, dtype=np.int64)[:, None], real.shape)
    per_row = np.bincount(
        (unit[real] * nrb + rows[real]), minlength=u_n * nrb
    ).reshape(u_n, nrb)
    row_ptr = np.zeros((u_n, nrb + 1), dtype=np.int32)
    np.cumsum(per_row, axis=1, out=row_ptr[:, 1:])

    def dev(a):
        return host_tensor(np.ascontiguousarray(a, dtype=np.int32), tiles.device)

    return BellTiles(
        tiles=tiles.contiguous(),
        tile_row=dev(tile_row),
        tile_src=dev(tile_src),
        row_ptr=dev(row_ptr),
        spans=dev(row_spans(row_ptr, bm)),
        pieces=dev(ring_pieces(row_ptr, RING_PIECE_BYTES // (bm * bn * tiles.element_size()))),
        counts=counts,
        nrb=int(nrb),
        src_bound=src_bound,
    )


def _library() -> ctypes.CDLL:
    lib = load("bell_spmm")
    # stream also takes the spans; ring the pieces and the unit count.
    for variant, pointers, ints in (("simt", 5, 6), ("stream", 6, 6), ("ring", 6, 7)):
        for tname in _TYPES.values():
            fn = getattr(lib, f"bell_spmm_{variant}_{tname}")
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
                ctypes.c_longlong,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
    lib.bell_spmm_error_string.argtypes = [ctypes.c_int]
    lib.bell_spmm_error_string.restype = ctypes.c_char_p
    return lib


def bell_spmm(bt: BellTiles, xsrc: torch.Tensor) -> torch.Tensor:
    """Every unit's partial y, ``[U, NRB, bm, B]`` float32, from the tile
    set ``bt`` and the x source ``xsrc`` ``[U or 1, S, bn, B]`` (a leading
    1 means all units read the same source).

    CUDA tensors launch the kernel that :func:`spmm_variant` names on the
    current stream and add one to ``bell_spmm.launches`` and to that
    variant's ``bell_spmm.variant_launches``; the ``ring`` and ``stream``
    kernels want ``tiles`` and ``xsrc`` 16-byte aligned, and a shape past the ``simt``
    kernel's shared memory (:func:`simt_limit`) raises ``ValueError``
    before the launch. CPU tensors run the plain version."""
    tiles = bt.tiles
    u_n, t_n, bm, bn = tiles.shape
    if xsrc.device != tiles.device:
        raise ValueError(f"xsrc is on {xsrc.device}, the tiles on {tiles.device}")
    if xsrc.dtype != tiles.dtype:
        raise TypeError(f"xsrc is {xsrc.dtype}, the tiles {tiles.dtype}")
    if (
        xsrc.dim() != 4
        or xsrc.shape[0] not in (1, u_n)
        or xsrc.shape[2] != bn
        or xsrc.shape[3] < 1
    ):
        raise ValueError(
            f"xsrc must be [1 or U={u_n}, S, bn={bn}, B>=1], got {tuple(xsrc.shape)}"
        )
    if xsrc.shape[1] < bt.src_bound:
        raise ValueError(
            f"tile_src reaches source {bt.src_bound - 1}, xsrc has {xsrc.shape[1]}"
        )
    if tiles.device.type == "cpu":
        return bell_spmm_plain(
            tiles, bt.tile_row, bt.tile_src, bt.counts, xsrc, bt.nrb
        )
    if tiles.device.type != "cuda":
        raise RuntimeError(f"bell_spmm runs on CUDA or CPU tensors, not {tiles.device}")
    if not xsrc.is_contiguous():
        raise ValueError("xsrc must be contiguous")
    batch = int(xsrc.shape[3])
    variant = spmm_variant(tiles.dtype, bm, bn, batch)
    if variant != "simt" and (tiles.data_ptr() % 16 or xsrc.data_ptr() % 16):
        raise ValueError(f"the {variant} kernel copies 16-byte pieces: tiles and xsrc must "
                         "start on 16-byte boundaries")
    if variant == "simt":
        limit = simt_limit(bm, bn, batch)
        if limit is not None:
            raise ValueError(limit)
    out = torch.empty((u_n, bt.nrb, bm, batch), dtype=torch.float32, device=tiles.device)
    ustride = 0 if xsrc.shape[0] == 1 else int(xsrc.shape[1]) * bn * batch
    lib = _library()
    fn = getattr(lib, f"bell_spmm_{variant}_{_TYPES[tiles.dtype]}")
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        if variant == "ring":
            rc = fn(tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(),
                    xsrc.data_ptr(), bt.pieces.data_ptr(), out.data_ptr(),
                    int(bt.pieces.shape[0]), u_n, t_n, bt.nrb, bm, bn, batch, ustride, stream)
        elif variant == "stream":
            rc = fn(tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(),
                    xsrc.data_ptr(), bt.spans.data_ptr(), out.data_ptr(),
                    int(bt.spans.shape[0]), t_n, bt.nrb, bm, bn, batch, ustride, stream)
        else:
            rc = fn(tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(),
                    xsrc.data_ptr(), out.data_ptr(),
                    u_n, t_n, bt.nrb, bm, bn, batch, ustride, stream)
    if rc != 0:
        msg = lib.bell_spmm_error_string(rc).decode()
        raise RuntimeError(f"bell_spmm launch failed ({variant}): {msg} (cudaError {rc})")
    bell_spmm.launches += 1
    bell_spmm.variant_launches[variant] += 1
    return out


bell_spmm.launches = 0
bell_spmm.variant_launches = dict.fromkeys(VARIANTS, 0)


# -- single-shard entry points ---------------------------------------------


def pack_inputs(
    shard: BellShard, x: np.ndarray, bn: int, *, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's ``(tiles, tile_row, tile_col, x_blocks)`` as tensors on
    ``device`` (the card unless the caller names another). ``x`` may be
    ``[N]`` (x blocks come back ``[NCB, bn]``) or a batch ``[B, N]``
    (``[NCB, bn, B]``)."""
    dev = resolve_device(device)
    ncb = -(-x.shape[-1] // bn)
    return (
        torch.as_tensor(shard.tiles, device=dev),
        torch.as_tensor(shard.tile_row, device=dev),
        torch.as_tensor(shard.tile_col, device=dev),
        torch.as_tensor(np.ascontiguousarray(pad_x_blocks(x, ncb, bn)), device=dev),
    )


def spmm_shard(
    tiles: torch.Tensor,  # [T, bm, bn]
    tile_row: torch.Tensor,  # [T] local block-row
    tile_col: torch.Tensor,  # [T] global block-col
    x_blocks: torch.Tensor,  # [NCB, bn, B]
    num_row_blocks: int,
) -> torch.Tensor:
    """One shard's batched PMVC: the local y blocks ``[R, bm, B]``. On a
    CUDA tensor one :func:`bell_spmm` launch as one unit; on a CPU tensor
    the plain version. Every one of the shard's T tiles counts, padding
    included: a padding tile is zero at row 0, so it adds nothing, as in
    the JAX package's kernel, which visits all T."""
    bt = bell_tiles(
        tiles[None], tile_row.cpu().numpy()[None], tile_col.cpu().numpy()[None],
        np.array([tiles.shape[0]]), num_row_blocks,
    )
    return bell_spmm(bt, x_blocks[None].contiguous())[0]


def spmv_shard(
    tiles: torch.Tensor,
    tile_row: torch.Tensor,
    tile_col: torch.Tensor,
    x_blocks: torch.Tensor,  # [NCB, bn]
    num_row_blocks: int,
) -> torch.Tensor:
    """One shard's PMVC: the local y blocks ``[R, bm]`` (B = 1 of
    :func:`spmm_shard`)."""
    return spmm_shard(tiles, tile_row, tile_col, x_blocks[..., None], num_row_blocks)[..., 0]


def spmm_shard_ref(
    tiles: torch.Tensor,
    tile_row: torch.Tensor,
    tile_col: torch.Tensor,
    x_blocks: torch.Tensor,  # [NCB, bn, B]
    num_row_blocks: int,
) -> torch.Tensor:
    """The plain version of :func:`spmm_shard` on any device:
    ``y[r] = Σ_{t: tile_row[t] = r} tiles[t] @ x_blocks[tile_col[t]]``."""
    return bell_spmm_plain(
        tiles[None], tile_row[None], tile_col[None], np.array([tiles.shape[0]]),
        x_blocks[None], num_row_blocks,
    )[0]


def spmv_shard_ref(
    tiles: torch.Tensor,
    tile_row: torch.Tensor,
    tile_col: torch.Tensor,
    x_blocks: torch.Tensor,  # [NCB, bn]
    num_row_blocks: int,
) -> torch.Tensor:
    """Single-vector (B = 1) view of :func:`spmm_shard_ref`."""
    return spmm_shard_ref(
        tiles, tile_row, tile_col, x_blocks[..., None], num_row_blocks
    )[..., 0]
