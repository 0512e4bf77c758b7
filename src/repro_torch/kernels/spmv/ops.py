"""The Block-ELL SpMM kernel's wrapper: hoisted tile sets and the launch.

:func:`bell_tiles` puts one stacked tile set on a device in the layout
the kernel reads — each unit's real tiles in stable block-row order plus
a per-unit row pointer — and :func:`bell_spmm` computes, for all units
in one launch,

    ``out[u, r] = Σ_{t: tile_row[u, t] = r} tiles[u, t] @ xsrc[u or 0, tile_src[u, t]]``

the JAX package's ``repro/kernels/spmv/kernel.py::bell_spmm``, stacked
over the unit axis. On a CUDA tensor it launches the hand-written
kernel ``csrc/bell_spmm.cu`` (built at first use); on a CPU tensor it
runs the plain version :func:`repro_torch.kernels.spmv.ref.bell_spmm_plain`.
There is no other path: a tensor elsewhere raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.spmv.ref import bell_spmm_plain

__all__ = ["BLOCK_SIZES", "BellTiles", "bell_tiles", "bell_spmm"]

# Tile heights and widths the kernel takes.
BLOCK_SIZES = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: "bell_spmm_f32", torch.float16: "bell_spmm_f16"}


@dataclasses.dataclass(frozen=True)
class BellTiles:
    """One stacked tile set on a device, as the kernel reads it.

    Within each unit the ``counts[u]`` real tiles come first, in stable
    block-row order; ``row_ptr[u, r] : row_ptr[u, r + 1]`` is block-row
    r's run. Padding tiles sit past ``counts[u]`` and are never read."""

    tiles: torch.Tensor  # [U, T, bm, bn] float32 or float16
    tile_row: torch.Tensor  # [U, T] int32 global block-row
    tile_src: torch.Tensor  # [U, T] int32 index into the unit's x source
    row_ptr: torch.Tensor  # [U, NRB + 1] int32
    counts: np.ndarray  # [U] int64 real tiles per unit (host)
    nrb: int
    src_bound: int  # 1 + the largest tile_src of a real tile (0 if none)

    @property
    def real_tiles(self) -> int:
        return int(self.counts.sum())


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
    if bm not in BLOCK_SIZES or bn not in BLOCK_SIZES:
        raise ValueError(f"tile shape ({bm}, {bn}) not in {BLOCK_SIZES}")
    if tiles.dtype not in _DTYPES:
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
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=tiles.device)

    return BellTiles(
        tiles=tiles.contiguous(),
        tile_row=dev(tile_row),
        tile_src=dev(tile_src),
        row_ptr=dev(row_ptr),
        counts=counts,
        nrb=int(nrb),
        src_bound=src_bound,
    )


def _library() -> ctypes.CDLL:
    lib = load("bell_spmm")
    for name in _DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
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

    CUDA tensors launch the kernel on the current stream and add one to
    ``bell_spmm.launches``; CPU tensors run the plain version."""
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
    out = torch.empty((u_n, bt.nrb, bm, batch), dtype=torch.float32, device=tiles.device)
    ustride = 0 if xsrc.shape[0] == 1 else int(xsrc.shape[1]) * bn * batch
    lib = _library()
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        rc = getattr(lib, _DTYPES[tiles.dtype])(
            tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(),
            xsrc.data_ptr(), out.data_ptr(),
            u_n, t_n, bt.nrb, bm, bn, batch, ustride, stream,
        )
    if rc != 0:
        msg = lib.bell_spmm_error_string(rc).decode()
        raise RuntimeError(f"bell_spmm launch failed: {msg} (cudaError {rc})")
    bell_spmm.launches += 1
    return out


bell_spmm.launches = 0
