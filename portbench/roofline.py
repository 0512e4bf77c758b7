"""Peaks of the card and the operation and byte counts of the sparse
product, frozen here so that a change to the program cannot move the
yardstick.

Peaks: NVIDIA H100 SXM data sheet at its 700 W limit (dense rates):
HBM3 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores. The
program's products are float32 outside the tensor cores, so that peak
applies. A share is always stated beside the card's power limit.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 peak."""
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def csr_spmv_counts(nnz: int, n_rows: int, n_cols: int, batch: int) -> tuple:
    """(bytes, operations) that ``y = A x`` needs at batch width B,
    whatever implements it: each stored non-zero's float32 value and
    int32 column index read once, the int32 row pointers once, x read
    once and y written once; two operations a non-zero a column. No
    tile, padding, partial or exchange buffer is counted."""
    bytes_moved = nnz * 8 + (n_rows + 1) * 4 + n_cols * batch * 4 + n_rows * batch * 4
    return float(bytes_moved), 2.0 * nnz * batch


def bell_spmm_counts(real_tiles: int, bm: int, bn: int, units: int, nrb: int,
                     xsrc_blocks: int, batch: int) -> tuple:
    """(bytes, operations) of one ``bell_spmm`` launch over a plan, as
    ``chip_smoke.py``'s ``[times]`` counts them: the real tiles read
    once, their int32 source indices and each unit's int32 row pointers,
    the x source (``xsrc_blocks`` blocks of ``bn × B`` float32) and every
    unit's float32 partial ``[NRB, bm, B]`` written; two operations a
    tile element a column."""
    bytes_moved = (real_tiles * bm * bn * 4 + real_tiles * 4 + units * (nrb + 1) * 4
                   + xsrc_blocks * bn * batch * 4 + units * nrb * bm * batch * 4)
    return float(bytes_moved), 2.0 * real_tiles * bm * bn * batch
