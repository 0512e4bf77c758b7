"""Gather rows of a stack by an index, a zero row where the index is −1.

:func:`gather_rows` is the one launch of the selective exchange on one
device (``repro_torch/pmvc/dist.py::_workspace``): the padded x blocks
``[NCB, bn, B]`` into every unit's workspace ``[Lr, W', bn, B]``. Like
the other kernel wrappers it chooses by the tensors' device: on the card
one launch of the hand-written kernel of ``csrc/gather_rows.cu`` (built
at first use), elsewhere :func:`gather_rows_plain`, the same gather in
PyTorch operations. Both copy bits, so they agree bitwise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import load

__all__ = ["gather_rows", "gather_rows_plain"]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("gather_rows")
    lib.gather_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.gather_rows.restype = ctypes.c_int
    lib.gather_rows_error_string.argtypes = [ctypes.c_int]
    lib.gather_rows_error_string.restype = ctypes.c_char_p
    return lib


def gather_rows_plain(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows` in PyTorch operations: one ``index_select``,
    then a fill of the −1 slots where there are any."""
    flat = index.reshape(-1)
    out = src.index_select(0, flat.clamp(min=0))
    zero = flat < 0
    if bool(zero.any()):
        out[zero] = 0
    return out.reshape(*index.shape, *src.shape[1:])


def gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[s] = src[index[s]]`` along dim 0, and a zero row where
    ``index[s]`` is −1: ``index`` (int64, any shape, each −1 or a row of
    ``src``) → ``index.shape + src.shape[1:]``, ``src``'s dtype. CUDA
    tensors take one launch on the current stream and add one to
    ``gather_rows.launches``; others run :func:`gather_rows_plain`.

    The launch does not check ``index``: an entry past ``src``'s rows
    reads other device memory, where the plain version raises. The
    caller checks it once, where it is fixed (the exchange, when its
    step is built: ``repro_torch/pmvc/dist.py::_Exchange``)."""
    if index.dtype != torch.int64 or index.device != src.device:
        raise ValueError(f"index must be int64 on {src.device}, got {index.dtype} on "
                         f"{index.device}")
    if src.device.type != "cuda":
        return gather_rows_plain(src, index)
    src, index = src.contiguous(), index.contiguous()
    out = torch.empty(tuple(index.shape) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    row_bytes = math.prod(src.shape[1:]) * src.element_size()
    with torch.cuda.device(src.device):
        rc = _library().gather_rows(src.data_ptr(), index.data_ptr(), out.data_ptr(),
                                    index.numel(), row_bytes,
                                    torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        msg = _library().gather_rows_error_string(rc).decode()
        raise RuntimeError(f"gather_rows launch failed: {msg} (cudaError {rc})")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
