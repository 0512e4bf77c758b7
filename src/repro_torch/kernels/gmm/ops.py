"""The grouped matmul's public entry points and host-side dispatch plan.

:func:`plan_groups` turns per-token expert assignments into the sorted,
block-padded layout and the per-row-tile expert ids the kernel needs; it
is a copy of the JAX package's ``repro/kernels/gmm/ops.py::plan_groups``
(that module imports JAX), so plans are bit-identical.

:func:`grouped_matmul` (alias :func:`gmm`) computes

    ``out[bm-row tile i] = x[tile i] @ w[group_of_tile[i]]``

the JAX package's ``repro/kernels/gmm/kernel.py::gmm``. On CUDA tensors
it launches one of the hand-written kernels of ``csrc/gmm.cu`` (built at
first use), the variant that :func:`gmm_variant` names from type and
shape alone, before the launch:

* ``wgmma`` — bf16 in, on the tensor cores (``wgmma`` fed by TMA);
* ``regblock`` — float32 in, register-blocked on the CUDA cores;
* ``simt`` — any other shape (a ``bm`` not a multiple of 64, K or N not
  a multiple of 8 for bf16 or of 4 for float32), on the CUDA cores.

On CPU tensors it runs the plain version
:func:`repro_torch.kernels.gmm.ref.gmm_plain`. There is no other path: a
tensor elsewhere raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.gmm.ref import gmm_plain

__all__ = ["VARIANTS", "gmm", "gmm_variant", "grouped_matmul", "plan_groups"]

_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
VARIANTS = ("wgmma", "regblock", "simt")


def gmm_variant(dtype: torch.dtype, bm: int, k: int, n: int) -> str:
    """The CUDA kernel that takes inputs of ``dtype`` with row tile ``bm``
    and ``K``, ``N``: ``wgmma`` for bf16 with ``bm % 64 == 0`` and K, N
    multiples of 8 (TMA's 16-byte row strides); ``regblock`` for float32
    with ``bm % 64 == 0`` and K, N multiples of 4 (16-byte ``cp.async``);
    ``simt`` otherwise. Pure: type and shape alone decide."""
    if bm % 64 == 0 and dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    if bm % 64 == 0 and dtype == torch.float32 and k % 4 == 0 and n % 4 == 0:
        return "regblock"
    return "simt"


def _library() -> ctypes.CDLL:
    lib = load("gmm")
    for tin in _TYPES.values():
        for tout in _TYPES.values():
            fn = getattr(lib, f"gmm_simt_{tin}_{tout}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for tout in _TYPES.values():
        for name in (f"gmm_wgmma_bf16_{tout}", f"gmm_regblock_f32_{tout}"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.gmm_error_string.argtypes = [ctypes.c_int]
    lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def grouped_matmul(
    x: torch.Tensor,  # [M, K] tokens sorted by expert, M % bm == 0
    w: torch.Tensor,  # [E, K, N] stacked expert weights
    group_of_tile: torch.Tensor,  # [M // bm] expert per row tile
    *,
    bm: int = 128,
    bk: int = 128,
    bn: int = 128,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``[M, N]`` ``out_dtype``: each ``bm``-row tile of ``x`` times the
    weights of its group, accumulated in float32.

    ``bk`` and ``bn`` are the reference's tile widths; they are checked
    (``K % bk == 0``, ``N % bn == 0``) as the reference asserts them,
    and the CUDA kernel tiles K and N its own way. ``bm`` must be a
    multiple of 8, as the reference's TPU tiling needs too. CUDA tensors
    launch the kernel that :func:`gmm_variant` names on the current stream
    and add one to ``grouped_matmul.launches`` and to that variant's
    ``grouped_matmul.variant_launches``; CPU tensors run the plain
    version."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x must be [M, K] and w [E, K, N], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    m, kdim = x.shape
    e, kw, n = w.shape
    if kdim != kw:
        raise ValueError(f"x has K={kdim}, w has K={kw}")
    if bm <= 0 or bm % 8 or m % bm or bk <= 0 or kdim % bk or bn <= 0 or n % bn:
        raise ValueError(f"(M, K, N) = {(m, kdim, n)} must be multiples of "
                         f"(bm, bk, bn) = {(bm, bk, bn)}, and bm a multiple of 8")
    if group_of_tile.shape != (m // bm,):
        raise ValueError(f"group_of_tile must be [M // bm = {m // bm}], got "
                         f"{tuple(group_of_tile.shape)}")
    if not (x.device == w.device == group_of_tile.device):
        raise ValueError(f"x, w and group_of_tile on {x.device}, {w.device} and "
                         f"{group_of_tile.device}: one device for all")
    if x.dtype != w.dtype or x.dtype not in _TYPES:
        raise TypeError(f"x and w must both be float32 or both bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if out_dtype not in _TYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if group_of_tile.dtype.is_floating_point or group_of_tile.dtype == torch.bool:
        raise TypeError(f"group_of_tile must hold integers, got {group_of_tile.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"grouped_matmul runs on CUDA or CPU tensors, not {x.device}")
    # A bad id would be an out-of-bounds read on the card.
    if group_of_tile.numel() and bool(
        (group_of_tile.min() < 0) | (group_of_tile.max() >= e)
    ):
        raise ValueError(f"group_of_tile holds an id outside [0, E={e})")
    if x.device.type == "cpu":
        return gmm_plain(x, w, group_of_tile, bm=bm, out_dtype=out_dtype)
    x = x.contiguous()
    w = w.contiguous()
    group = group_of_tile.to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    variant = gmm_variant(x.dtype, bm, kdim, n)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"gmm_{variant}_{_TYPES[x.dtype]}_{_TYPES[out_dtype]}")(
            x.data_ptr(), w.data_ptr(), group.data_ptr(), out.data_ptr(),
            m, kdim, n, e, bm, stream,
        )
    if rc != 0:
        msg = lib.gmm_error_string(rc).decode()
        raise RuntimeError(f"gmm launch failed ({variant}): {msg} (cudaError {rc})")
    grouped_matmul.launches += 1
    grouped_matmul.variant_launches[variant] += 1
    return out


grouped_matmul.launches = 0
grouped_matmul.variant_launches = dict.fromkeys(VARIANTS, 0)
gmm = grouped_matmul  # the reference's name (repro/kernels/gmm/__init__.py)


def plan_groups(
    expert_of_token: np.ndarray, num_experts: int, bm: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side dispatch plan.

    Returns ``(order, group_of_tile, padded_sizes)`` where ``order`` sorts
    tokens by expert with per-expert padding to a ``bm`` multiple (padding
    rows index ``-1`` — callers scatter zeros there), ``group_of_tile`` is
    the per-row-tile expert id, and ``padded_sizes`` the padded token
    count per expert.
    """
    counts = np.bincount(expert_of_token, minlength=num_experts)
    padded = ((counts + bm - 1) // bm) * bm
    padded = np.maximum(padded, bm)  # every expert gets >= one tile
    offsets = np.zeros(num_experts + 1, dtype=np.int64)
    np.cumsum(padded, out=offsets[1:])
    order = np.full(int(offsets[-1]), -1, dtype=np.int64)
    fill = offsets[:-1].copy()
    for tok, e in enumerate(expert_of_token):
        order[fill[e]] = tok
        fill[e] += 1
    group_of_tile = np.repeat(np.arange(num_experts, dtype=np.int32), padded // bm)
    return order, group_of_tile, padded
