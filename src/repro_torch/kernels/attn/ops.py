"""Flash attention's public entry points.

:func:`flash_attention` computes causal and/or one-sided sliding-window
attention over ``[BH, S, D]`` — the JAX package's
``repro/kernels/attn/kernel.py::flash_attention``. On CUDA tensors it
launches one of the hand-written kernels of ``csrc/flash_attention.cu``
(built at first use), the variant that :func:`attention_variant` names
from type and shape alone, before the launch:

* ``wgmma`` — bf16 with D a multiple of 16, ``bq`` a multiple of 64 and
  ``bkv`` of 16, Hopper's design: TMA loads from a producer warp,
  ``wgmma`` products in consumer warpgroups;
* ``mma`` — the other bf16 shapes with D, ``bq`` and ``bkv`` multiples of
  16, on the tensor cores (``mma.sync.m16n8k16``);
* ``regblock`` — float32 with D a multiple of 16 and ``bq``, ``bkv``
  multiples of 64, register-blocked on the CUDA cores;
* ``simt`` — any other float32 or bf16 shape, on the CUDA cores.

On CPU tensors it runs the plain version
:func:`repro_torch.kernels.attn.ref.attention_plain`. There is no other
path: a tensor elsewhere raises, and so does a CUDA tensor that is not
contiguous or does not start on a 16-byte boundary (the kernels copy
16-byte pieces; TMA reads only from such bases). :func:`mha` is the reference's
``repro/kernels/attn/ops.py::mha`` without ``interpret`` and
``use_kernel``: the tensors' device chooses.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.attn.ref import attention_plain, tile_visits
from repro_torch.kernels.build import load

__all__ = ["VARIANTS", "attention_variant", "flash_attention", "mha", "visited_tiles"]

_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
VARIANTS = ("wgmma", "mma", "regblock", "simt")
MAX_HEAD_DIM = 128  # the CUDA kernels' limit (csrc/flash_attention.cu)


def attention_variant(dtype: torch.dtype, d: int, bq: int, bkv: int) -> str:
    """The CUDA kernel that takes inputs of ``dtype`` with head dim ``d``
    and tiles ``bq``, ``bkv``: for bf16 with ``d`` and ``bkv`` multiples
    of 16, ``wgmma`` when ``bq`` is a multiple of 64 and ``mma`` when it
    is one of 16; ``regblock`` for float32 when ``d`` is a multiple of 16
    and ``bq``, ``bkv`` multiples of 64 (``d`` up to 128 for all three);
    ``simt`` otherwise. Pure: type and shape alone decide."""
    if d % 16 or d > MAX_HEAD_DIM:
        return "simt"
    if dtype == torch.bfloat16 and bq % 16 == 0 and bkv % 16 == 0:
        return "wgmma" if bq % 64 == 0 else "mma"
    if dtype == torch.float32 and bq % 64 == 0 and bkv % 64 == 0:
        return "regblock"
    return "simt"


def _library() -> ctypes.CDLL:
    lib = load("flash_attention")
    for name in ("flash_attention_simt_f32", "flash_attention_simt_bf16",
                 "flash_attention_mma_bf16", "flash_attention_wgmma_bf16",
                 "flash_attention_regblock_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def visited_tiles(s: int, t: int, *, causal: bool, window: int, bq: int, bkv: int) -> int:
    """How many (bq × bkv) tiles of one ``[S, T]`` score matrix the kernel
    visits (:func:`repro_torch.kernels.attn.ref.tile_visits`)."""
    return int(tile_visits(s, t, causal=causal, window=window, bq=bq, bkv=bkv).sum())


def flash_attention(
    q: torch.Tensor,  # [BH, S, D]
    k: torch.Tensor,  # [BH, T, D]
    v: torch.Tensor,  # [BH, T, D]
    *,
    causal: bool = True,
    window: int = 0,  # 0 = unbounded; > 0 = one-sided window q - k <= window
    bq: int = 128,
    bkv: int = 128,
) -> torch.Tensor:
    """``[BH, S, D]`` in q's type. ``S % bq == 0`` and ``T % bkv == 0``,
    as the reference asserts. CUDA tensors, contiguous and 16-byte
    aligned (else ``ValueError`` before any launch), launch the kernel that
    :func:`attention_variant` names on the current stream (head dims up to
    128) and add one to ``flash_attention.launches`` and to that
    variant's ``flash_attention.variant_launches``; CPU tensors run the
    plain version with the same tiles, so a row whose tile visits no key
    is 0 there too."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q must be [BH, S, D] and k, v one [BH, T, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    t = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k and v are {tuple(k.shape)}, q is {tuple(q.shape)}: BH and D differ")
    if bq <= 0 or bkv <= 0 or s % bq or t % bkv:
        raise ValueError(f"S={s} and T={t} must be multiples of bq={bq} and bkv={bkv}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v on {q.device}, {k.device} and {v.device}: one device for all")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _TYPES:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous on the card")
        if a.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary, "
                             f"its data is at {a.data_ptr():#x}")
    out = torch.empty_like(q)
    variant = attention_variant(q.dtype, d, bq, bkv)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"flash_attention_{variant}_{_TYPES[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, s, t, d, bq, bkv, int(bool(causal)), int(window), 1.0 / (d**0.5), stream,
        )
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed ({variant}): {msg} "
                           f"(cudaError {rc})")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    bq: int = 128,
    bkv: int = 128,
) -> torch.Tensor:
    """Multi-head attention over a flattened (batch·heads) leading dim: the
    caller repeats grouped kv heads to the query heads. The kernel on
    CUDA tensors, the plain version on CPU tensors."""
    return flash_attention(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv)
