"""Conjugate gradient's vector update after ``ap = A p``, fused.

:func:`cg_buffers` allocates one solve's buffers around its ``z, r, p``
and ``rs``, on the CPU or on a CUDA device, and :func:`cg_update` runs
iteration k in place: float32 vectors, float64 dot products and scalars,
a row whose ``pᵀAp`` breaks down (``|pᵀAp| < 1e-30``) left as it was,
and the residual ``√max_b rs`` written into slot k − 1 of the buffers'
history. Like the other kernel wrappers it chooses by the buffers'
device: on the card three launches of the hand-written kernels of
``csrc/cg_update.cu`` (built at first use), on the CPU
:func:`cg_update_plain`, the same update in PyTorch operations. The
kernels sum in a fixed order with no atomics, so a solve is bitwise the
same from run to run; against the plain version only the order of the
two sums differs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.build import load

__all__ = ["CG_THREADS", "CgBuffers", "cg_buffers", "cg_grid", "cg_update", "cg_update_plain"]

# Threads a block (csrc/cg_update.cu kThreads).
CG_THREADS = 256
# A block's chunk of a row holds at least this many elements a thread.
CG_MIN_PER_THREAD = 4
# Blocks an SM the grid aims at, over all rows.
CG_BLOCKS_PER_SM = 2


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u.double() * v.double()).sum(dim=-1)


def cg_grid(n: int, batch: int, sms: int) -> int:
    """Blocks a row of the fused update: about ``CG_BLOCKS_PER_SM`` blocks
    an SM over the ``batch`` rows, but no fewer than
    ``CG_MIN_PER_THREAD`` elements a thread; at least 1. Pure: the sums'
    order, and so the result's bits, follow from ``n``, ``batch`` and
    ``sms`` alone."""
    per_row = max(1, CG_BLOCKS_PER_SM * sms // max(1, batch))
    return max(1, min(per_row, -(-n // (CG_THREADS * CG_MIN_PER_THREAD))))


@dataclasses.dataclass
class CgBuffers:
    """One solve's state and buffers for :func:`cg_update`."""

    z: torch.Tensor  # [B, N] or [N] float32, updated in place
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor  # [2, B] float64: iteration k reads half (k - 1) % 2, writes k % 2
    ok: torch.Tensor  # [B] int32: the last iteration's |pᵀAp| >= 1e-30
    dots: torch.Tensor  # [B, grid] float64 (empty on the CPU): the blocks' partial sums of p·ap
    part: torch.Tensor  # [B, grid] float64 (empty on the CPU): ... and of r'·r'
    resid: torch.Tensor  # [iters] float64: iteration k's √max_b rs in slot k - 1
    grid: int

    @property
    def batch(self) -> int:
        return self.rs.shape[1]


def cg_buffers(z: torch.Tensor, r: torch.Tensor, p: torch.Tensor, rs: torch.Tensor,
               iters: int) -> CgBuffers:
    """The buffers of a solve of at most ``iters`` iterations from state
    ``z, r, p`` (float32, ``[B, N]`` or ``[N]``; made contiguous) and
    ``rs`` (float64 ``[B]`` or 0-d, copied), all on one CPU or CUDA
    device. On the CPU the grid is 1. Raises ``ValueError`` on mixed
    devices or shapes, ``TypeError`` on other types and ``RuntimeError``
    on another device."""
    if not (z.shape == r.shape == p.shape) or z.dim() not in (1, 2) or z.shape[-1] < 1:
        raise ValueError(f"z, r, p must share one [B, N] or [N] shape, got {tuple(z.shape)}, "
                         f"{tuple(r.shape)}, {tuple(p.shape)}")
    if any(t.dtype != torch.float32 for t in (z, r, p)) or rs.dtype != torch.float64:
        raise TypeError("z, r, p must be float32 and rs float64")
    if any(t.device != z.device for t in (r, p, rs)):
        raise ValueError(f"z, r, p and rs must be on one device, got {z.device}, {r.device}, "
                         f"{p.device} and {rs.device}")
    if z.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"the CG update runs on CUDA or CPU tensors, not {z.device}")
    batch = 1 if z.dim() == 1 else int(z.shape[0])
    if rs.numel() != batch:
        raise ValueError(f"rs holds {rs.numel()} values for {batch} rows")
    grid, cols = 1, 0  # the CPU takes no blocks and no partial sums
    if z.device.type == "cuda":
        sms = torch.cuda.get_device_properties(z.device).multi_processor_count
        grid = cols = cg_grid(int(z.shape[-1]), batch, sms)
    dev = z.device
    rs2 = torch.empty((2, batch), dtype=torch.float64, device=dev)
    rs2[0] = rs.reshape(batch)
    return CgBuffers(
        z=z.contiguous(), r=r.contiguous(), p=p.contiguous(), rs=rs2,
        ok=torch.empty(batch, dtype=torch.int32, device=dev),
        dots=torch.empty((batch, cols), dtype=torch.float64, device=dev),
        part=torch.empty((batch, cols), dtype=torch.float64, device=dev),
        resid=torch.empty(max(0, iters), dtype=torch.float64, device=dev), grid=grid)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("cg_update")
    fn = lib.cg_update_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cg_update_error_string.argtypes = [ctypes.c_int]
    lib.cg_update_error_string.restype = ctypes.c_char_p
    return lib


def cg_update_plain(buf: CgBuffers, ap: torch.Tensor, k: int) -> None:
    """:func:`cg_update` in PyTorch operations on the buffers' device, in
    place: what the three launches write. ``ok`` is ``|pᵀAp| >= 1e-30``
    per row; where it is false, the row's z, r, p and rs stay as they
    were."""
    z, r, p = buf.z, buf.r, buf.p
    rs = buf.rs[(k - 1) % 2]
    rs = rs[0] if z.dim() == 1 else rs
    denom = _dot(p, ap)
    ok = denom.abs() >= 1e-30
    alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
    z_new = (z + alpha[..., None] * p).float()
    r_new = (r - alpha[..., None] * ap).float()
    rs_new = _dot(r_new, r_new)
    p_new = (r_new + (rs_new / torch.clamp(rs, min=1e-30))[..., None] * p).float()
    sel = ok[..., None]
    z.copy_(torch.where(sel, z_new, z))
    r.copy_(torch.where(sel, r_new, r))
    p.copy_(torch.where(sel, p_new, p))
    buf.rs[k % 2] = torch.where(ok, rs_new, rs)
    buf.ok.copy_(ok.reshape(-1))
    buf.resid[k - 1] = buf.rs[k % 2].sqrt().max()


def cg_update(buf: CgBuffers, ap: torch.Tensor, k: int) -> None:
    """Iteration ``k`` (from 1) of the solve whose buffers are ``buf``,
    given ``ap = A p`` (float32, the shape of ``p``, any strides): updates
    ``buf.z``, ``buf.r``, ``buf.p`` and ``buf.rs`` and writes ``buf.ok``
    and ``buf.resid[k - 1]``. CUDA buffers take three kernel launches on
    the current stream and add one to ``cg_update.launches``; CPU buffers
    run :func:`cg_update_plain`."""
    if buf.p.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"cg_update runs on CUDA or CPU tensors, not {buf.p.device}")
    if ap.shape != buf.p.shape or ap.dtype != torch.float32 or ap.device != buf.p.device:
        raise ValueError(f"ap must be float32 {tuple(buf.p.shape)} on {buf.p.device}, got "
                         f"{ap.dtype} {tuple(ap.shape)} on {ap.device}")
    if not 1 <= k <= buf.resid.numel():
        raise ValueError(f"iteration {k} is outside the buffers' 1..{buf.resid.numel()}")
    if buf.p.device.type == "cpu":
        cg_update_plain(buf, ap, k)
        return
    n, batch = int(buf.p.shape[-1]), buf.batch
    ap_row, ap_col = (0, ap.stride(0)) if ap.dim() == 1 else (ap.stride(0), ap.stride(1))
    rs = buf.rs.data_ptr()  # halves of `batch` float64 each
    rs_in, rs_out = rs + 8 * batch * ((k - 1) % 2), rs + 8 * batch * (k % 2)
    lib = _library()
    with torch.cuda.device(buf.p.device):
        stream = torch.cuda.current_stream(buf.p.device).cuda_stream
        rc = lib.cg_update_f32(
            buf.z.data_ptr(), buf.r.data_ptr(), buf.p.data_ptr(), ap.data_ptr(), ap_row, ap_col,
            rs_in, rs_out, buf.ok.data_ptr(), buf.dots.data_ptr(), buf.part.data_ptr(),
            buf.resid.data_ptr() + 8 * (k - 1), n, batch, buf.grid, stream)
    if rc != 0:
        msg = lib.cg_update_error_string(rc).decode()
        raise RuntimeError(f"cg_update launch failed: {msg} (cudaError {rc})")
    cg_update.launches += 1


cg_update.launches = 0
