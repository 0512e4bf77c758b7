"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` package.

The same pipeline as the JAX package — two-level partitioning,
per-unit Block-ELL packing, the selective or overlapped x exchange and
the batched SpMM inside iterative solvers — on an NVIDIA GPU, with the
SpMM as a hand-written CUDA kernel (:mod:`repro_torch.kernels`), and
the multi-tenant serving engine over it (:mod:`repro_torch.serve`). The
public surface is :mod:`repro_torch.api`::

    from repro_torch.api import Topology, distribute

    sess = distribute(A, topology=Topology(nodes=4, cores=4),
                      combo="NL-HC", exchange="selective")
    y = sess.spmv(x)

**Device policy.** Entry points run on the card: the default device is
``torch.device("cuda")``. A caller who wants the CPU passes
``device="cpu"``; with no device given and no card present,
:func:`resolve_device` raises ``RuntimeError`` rather than falling back.
"""
from __future__ import annotations

import os

# The train step runs under torch.use_deterministic_algorithms(True), where
# PyTorch refuses cuBLAS unless this names a deterministic workspace
# (:4096:8 or :16:8). PyTorch reads it once, at the process's first cuBLAS
# call, so it is set here, before any product runs; a caller's value stays.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

# Float32 parity with the JAX package is held at 1e-5; TF32 keeps about
# three decimal digits and fails it, so no float32 product may use it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card. Raises ``RuntimeError`` when no device is given and no CUDA
    device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; repro_torch runs on the card unless "
            "the caller asks for the CPU with device='cpu'"
        )
    return DEFAULT_DEVICE
