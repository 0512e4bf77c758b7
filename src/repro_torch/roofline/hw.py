"""Hardware constants of the target card: one NVIDIA H100 80GB HBM3 (SXM).

The figures are the data sheet's for the SXM part at its full power
limit of 700 W, dense rates without sparsity. A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) runs slower under load, so a
roofline share against these peaks is stated with the card's limit
beside it. The JAX package's ``repro.roofline.hw`` holds TPU v5e's; the
keys of :data:`CHIP` are its keys, with ``link_bw`` for its ``ici_bw``.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "HBM_BW", "LINK_BW", "ICI_BW", "CHIP"]

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s of HBM3
LINK_BW = 450e9  # bytes/s of NVLink 4, per direction (18 links of 25 GB/s)
ICI_BW = LINK_BW  # the reference's name for the chip-to-chip rate

CHIP = {
    "peak_flops_bf16": PEAK_FLOPS_BF16,
    "peak_flops_f32": PEAK_FLOPS_F32,
    "hbm_bw": HBM_BW,
    "link_bw": LINK_BW,
    "smem_bytes": 228 * 2**10,  # shared memory per SM
    "hbm_bytes": 80 * 2**30,
}
