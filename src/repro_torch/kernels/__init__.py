"""Hand-written CUDA kernels for the port's hot spots, built from
``csrc/`` at first use (:mod:`repro_torch.kernels.build`). Each replaces
one of the JAX package's Pallas TPU kernels and has a plain PyTorch
version beside it, which the wrapper runs for CPU tensors only.

* ``spmv`` — the stacked Block-ELL SpMM (the PMVC), replacing
  ``repro/kernels/spmv/kernel.py::bell_spmm`` (``csrc/bell_spmm.cu``).
* ``gmm`` — the grouped matmul of a dropless MoE layer, replacing
  ``repro/kernels/gmm/kernel.py::gmm`` (``csrc/gmm.cu``).
* ``attn`` — causal / sliding-window flash attention, replacing
  ``repro/kernels/attn/kernel.py::flash_attention``
  (``csrc/flash_attention.cu``).
"""
from repro_torch.kernels.attn.ops import flash_attention, mha
from repro_torch.kernels.attn.ref import attention_plain
from repro_torch.kernels.gmm.ops import gmm, grouped_matmul, plan_groups
from repro_torch.kernels.gmm.ref import gmm_plain
from repro_torch.kernels.spmv.ops import BLOCK_SIZES, BellTiles, bell_spmm, bell_tiles
from repro_torch.kernels.spmv.ref import bell_spmm_plain

__all__ = [
    "BLOCK_SIZES", "BellTiles", "attention_plain", "bell_spmm", "bell_spmm_plain",
    "bell_tiles", "flash_attention", "gmm", "gmm_plain", "grouped_matmul", "mha",
    "plan_groups",
]
