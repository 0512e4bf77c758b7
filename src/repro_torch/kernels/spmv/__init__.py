from repro_torch.kernels.spmv.ops import (
    BLOCK_SIZES,
    VARIANTS,
    BellTiles,
    bell_spmm,
    bell_tiles,
    row_spans,
    spmm_variant,
)
from repro_torch.kernels.spmv.ref import bell_spmm_plain

__all__ = ["BLOCK_SIZES", "VARIANTS", "BellTiles", "bell_spmm", "bell_spmm_plain", "bell_tiles",
           "row_spans", "spmm_variant"]
