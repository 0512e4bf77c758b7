from repro_torch.kernels.spmv.ops import (
    BLOCK_SIZES,
    VARIANTS,
    BellTiles,
    bell_spmm,
    bell_tiles,
    pack_inputs,
    row_spans,
    simt_limit,
    spmm_shard,
    spmm_shard_ref,
    spmm_variant,
    spmv_shard,
    spmv_shard_ref,
)
from repro_torch.kernels.spmv.ref import bell_spmm_plain

__all__ = ["BLOCK_SIZES", "VARIANTS", "BellTiles", "bell_spmm", "bell_spmm_plain", "bell_tiles",
           "pack_inputs", "row_spans", "simt_limit", "spmm_shard", "spmm_shard_ref",
           "spmm_variant", "spmv_shard", "spmv_shard_ref"]
