from repro_torch.kernels.spmv.ops import BLOCK_SIZES, BellTiles, bell_spmm, bell_tiles
from repro_torch.kernels.spmv.ref import bell_spmm_plain

__all__ = ["BLOCK_SIZES", "BellTiles", "bell_spmm", "bell_spmm_plain", "bell_tiles"]
