from repro_torch.kernels.attn.ops import (
    VARIANTS,
    attention_variant,
    flash_attention,
    mha,
    visited_tiles,
)
from repro_torch.kernels.attn.ref import attention_mask, attention_plain, tile_visits

__all__ = ["VARIANTS", "attention_mask", "attention_plain", "attention_variant",
           "flash_attention", "mha", "tile_visits", "visited_tiles"]
