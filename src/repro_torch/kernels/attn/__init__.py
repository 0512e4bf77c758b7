from repro_torch.kernels.attn.ops import flash_attention, mha, visited_tiles
from repro_torch.kernels.attn.ref import attention_mask, attention_plain

__all__ = ["attention_mask", "attention_plain", "flash_attention", "mha", "visited_tiles"]
