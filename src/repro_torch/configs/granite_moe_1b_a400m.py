"""granite-moe-1b-a400m — IBM Granite 3.0 1B MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512 (expert) vocab=49155.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        moe_d_ff=512,
        vocab_size=49155,
        num_experts=32,
        experts_per_token=8,
        sub_quadratic=False,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
)
