"""moonshot-v1-16b-a3b — Moonlight-style MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert) vocab=163840.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        moe_d_ff=1408,
        vocab_size=163840,
        num_experts=64,
        experts_per_token=6,
        sub_quadratic=False,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
)
