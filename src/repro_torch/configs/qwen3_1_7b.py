"""qwen3-1.7b — Qwen3 dense with qk_norm and GQA.

[hf:Qwen/Qwen3-8B; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, qk_norm.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        sub_quadratic=False,
        source="hf:Qwen/Qwen3-8B",
    )
)
