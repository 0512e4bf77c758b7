"""hymba-1.5b — NVIDIA Hymba: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
SWA on most layers, full attention every 16th; SSD heads in parallel.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        window=1024,
        global_attn_every=16,
        sub_quadratic=True,
        source="arXiv:2411.13676",
    )
)
