"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
SWA makes decode memory O(window) — eligible for long_500k.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        window=4096,
        sub_quadratic=True,
        source="arXiv:2401.16818",
    )
)
