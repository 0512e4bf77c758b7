"""granite-20b — IBM Granite 20B code model (llama-arch, MQA kv=1).

[arXiv:2405.04324; hf]
52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        sub_quadratic=False,
        source="arXiv:2405.04324",
    )
)
