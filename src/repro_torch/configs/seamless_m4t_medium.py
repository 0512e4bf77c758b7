"""seamless-m4t-medium — enc-dec multimodal backbone (audio frontend stub).

[arXiv:2308.11596; hf]
12L (enc) + 12L (dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
``input_specs`` provides precomputed speech-frame embeddings.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=12,
        encoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        frontend="audio",
        sub_quadratic=False,
        source="arXiv:2308.11596",
    )
)
