"""llava-next-34b — VLM backbone (anyres vision frontend stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
``input_specs`` provides precomputed anyres patch embeddings (2880
positions ≈ 5 tiles × 576 patches).
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        frontend="vision",
        frontend_len=2880,
        sub_quadratic=False,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
)
