"""mamba2-2.7b — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
64L d_model=2560 vocab=50280 ssm_state=128; d_inner=5120, head_dim 64
(80 SSD heads). Constant-size decode state — eligible for long_500k.

The paper's technique is inapplicable to the SSD scan (no sparse
operand) — DESIGN.md §Arch-applicability.
"""
from repro_torch.config import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        sub_quadratic=True,
        source="arXiv:2405.21060",
    )
)
