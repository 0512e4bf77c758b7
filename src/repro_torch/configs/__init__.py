"""Architecture registry — importing this package registers all assigned
architectures (``--arch <id>`` resolves through repro_torch.config.get_arch)."""
from repro_torch.configs import (  # noqa: F401
    granite_20b,
    granite_8b,
    granite_moe_1b_a400m,
    h2o_danube_1_8b,
    hymba_1_5b,
    llava_next_34b,
    mamba2_2_7b,
    moonshot_v1_16b_a3b,
    qwen3_1_7b,
    seamless_m4t_medium,
)

ARCH_IDS = [
    "moonshot-v1-16b-a3b",
    "granite-moe-1b-a400m",
    "granite-20b",
    "granite-8b",
    "qwen3-1.7b",
    "h2o-danube-1.8b",
    "hymba-1.5b",
    "seamless-m4t-medium",
    "mamba2-2.7b",
    "llava-next-34b",
]
