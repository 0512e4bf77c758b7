"""Config system: architectures, input shapes, mesh and run settings.

Every assigned architecture is a frozen :class:`ArchConfig` registered in
:mod:`repro_torch.configs`; ``--arch <id>`` resolves through
:func:`get_arch`. ``ArchConfig.reduced()`` derives the small-but-same-
family config the per-arch smoke tests instantiate on CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "TrainConfig",
    "SHAPES",
    "register_arch",
    "get_arch",
    "list_archs",
    "shape_applicable",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    # --- attention variants ---
    qk_norm: bool = False
    window: int = 0  # sliding-window size; 0 = full attention
    global_attn_every: int = 0  # hybrid: every k-th layer uses full attn
    # --- encoder-decoder ---
    encoder_layers: int = 0
    # --- multimodal frontend stub ---
    frontend: Optional[str] = None  # 'audio' | 'vision'
    frontend_len: int = 0  # precomputed embedding positions per sample
    # --- capabilities ---
    sub_quadratic: bool = False  # eligible for long_500k decode
    tie_embeddings: bool = True
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""
    # Unroll the layer scan (dry-run cost probes only: XLA cost_analysis
    # counts while-loop bodies once, so probes compile unrolled).
    scan_unroll: bool = False
    # --- beyond-paper performance knobs (EXPERIMENTS.md §Perf) ---
    chunked_attn: bool = False  # O(S·chunk) online-softmax attention
    attn_chunk: int = 1024
    vocab_pad_to: int = 0  # pad embedding rows to a multiple (TP-divisible)
    act_anchor: bool = False  # with_sharding_constraint on the residual stream
    moe_sort_dispatch: bool = False  # sort-based rank-in-expert (vs one-hot cumsum)
    moe_a2a: bool = False  # all_to_all (sequence-sharded) expert parallelism

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> int:
        """Approximate parameter count N (for the 6·N·D MFU model)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        h, kv, hd = self.num_heads, self.num_kv_heads, self.hd
        per_layer = 0
        if self.family != "ssm":
            per_layer += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d  # attn
        if self.is_moe:
            per_layer += d * self.num_experts  # router
            per_layer += self.num_experts * 3 * d * self.moe_d_ff
        elif self.family == "ssm":
            din, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * din + 2 * st + nh) + din * d  # in/out proj
        else:
            per_layer += 3 * d * f
        if self.family == "hybrid":
            din, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * din + 2 * st + nh) + din * d
        total = L * per_layer + v * d
        if not self.tie_embeddings:
            total += v * d
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * h * hd + 3 * d * f)
            total += enc + L * (2 * d * h * hd + d * kv * hd + h * hd * d)  # cross-attn
        return total

    def active_param_count(self) -> int:
        """N_active for MoE (6·N_active·D)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        h, kv, hd = self.num_heads, self.num_kv_heads, self.hd
        per_layer = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        per_layer += d * self.num_experts
        per_layer += self.experts_per_token * 3 * d * self.moe_d_ff
        return L * per_layer + self.vocab_size * d

    def reduced(self) -> "ArchConfig":
        """Same-family config small enough for a CPU smoke test."""
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.is_moe else 0,
            moe_capacity_factor=8.0,  # effectively dropless at smoke scale
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            window=min(self.window, 16) if self.window else 0,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_len=min(self.frontend_len, 8) if self.frontend else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return True, ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation
    remat: str = "none"  # none | full | dots
    zero1: bool = True  # shard optimizer state over data axis
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    moe_aux_weight: float = 0.01
    grad_compression: str = "none"  # none | int8 (inter-pod hop)


_REGISTRY: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers on import)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Dict[str, ArchConfig]:
    import repro_torch.configs  # noqa: F401

    return dict(_REGISTRY)
