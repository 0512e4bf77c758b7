"""Stand-ins for every model input (the dry-run's no-allocation batch),
plus the per-cell step builders shared by dryrun.py and train.py — one
source of truth for what gets run.

A stand-in is a tensor on ``torch.device("meta")``: the reference's
shape and type, no storage. Ops on meta tensors compute shapes only, so
a full-width step runs on them in the time its op dispatch takes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import SHAPES, ArchConfig, ShapeConfig, TrainConfig, get_arch
from repro_torch.models.api import Model, build
from repro_torch.models.common import Params
from repro_torch.models.moe import MeshCtx
from repro_torch.optim.adamw import init_opt
from repro_torch.train.step import make_train_step

__all__ = ["input_specs", "frontend_length", "abstract_params", "abstract_state",
           "StepBundle", "make_step_bundle"]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def frontend_length(cfg: ArchConfig, shape: ShapeConfig) -> int:
    if not cfg.frontend:
        return 0
    return cfg.frontend_len or max(shape.seq_len // 4, 8)


def input_specs(arch: str | ArchConfig, shape: str | ShapeConfig) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins for one (arch × shape) cell.

    train/prefill: full token sequences; decode: the single new token per
    slot (the KV/state cache is part of the step state, see
    ``abstract_state``). Frontend archs get precomputed embedding specs.
    """
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    b = sh.global_batch
    if sh.kind == "decode":
        batch = {"tokens": _sds((b, 1), torch.int32)}
    else:
        batch = {"tokens": _sds((b, sh.seq_len), torch.int32)}
    if cfg.frontend:
        fl = frontend_length(cfg, sh)
        batch["frontend_embeds"] = _sds((b, fl, cfg.d_model), torch.float32)
    return batch


def abstract_params(model: Model) -> Params:
    """The model's weights as meta stand-ins: nothing drawn or allocated."""
    return model.init(torch.Generator(), device="meta")


def abstract_state(model: Model, cfg: ArchConfig, shape: ShapeConfig) -> Any:
    """Decode-cache stand-in (meta tensors, no allocation)."""
    b = shape.global_batch
    batch = {"tokens": _sds((b, shape.seq_len), torch.int32)}
    if cfg.frontend:
        fl = frontend_length(cfg, shape)
        batch["frontend_embeds"] = _sds((b, fl, cfg.d_model), torch.float32)
    params = abstract_params(model)
    with torch.no_grad():
        return model.init_state(params, batch, max_len=shape.seq_len)


class StepBundle:
    """Everything needed to run one (arch × shape) cell."""

    def __init__(self, step_fn, args: Tuple, kind: str):
        self.step_fn = step_fn
        self.args = args
        self.kind = kind


def make_step_bundle(
    cfg: ArchConfig,
    shape: ShapeConfig,
    ctx: Optional[MeshCtx] = None,
    train_cfg: Optional[TrainConfig] = None,
) -> StepBundle:
    """Build the function + stand-in args that the dry-run runs.

    train_*   -> full train step (fwd + bwd + AdamW), remat "dots" unless
                 ``train_cfg`` says otherwise; no int8 noise generator
    prefill_* -> forward pass
    decode_*  -> one serve_step over the KV/state cache
    """
    model = build(cfg)
    train_cfg = train_cfg or TrainConfig(remat="dots")
    params = abstract_params(model)
    batch = input_specs(cfg, shape)

    if shape.kind == "train":
        step = make_train_step(model, train_cfg, ctx)
        return StepBundle(step, (params, init_opt(params), batch, None), "train")

    if shape.kind == "prefill":

        @torch.no_grad()
        def prefill(params, batch):
            logits, _ = model.forward(params, batch, ctx)
            return logits

        return StepBundle(prefill, (params, batch), "prefill")

    # decode
    state = abstract_state(model, cfg, shape)

    def serve_step(params, tokens, state):
        return model.decode_step(params, tokens, state, ctx)

    return StepBundle(serve_step, (params, batch["tokens"], state), "decode")
