"""Unified model API: every architecture exposes the same four functions.

``build(cfg)`` returns a :class:`Model` with:
  * ``init(generator, device=None) -> params``  (a :class:`Params` module)
  * ``forward(params, batch, ctx, remat) -> (logits, aux)``   (train / prefill)
  * ``init_state(params, batch, max_len) -> state``  (decode cache)
  * ``decode_step(params, tokens, state, ctx) -> (logits, state)``

``init`` places the weights on the card unless the caller gives
``device="cpu"``; with no device given and no card present it raises
``RuntimeError``. The state lives on the weights' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import ArchConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models.moe import MeshCtx

__all__ = ["Model", "build"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    init_state: Callable[..., Any]
    decode_step: Callable[..., Any]


def build(cfg: ArchConfig) -> Model:
    """Every family: the encoder-decoder one, whose ``init_state`` reads
    the batch's ``frontend_embeds`` (frames, which a tokens-only batch
    lacks: ``KeyError``, as in the reference), and the decoder-only ones
    (dense, vlm, moe, ssm, hybrid)."""
    if cfg.family == "encdec":

        def init(generator: torch.Generator, device=None):
            return encdec_mod.init_encdec(generator, cfg, resolve_device(device))

        def forward(params, batch, ctx: Optional[MeshCtx] = None, remat="none"):
            return encdec_mod.encdec_forward(params, batch, cfg, ctx, remat=remat)

        def init_state(params, batch, max_len):
            return encdec_mod.init_encdec_state(params, batch["frontend_embeds"], cfg, max_len)

        def decode_step(params, tokens, state, ctx: Optional[MeshCtx] = None):
            return encdec_mod.encdec_decode_step(params, tokens, state, cfg, ctx)

        return Model(cfg, init, forward, init_state, decode_step)

    def init(generator: torch.Generator, device=None):
        return lm_mod.init_lm(generator, cfg, resolve_device(device))

    def forward(params, batch, ctx: Optional[MeshCtx] = None, remat="none"):
        return lm_mod.lm_forward(params, batch, cfg, ctx, remat=remat)

    def init_state(params, batch, max_len):
        return lm_mod.init_decode_state(
            cfg, batch["tokens"].shape[0], max_len, params["embed"].device
        )

    def decode_step(params, tokens, state, ctx: Optional[MeshCtx] = None):
        return lm_mod.lm_decode_step(params, tokens, state, cfg, ctx)

    return Model(cfg, init, forward, init_state, decode_step)
