"""Serving engine: prefill + decode with a batched request scheduler.

``ServeEngine`` drives the model's unified decode API; the scheduler
packs waiting requests into fixed-size decode batches, with per-slot
feeding so requests of unequal length share a batch (continuous
batching at slot granularity). The JAX package's engine, with eager
PyTorch calls in place of a jitted step: the decode state lives on the
weights' device, and its position cursor is a host integer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.api import Model
from repro_torch.models.moe import MeshCtx

__all__ = ["Request", "ServeEngine", "greedy_generate"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@torch.no_grad()
def greedy_generate(
    model: Model,
    params,
    prompts: np.ndarray,  # [B, S]
    max_new: int,
    *,
    ctx: Optional[MeshCtx] = None,
    frontend_embeds: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Batch greedy decoding on the weights' device: the prompt replayed
    through decode steps, then step decode. Returns [B, max_new]
    generated tokens. The state is its own: nothing is shared with an
    engine."""
    b, s = prompts.shape
    device = params["embed"].device
    batch: Dict[str, object] = {"tokens": torch.as_tensor(prompts, device=device)}
    if frontend_embeds is not None:
        batch["frontend_embeds"] = torch.as_tensor(frontend_embeds, device=device)

    state = model.init_state(params, batch, max_len=s + max_new)
    # Prefill by replaying the prompt through decode steps (correct for
    # every family incl. SSM state); batched serving amortizes this.
    logits = None
    for t in range(s):
        logits, state = model.decode_step(params, batch["tokens"][:, t : t + 1], state, ctx)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    out.append(tok[:, 0])
    for _ in range(max_new - 1):
        logits, state = model.decode_step(params, tok, state, ctx)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


class ServeEngine:
    """Wave-synchronized batching over the unified decode API.

    The decode cache keeps one shared position cursor (static shapes),
    so slots advance in lockstep: each tick feeds every slot exactly one
    token (prompt token, last generated token, or token 0 for finished
    slots). A new wave of requests is admitted when the whole batch
    drains — the scheduler packs the queue into waves of
    ``batch_slots``. Requests of unequal prompt length coexist inside a
    wave because feeding is per-slot.

    The engine runs on ``device``, the card unless the caller gives
    another (``RuntimeError`` with no device given and no card present);
    the weights must already be there.
    """

    def __init__(
        self,
        model: Model,
        params,
        *,
        batch_slots: int = 8,
        max_len: int = 256,
        ctx: Optional[MeshCtx] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        held = params["embed"].device
        if held.type != self.device.type or self.device.index not in (None, held.index):
            raise ValueError(f"the weights are on {held}, the engine on {self.device}")
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.ctx = ctx
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * batch_slots
        self._feed: List[List[int]] = [[] for _ in range(batch_slots)]
        self.completed: List[Request] = []
        self.state = None
        self.ticks = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _wave_done(self) -> bool:
        return all(r is None or r.done for r in self.active)

    def _admit_wave(self) -> bool:
        if not self.queue:
            return False
        dummy = {"tokens": np.zeros((self.slots, 1), np.int32)}
        self.state = self.model.init_state(self.params, dummy, self.max_len)
        self.active = [None] * self.slots
        for i in range(self.slots):
            if self.queue:
                req = self.queue.pop(0)
                self.active[i] = req
                self._feed[i] = list(req.prompt)
        return True

    @torch.no_grad()
    def step(self) -> None:
        """One engine tick: every slot advances one position."""
        if self._wave_done() and not self._admit_wave():
            return
        toks = np.zeros((self.slots, 1), np.int32)
        generating = [False] * self.slots
        for i, req in enumerate(self.active):
            if req is None or req.done:
                continue
            if self._feed[i]:
                toks[i, 0] = self._feed[i].pop(0)
                generating[i] = not self._feed[i]  # last prompt token
            else:
                toks[i, 0] = req.out[-1]
                generating[i] = True
        tokens = torch.as_tensor(toks, device=self.device)
        logits, self.state = self.model.decode_step(self.params, tokens, self.state, self.ctx)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None or req.done or not generating[i]:
                continue
            req.out.append(int(nxt[i]))
            if len(req.out) >= req.max_new:
                req.done = True
                self.completed.append(req)
        self.ticks += 1

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and self._wave_done():
                return
            self.step()
        raise RuntimeError("serve engine did not drain")
