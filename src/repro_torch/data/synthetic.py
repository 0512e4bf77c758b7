"""Deterministic synthetic data pipeline.

Produces structured (learnable) token streams so the example trainers
show a real loss curve: tokens follow a sticky first-order Markov chain
with a per-document offset, giving the model both local bigram structure
and long-range context to exploit. Fully deterministic per (seed, step,
shard), so elastic re-sharding replays identically — the property the
fault-tolerance tests rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config import ArchConfig, ShapeConfig

__all__ = ["DataConfig", "SyntheticStream", "make_batch", "frontend_stub"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    stickiness: float = 0.9  # P(next = f(prev)); rest uniform


class SyntheticStream:
    """Iterator of global batches, optionally restricted to a shard."""

    def __init__(
        self,
        cfg: DataConfig,
        *,
        shard_index: int = 0,
        num_shards: int = 1,
        start_step: int = 0,
    ):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.step = start_step
        # Fixed random permutation acts as the Markov successor function.
        rng = np.random.default_rng(cfg.seed)
        self.succ = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> np.ndarray:
        """This shard's batch for an arbitrary ``step``, independent of the
        iterator cursor — the random-access entry trainers build their
        ``batch_fn`` on (deterministic per (seed, step, shard))."""
        cfg = self.cfg
        b_loc = cfg.global_batch // self.num_shards
        # Independent stream per (step, global row) — elastic-safe: a
        # shard's rows are a pure function of global row id and step.
        rows = np.arange(
            self.shard_index * b_loc, (self.shard_index + 1) * b_loc
        )
        seeds = (cfg.seed * 1_000_003 + step) * 65_537 + rows
        noise = np.empty((b_loc, cfg.seq_len))
        rand_toks = np.empty((b_loc, cfg.seq_len), dtype=np.int64)
        for i, s in enumerate(seeds):  # one independent generator per row
            rng = np.random.default_rng(int(s))
            noise[i] = rng.random(cfg.seq_len)
            rand_toks[i] = rng.integers(cfg.vocab_size, size=cfg.seq_len)
        toks = np.empty((b_loc, cfg.seq_len), dtype=np.int64)
        toks[:, 0] = rand_toks[:, 0]
        sticky = noise < cfg.stickiness
        for t in range(1, cfg.seq_len):  # vectorized across rows
            toks[:, t] = np.where(
                sticky[:, t], self.succ[toks[:, t - 1]], rand_toks[:, t]
            )
        return toks.astype(np.int32)

    def _batch_at(self, step: int) -> np.ndarray:
        import warnings

        warnings.warn(
            "SyntheticStream._batch_at is deprecated; use the public "
            "batch_at method",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.batch_at(step)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch


def frontend_stub(
    arch: ArchConfig, batch: int, length: Optional[int] = None, seed: int = 0
) -> np.ndarray:
    """Precomputed frontend embeddings (vision patches / audio frames)."""
    n = length or arch.frontend_len or 8
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n, arch.d_model)).astype(np.float32)


def make_batch(
    arch: ArchConfig,
    shape: ShapeConfig,
    *,
    seed: int = 0,
    step: int = 0,
    batch_override: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """One host-side batch matching an (arch, shape) cell."""
    b = batch_override or shape.global_batch
    dc = DataConfig(arch.vocab_size, shape.seq_len, b, seed=seed)
    stream = SyntheticStream(dc, start_step=step)
    out: Dict[str, np.ndarray] = {"tokens": next(stream)}
    if arch.frontend:
        flen = arch.frontend_len or max(shape.seq_len // 4, 8)
        out["frontend_embeds"] = frontend_stub(arch, b, flen, seed=seed)
    return out
