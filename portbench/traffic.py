"""The general generator of traffic: payloads and samples from a
traffic file's parameters and the run's seed.

A traffic file names its ``loop`` (``portbench/loops/<loop>.py``), the
``solver``, the ``graph`` it runs on, the ``arg`` its payload is passed
as, the ``payload`` kind (one of :data:`PAYLOADS`), the ``batch`` of
right-hand sides, the ``iters`` and the ``pool`` of payload blocks the
loop cycles through. Every seed draws the same sizes and counts; only
the numbers change.
"""
from __future__ import annotations

import numpy as np

PAYLOADS = ("normal", "uniform")


def payloads(kind: dict, n: int, count: int, rows: int, seed: int, salt: int) -> np.ndarray:
    """``count`` payload blocks ``[rows, n]`` (float32) of one kind:
    ``normal``, standard normal floats drawn from the seed (right-hand
    sides); ``uniform``, every entry ``1/n`` whatever the seed, the
    classic teleport distribution of PageRank (``"arg": "seeds"``), so
    the ``solve`` loop drives ``pagerank`` as it drives ``cg``."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, salt])
    if kind["payload"] == "normal":
        return rng.standard_normal((count, rows, n), dtype=np.float32)
    if kind["payload"] == "uniform":
        return np.full((count, rows, n), 1.0 / n, np.float32)
    raise ValueError(f"unknown payload kind {kind['payload']!r}")


class Reservoir:
    """``k`` of a stream's items, each equally likely, drawn from the
    seed (Algorithm R): the same seed and stream keep the same items,
    and no more than ``k`` are held at once."""

    def __init__(self, k: int, seed: int, salt: int = 4):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, salt])

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
