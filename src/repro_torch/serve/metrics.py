"""Serving metrics: counters + latency aggregation for the sparse engine.

A copy of the JAX package's ``repro/serve/metrics.py`` (pure Python; the
port keeps its own). One :class:`ServeMetrics` instance rides inside a
:class:`~repro_torch.serve.sparse.SparseServeEngine`; the engine bumps
the counters as tickets move through their lifecycle and appends one
latency sample per finished request. ``snapshot()`` renders the whole
thing as a plain dict — the shape the JAX package's serving benchmark
stores and what operators would scrape.

Latency bookkeeping is split the way serving dashboards split it:

* ``wait``   — submit → first iteration (queueing + admission delay),
* ``run``    — first iteration → completion,
* ``total``  — submit → completion (what the client feels).

Since the engine admits per *tenant* (deficit round-robin + quotas,
DESIGN.md §16), every lifecycle event is also attributed to the
ticket's tenant in a :class:`TenantMetrics` block, including
**goodput** — completions that beat their deadline — the number an SLA
dashboard actually plots. Tenant blocks are created lazily on first
touch, so an engine serving one anonymous tenant pays one dict entry.

Quantiles use the nearest-rank method on the raw sample list — exact,
no bucketing error, fine at the sample counts a benchmark or test
produces (the engine stores one float per request, not a histogram).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

__all__ = ["ServeMetrics", "TenantMetrics", "percentile"]


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) of ``samples``;
    ``0.0`` for an empty list so snapshots of an idle engine are
    well-formed."""
    if not samples:
        return 0.0
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    ordered = sorted(samples)
    rank = max(1, int(-(-q * len(ordered) // 100)))  # ceil without math import
    return float(ordered[min(rank, len(ordered)) - 1])


@dataclasses.dataclass
class TenantMetrics:
    """One tenant's slice of the lifecycle counters + latency samples.

    ``goodput`` counts completions that finished at or before their
    deadline (deadline-less completions count — they met their vacuous
    SLA); ``completed - goodput`` is the tail that finished but blew
    its deadline on the very tick it converged."""

    submitted: int = 0
    rejected: int = 0  # shed at submit: queue full or tenant over quota
    expired: int = 0
    failed: int = 0
    completed: int = 0
    goodput: int = 0  # completed with t_finish <= deadline (or no deadline)

    wait_s: List[float] = dataclasses.field(default_factory=list)
    run_s: List[float] = dataclasses.field(default_factory=list)
    total_s: List[float] = dataclasses.field(default_factory=list)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "expired": self.expired,
            "failed": self.failed,
            "completed": self.completed,
            "goodput": self.goodput,
        }
        for name, samples in (
            ("wait", self.wait_s),
            ("run", self.run_s),
            ("total", self.total_s),
        ):
            out[f"{name}_p50_s"] = percentile(samples, 50.0)
            out[f"{name}_p99_s"] = percentile(samples, 99.0)
        return out


@dataclasses.dataclass
class ServeMetrics:
    """Mutable counter block; the engine owns exactly one."""

    # -- ticket lifecycle counts ------------------------------------------
    submitted: int = 0
    rejected: int = 0  # load-shed at submit (queue full / tenant quota)
    expired: int = 0  # deadline passed (queued or mid-run)
    failed: int = 0  # payload/config error surfaced per-ticket
    completed: int = 0
    goodput: int = 0  # completed before the deadline (Σ over tenants)

    # -- engine work ------------------------------------------------------
    ticks: int = 0  # step() calls where at least one lane stepped
    lane_steps: int = 0  # batched stepper iterations (one SpMM each)
    slot_iters: int = 0  # Σ active slots over all lane steps
    slot_ticks: int = 0  # Σ occupied slots over all ticks (occupancy num.)
    slot_capacity: int = 0  # Σ configured slots over all ticks (denom.)

    # -- latency samples (seconds, one per finished request) --------------
    wait_s: List[float] = dataclasses.field(default_factory=list)
    run_s: List[float] = dataclasses.field(default_factory=list)
    total_s: List[float] = dataclasses.field(default_factory=list)

    # -- per-tenant breakdown (lazily created) -----------------------------
    tenants: Dict[str, TenantMetrics] = dataclasses.field(default_factory=dict)

    def tenant(self, name: str) -> TenantMetrics:
        """The (lazily created) per-tenant block for ``name``."""
        got = self.tenants.get(name)
        if got is None:
            got = self.tenants[name] = TenantMetrics()
        return got

    def record_latency(
        self, wait: float, run: float, total: float, tenant: str | None = None
    ) -> None:
        self.wait_s.append(float(wait))
        self.run_s.append(float(run))
        self.total_s.append(float(total))
        if tenant is not None:
            tm = self.tenant(tenant)
            tm.wait_s.append(float(wait))
            tm.run_s.append(float(run))
            tm.total_s.append(float(total))

    @property
    def occupancy(self) -> float:
        """Mean fraction of stepper slots holding a live request, over
        every tick any lane stepped — the continuous-batching win is
        this staying high while requests churn."""
        if self.slot_capacity == 0:
            return 0.0
        return self.slot_ticks / self.slot_capacity

    def snapshot(self) -> Dict[str, object]:
        """Flatten to the dict shape ``BENCH_serve.json`` stores."""
        out: Dict[str, object] = {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "expired": self.expired,
            "failed": self.failed,
            "completed": self.completed,
            "goodput": self.goodput,
            "ticks": self.ticks,
            "lane_steps": self.lane_steps,
            "slot_iters": self.slot_iters,
            "occupancy": round(self.occupancy, 4),
        }
        for name, samples in (
            ("wait", self.wait_s),
            ("run", self.run_s),
            ("total", self.total_s),
        ):
            out[f"{name}_p50_s"] = percentile(samples, 50.0)
            out[f"{name}_p99_s"] = percentile(samples, 99.0)
        if self.tenants:
            out["tenants"] = {
                name: tm.snapshot() for name, tm in sorted(self.tenants.items())
            }
        return out
