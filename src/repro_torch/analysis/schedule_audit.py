"""Collective-schedule audit: pin the exchange schedule without processes.

The counterpart of the JAX package's ``repro/analysis/jaxpr_audit.py``.
:func:`repro_torch.pmvc.dist.make_pmvc_step` promises an ordering the
whole overlap design rests on — *every* wave's ``all_to_all_single`` is
issued before the first contraction, so wave k+1's transfer can hide
behind wave k's contraction. Nothing at run time checks this: a refactor
that interleaves a wave's collective after a contraction still computes
the right numbers, just without the overlap.

There is no jaxpr here. The step reaches every collective and every
contraction through its :class:`~repro_torch.pmvc.dist.Communicator`;
:func:`trace_pmvc_step` runs it once with a logging
:class:`~repro_torch.pmvc.dist.LocalCommunicator`, which emulates a
group of one rank — every unit stacked on it, each collective the
identity over that rank, each contraction the kernel (its plain version
on CPU tensors) — and logs ``a2a``, ``dot`` and ``psum`` in issue
order, with the dtypes of each contraction's operands. So one device
with no processes audits a 64-unit schedule, as the JAX audit does on
an ``AbstractMesh``; like every entry point it runs on the card unless
asked for the CPU. The same log, from a
:class:`~repro_torch.pmvc.dist.Communicator` given ``log=[]``, audits a
real run on the card. The golden pins:

======================  =======================================
mode                    schedule signature
======================  =======================================
replicated              ``dot psum``
selective               ``a2a dot psum``
overlap (K waves)       ``a2a``×K · ``dot``×(K+1) · ``psum``
======================  =======================================

Hygiene (:func:`audit_schedule`): every contraction's operands are
float32 — the contraction contract, in place of the JAX audit's check
that no aval was promoted to f64 — and, with ``expect_waves``, every
``a2a`` precedes the first ``dot`` and there are exactly K of them. The
JAX audit's other two checks read a jaxpr and have no counterpart: host
callbacks (the step is eager Python, with no traced graph a callback
could hide in) and weak-typed loop carries (nothing is traced, so
nothing retraces).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.analysis.passes import Finding
from repro_torch.pmvc.dist import Event, LocalCommunicator, make_pmvc_step, make_unit_mesh
from repro_torch.pmvc.plan_device import DevicePlan, OverlapPlan, SelectivePlan

__all__ = [
    "AuditReport",
    "audit_plan",
    "audit_schedule",
    "audit_session",
    "golden_signature",
    "schedule_signature",
    "trace_pmvc_step",
]


def schedule_signature(events: Sequence[Event]) -> str:
    """The collective/contraction sequence as a space-joined token
    string — ``"a2a a2a dot dot dot psum"`` for ``overlap:2``."""
    return " ".join(e.op for e in events)


def golden_signature(exchange: Optional[str], waves: int = 1) -> str:
    """The pinned schedule for a stepper mode. ``exchange`` is
    ``None``/``"replicated"``, ``"selective"``, or ``"overlap"``
    (``waves`` = K)."""
    kind = exchange or "replicated"
    kind = kind.split(":", 1)[0]
    if kind == "replicated":
        return "dot psum"
    if kind == "selective":
        return "a2a dot psum"
    if kind == "overlap":
        return " ".join(["a2a"] * waves + ["dot"] * (waves + 1) + ["psum"])
    raise ValueError(f"unknown exchange kind {exchange!r}")


def audit_schedule(
    events: Sequence[Event], *, expect_waves: Optional[int] = None
) -> List[Finding]:
    """Hygiene audit over one step's log.

    * every contraction's operands (tiles, x source) are float32;
    * with ``expect_waves``: the overlap ordering property — every
      ``a2a`` precedes the first ``dot``, and there are exactly K of
      them.
    """
    findings: List[Finding] = []
    a2a_before = 0
    saw_dot = False
    for event in events:
        if event.op == "dot":
            saw_dot = True
            wrong = [str(d) for d in event.dtypes if d != torch.float32]
            if wrong:
                findings.append(Finding(
                    "schedule/float32",
                    f"contraction operands of {', '.join(wrong)} — the contraction "
                    "contract is float32",
                ))
        elif event.op == "a2a" and not saw_dot:
            a2a_before += 1
        elif event.op == "a2a":
            findings.append(Finding(
                "schedule/collective-order",
                "all_to_all issued AFTER a contraction — the wave transfer can no "
                "longer hide behind earlier contractions",
            ))
    if expect_waves is not None and a2a_before != expect_waves:
        findings.append(Finding(
            "schedule/collective-order",
            f"{a2a_before} all_to_all(s) before the first contraction, expected all "
            f"{expect_waves} waves issued up front",
        ))
    return findings


def trace_pmvc_step(
    plan: DevicePlan,
    exchange_plan=None,
    *,
    batch: Optional[int] = None,
    device=None,
) -> List[Event]:
    """Run :func:`make_pmvc_step` for ``plan`` once over a
    :class:`~repro_torch.pmvc.dist.LocalCommunicator` that logs its
    calls, on ``device`` (the card when
    omitted; ``device="cpu"`` asks for the CPU), and return its log — no
    process group.

    ``exchange_plan`` follows the executor convention (``None`` ==
    replicated, :class:`SelectivePlan`, :class:`OverlapPlan`). x is a
    single vector of zeros, or a ``batch``-wide stack of them."""
    if exchange_plan is not None and not isinstance(exchange_plan, (SelectivePlan, OverlapPlan)):
        raise TypeError(f"unknown exchange plan type {type(exchange_plan)!r}")
    dev = resolve_device(device)
    comm = LocalCommunicator(log=[])
    step = make_pmvc_step(plan, make_unit_mesh(plan.num_units, comm=comm),
                          selective=exchange_plan, device=dev)
    tail: Tuple[int, ...] = () if batch is None else (batch,)
    step(torch.zeros((plan.num_col_blocks, plan.bn) + tail, dtype=torch.float32, device=dev))
    return list(comm.log)


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """One stepper audit: the recorded signature, the pinned golden it
    was compared against, and any hygiene findings."""

    exchange: str
    waves: int
    signature: str
    golden: str
    findings: Tuple[Finding, ...]

    @property
    def ok(self) -> bool:
        return not self.findings and self.signature == self.golden

    def __str__(self) -> str:
        status = "OK" if self.ok else "FAIL"
        lines = [
            f"schedule audit [{self.exchange}, K={self.waves}]: {status} — "
            f"schedule {self.signature!r}"
            + ("" if self.signature == self.golden else f" != golden {self.golden!r}")
        ]
        lines += [f"  - {f}" for f in self.findings]
        return "\n".join(lines)


def audit_plan(plan: DevicePlan, exchange_plan=None, *, device=None) -> AuditReport:
    """Record ``plan``'s step on ``device`` (the card when omitted),
    compare its schedule against the golden pin, and run the hygiene
    audit."""
    if isinstance(exchange_plan, OverlapPlan):
        exchange, waves = "overlap", exchange_plan.waves
    elif isinstance(exchange_plan, SelectivePlan):
        exchange, waves = "selective", 1
    else:
        exchange, waves = "replicated", 1
    events = trace_pmvc_step(plan, exchange_plan, device=device)
    findings = audit_schedule(events, expect_waves=waves if exchange == "overlap" else None)
    sig = schedule_signature(events)
    golden = golden_signature(exchange, waves)
    if sig != golden:
        findings.append(Finding(
            "schedule/schedule",
            f"collective schedule {sig!r} diverges from golden {golden!r}",
        ))
    return AuditReport(exchange=exchange, waves=waves, signature=sig, golden=golden,
                       findings=tuple(findings))


def audit_session(sess) -> AuditReport:
    """Audit a :class:`SparseSession`'s step (its device plan + exchange
    plan as the ``shard_map`` executor would run them), on the session's
    device."""
    return audit_plan(sess.device_plan, sess.selective, device=sess.device)
