"""Pass framework for the static verification layer (DESIGN.md §15).

A *pass* is a pure function from a :class:`PlanView` (in-memory plan
artifacts) or an archive path to a list of :class:`Finding`s. Passes
are registered with a *level* — ``"structure"`` (internal consistency
of the plan arrays, no matrix needed), ``"strict"`` (adds the O(nnz)
matrix ↔ tiles conservation proof), ``"full"`` (adds the repack
equivalence proof against the recorded partition) — and a run at level
L executes every pass at level ≤ L.

The framework is deliberately boring: a registry of ``(name, level,
fn)`` triples and a :class:`LintReport` that aggregates findings. All
the actual invariants live in :mod:`repro_torch.analysis.plan_lint`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = [
    "LEVELS",
    "Finding",
    "LintReport",
    "PlanLintError",
    "PlanView",
    "plan_pass",
    "archive_pass",
    "run_plan_passes",
    "run_archive_passes",
    "plan_pass_names",
    "archive_pass_names",
]

# Verification tiers, cheapest first. A run at a level includes every
# pass registered at that level or below.
LEVELS = ("structure", "strict", "full")


def _level_rank(level: str) -> int:
    if level not in LEVELS:
        raise ValueError(f"unknown lint level {level!r}, know {LEVELS}")
    return LEVELS.index(level)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``where`` localizes the fault: a unit index, an archive member name
    with byte offset, a tile key — whatever the pass can pin down.
    """

    pass_name: str
    message: str
    where: Optional[str] = None

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.pass_name}{loc}: {self.message}"


class PlanLintError(ValueError):
    """Raised by :meth:`LintReport.raise_for_findings` — carries the
    report on ``.report``."""

    def __init__(self, report: "LintReport"):
        self.report = report
        super().__init__(str(report))


@dataclasses.dataclass(frozen=True)
class LintReport:
    """The outcome of one lint run: which passes ran, what they found."""

    level: str
    passes_run: Tuple[str, ...]
    findings: Tuple[Finding, ...]
    skipped: Tuple[str, ...] = ()  # passes lacking their required inputs

    @property
    def ok(self) -> bool:
        return not self.findings

    def raise_for_findings(self) -> "LintReport":
        if self.findings:
            raise PlanLintError(self)
        return self

    def __str__(self) -> str:
        head = (
            f"plan lint [{self.level}]: {len(self.passes_run)} passes, "
            f"{len(self.findings)} finding(s)"
        )
        if self.ok:
            return head + " — OK"
        lines = [head] + [f"  - {f}" for f in self.findings]
        return "\n".join(lines)


@dataclasses.dataclass
class PlanView:
    """Everything the in-memory passes may read.

    Only ``device_plan`` is mandatory. ``exchange`` is the session's
    exchange plan (``None`` == replicated). ``matrix`` enables the
    strict conservation pass; ``elem_unit`` + ``exchange_name`` enable
    the full repack-equivalence pass. ``tile_transform`` is a value
    view's elementwise map (:meth:`SparseSession.with_value_map`) —
    applied to stored payloads before comparing against the (already
    transformed) matrix.
    """

    device_plan: object
    exchange: object = None
    matrix: object = None
    elem_unit: object = None
    exchange_name: Optional[str] = None
    tile_transform: Optional[Callable] = None


# Registries: ordered lists of (name, level, fn). Order is registration
# order — plan_lint registers cheap structural passes first so reports
# lead with the most localized finding.
_PLAN_PASSES: List[Tuple[str, str, Callable]] = []
_ARCHIVE_PASSES: List[Tuple[str, str, Callable]] = []


def plan_pass(name: str, level: str = "structure"):
    """Register an in-memory pass: ``fn(view: PlanView) -> list[Finding]``.

    A pass may return ``NotImplemented`` to signal its required inputs
    are absent from the view (recorded as skipped, not failed)."""
    _level_rank(level)

    def deco(fn):
        _PLAN_PASSES.append((name, level, fn))
        return fn

    return deco


def archive_pass(name: str, level: str = "structure"):
    """Register an on-disk pass: ``fn(path: str) -> list[Finding]``."""
    _level_rank(level)

    def deco(fn):
        _ARCHIVE_PASSES.append((name, level, fn))
        return fn

    return deco


def _run(registry, subject, level: str) -> LintReport:
    rank = _level_rank(level)
    ran: List[str] = []
    skipped: List[str] = []
    findings: List[Finding] = []
    for name, plevel, fn in registry:
        if _level_rank(plevel) > rank:
            continue
        # A pass over corrupted input must *report*, never raise: shape
        # damage that breaks one pass's indexing becomes a finding and
        # the remaining passes still run.
        try:
            out = fn(subject)
        except Exception as e:
            ran.append(name)
            findings.append(
                Finding(name, f"pass crashed on malformed input: {type(e).__name__}: {e}")
            )
            continue
        if out is NotImplemented:
            skipped.append(name)
            continue
        ran.append(name)
        findings.extend(out)
    return LintReport(
        level=level,
        passes_run=tuple(ran),
        findings=tuple(findings),
        skipped=tuple(skipped),
    )


def run_plan_passes(view: PlanView, level: str = "structure") -> LintReport:
    return _run(_PLAN_PASSES, view, level)


def run_archive_passes(path: str, level: str = "structure") -> LintReport:
    return _run(_ARCHIVE_PASSES, path, level)


def plan_pass_names(level: str = "full") -> Sequence[str]:
    rank = _level_rank(level)
    return [n for n, lv, _ in _PLAN_PASSES if _level_rank(lv) <= rank]


def archive_pass_names(level: str = "full") -> Sequence[str]:
    rank = _level_rank(level)
    return [n for n, lv, _ in _ARCHIVE_PASSES if _level_rank(lv) <= rank]
