"""Static verification layer (DESIGN.md §15), the port of the JAX
package's ``repro/analysis`` plan linter.

:mod:`repro_torch.analysis.plan_lint` holds composable invariant passes
over in-memory plans (``SparseSession.verify``, ``distribute(validate=)``)
and over on-disk plan archives (``python -m repro_torch.analysis
<archive|store-dir>``). None of them runs an spmv. The passes read the
numpy plan arrays, so they give the same findings as the JAX package's
on the same plans and archives.

:mod:`repro_torch.analysis.schedule_audit` is the counterpart of the JAX
package's jaxpr audit: it records the collectives and contractions of
the ``shard_map`` executor's step (:func:`repro_torch.pmvc.dist.make_pmvc_step`)
on one emulated rank and pins them against the golden schedules (all
all_to_alls before the first contraction on the overlap path, float32
contraction operands).
"""
from repro_torch.analysis.passes import (
    LEVELS,
    Finding,
    LintReport,
    PlanLintError,
    PlanView,
    archive_pass,
    archive_pass_names,
    plan_pass,
    plan_pass_names,
)
from repro_torch.analysis.schedule_audit import (
    AuditReport,
    audit_plan,
    audit_schedule,
    audit_session,
    golden_signature,
    schedule_signature,
    trace_pmvc_step,
)
from repro_torch.analysis.plan_lint import (
    lint_archive,
    lint_plan,
    lint_session,
    lint_store,
)

__all__ = [
    "AuditReport",
    "audit_schedule",
    "audit_plan",
    "audit_session",
    "golden_signature",
    "schedule_signature",
    "trace_pmvc_step",
    "LEVELS",
    "Finding",
    "LintReport",
    "PlanLintError",
    "PlanView",
    "plan_pass",
    "archive_pass",
    "plan_pass_names",
    "archive_pass_names",
    "lint_plan",
    "lint_session",
    "lint_archive",
    "lint_store",
]
