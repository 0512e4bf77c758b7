"""Static verification layer (DESIGN.md §15), the port of the JAX
package's ``repro/analysis`` plan linter.

:mod:`repro_torch.analysis.plan_lint` holds composable invariant passes
over in-memory plans (``SparseSession.verify``, ``distribute(validate=)``)
and over on-disk plan archives (``python -m repro_torch.analysis
<archive|store-dir>``). None of them runs an spmv. The passes read the
numpy plan arrays, so they give the same findings as the JAX package's
on the same plans and archives. The collective-schedule audit
(``repro/analysis/jaxpr_audit.py``) waits for the multi-device executor
(ROADMAP.md, Queue 1, item 6).
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
from repro_torch.analysis.plan_lint import (
    lint_archive,
    lint_plan,
    lint_session,
    lint_store,
)

__all__ = [
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
