"""``python -m repro_torch.analysis`` — lint plan archives from the shell.

Accepts any mix of archive files and plan-store directories; exits 1
when any archive has findings, 0 when everything is clean. ``--level
strict``/``full`` additionally loads each clean archive and runs the
in-memory proof passes (conservation / repack equivalence).
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.passes import LEVELS
from repro_torch.analysis.plan_lint import lint_archive, lint_store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify plan archives / plan-store directories",
    )
    ap.add_argument(
        "paths",
        nargs="+",
        help="plan archives (.npz) or plan-store directories",
    )
    ap.add_argument(
        "--level",
        choices=LEVELS,
        default="structure",
        help="verification tier (default: structure; strict adds the "
        "matrix conservation proof, full adds repack equivalence)",
    )
    ap.add_argument(
        "-q",
        "--quiet",
        action="store_true",
        help="print only archives with findings",
    )
    args = ap.parse_args(argv)

    total = bad = 0
    for target in args.paths:
        if os.path.isdir(target):
            pairs = lint_store(target, level=args.level)
        elif os.path.exists(target):
            pairs = [(target, lint_archive(target, level=args.level))]
        else:
            print(f"{target}: no such file or directory", file=sys.stderr)
            return 2
        for path, report in pairs:
            total += 1
            if report.ok:
                if not args.quiet:
                    print(f"{path}: OK ({len(report.passes_run)} passes, "
                          f"level {report.level})")
                continue
            bad += 1
            print(f"{path}: {len(report.findings)} finding(s)")
            for f in report.findings:
                print(f"  - {f}")
    if total == 0:
        print("no plan archives found", file=sys.stderr)
        return 2
    if not args.quiet:
        print(f"{total} archive(s) checked, {bad} with findings")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
