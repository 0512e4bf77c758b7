"""Each cell of BENCHMARK.json driven end to end on the CPU at a tiny
size: the same files, loops, readers and comparison as on the card."""
import json
import math

import pytest

from portbench.tests.pb_tiny import WORKLOADS, run, tiny


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_and_is_correct(workload):
    out = run(workload)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = tiny(workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert out["checks"]["unanswered"]["value"] == 0
    json.dumps(out, allow_nan=False)


def test_solve_loop_counts_rhs_iterations():
    out = run("hpcg64-cg-b1", seconds=0.3)
    per_s = out["metrics"]["solve_rhs_iters_per_s"]["value"]
    assert per_s > 0
    # Whole solves only: one right-hand side × 50 iterations each.
    assert out["attempted"] >= 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reports_its_host_metrics(workload):
    """On the CPU a traced run has spans but no device trace: the
    host-clock metrics are read, the device metrics left out."""
    out = run(workload, trace=True)
    assert out["correct"] is True
    cell = tiny(workload)
    host = {m["name"] for m in cell.per_layer if m["source"] == "host_clock"}
    assert host and host <= set(out["metrics"])
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "busy_s" not in out["device"] and "breakdown" not in out
