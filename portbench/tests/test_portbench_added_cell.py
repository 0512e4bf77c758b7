"""A guard on the promise that a cell comes by new files alone: a copy of
the checkout with one more cell, added by new files and list entries
only, passes every test of the benchmark. The cell is shaped as the
next one will be: PageRank (the package's reference) on a power-law
graph with dangling columns, one caller, B = 1, with a per-layer reader
of its own."""
import json
import os
import subprocess
import sys

import numpy as np

from portbench.harness import ROOT, read_json
from portbench.matrices import make_graphs
from portbench.tests.pb_tiny import add_cell, copy_checkout, tiny

PROBE = "kron-pagerank-b1_test"
# Every metric that the PageRank cell will report, bar its own.
METRICS = ("solve_rhs_iters_per_s", "plan_s", "plan_partition_s", "plan_pack_s", "spmv_mfu_pct",
           "spmv_outside_kernel_pct", "bell_spmm_roofline_pct", "device_idle_pct.solve")
READER = "solve_host_ms_test"
GUARD = "portbench/tests/test_portbench_added_cell.py::test_the_tests_pass_with_one_more_cell"

# A generator the harness has never seen: a directed power-law graph
# (pb_tiny.rmat), every vertex with no out-edge a dangling column.
KRON = '''
from portbench.tests.pb_tiny import rmat

TINY = {"scale": 8}


def graphs(config, seed):
    return {"g": rmat(config["scale"], seed)}
'''

# The mean host time of a solve in the window, from the benchmark's spans.
SOLVE_MS = '''
def read(run):
    if run.spans is None:
        return None
    solves = run.spans.of("solve", *run.window_ns)
    return sum(b - a for a, b in solves) / len(solves) / 1e6 if solves else None
'''


def add_probe(root, spec: dict) -> None:
    """The PageRank cell added to the checkout ``root``, whose spec is
    ``spec``, by new files and list entries alone."""
    plan = read_json(os.path.join(root, "portbench", "configs", "hpcg-27pt-64.json"))["plan"]
    spec["per_layer"].append({"name": READER, "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "solvers (device loops)",
                              "moves": "solve_rhs_iters_per_s", "workloads": []})
    add_cell(root, spec, PROBE,
             {"name": "kron-17_test", "generator": "kron_test", "scale": 17,
              "plan": plan, "reduced": ["scale"]},
             "pagerank-b1-i10_test", {"sample": 2, "limits": {"x_err": 2e-5, "unanswered": 0}},
             METRICS + (READER,),
             files={"matrices/kron_test.py": KRON, f"metrics/{READER}.py": SOLVE_MS,
                    "traffic/pagerank-b1-i10_test.json": json.dumps(
                        {"loop": "solve", "solver": "pagerank", "graph": "g", "arg": "seeds",
                         "payload": "uniform", "batch": 1, "iters": 10, "pool": 1})})


def test_the_tests_pass_with_one_more_cell(tmp_path):
    spec = copy_checkout(tmp_path)
    add_probe(tmp_path, spec)
    assert len(json.loads((tmp_path / "BENCHMARK.json").read_text())["workloads"]) == len(
        read_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]) + 1
    cell = tiny(PROBE, spec, str(tmp_path))
    m = make_graphs(cell.config, 3, str(tmp_path))["g"]
    assert (np.bincount(m.col, minlength=m.n) == 0).sum() >= m.n // 8  # dangling columns
    assert {x["name"] for x in cell.per_layer} >= set(METRICS[1:]) | {READER}
    # A session of its own: nothing of the calling session's workers.
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{tmp_path / 'src'}"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-p", "no:randomly",
         os.path.join("portbench", "tests"), "--deselect", GUARD],
        cwd=tmp_path, capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert " passed" in out.stdout.splitlines()[-1]
    # The probe itself ran in the spec's tests: correct, traced, and under
    # each fault that a batch of one can have.
    probe = [line for line in out.stdout.splitlines() if PROBE in line and "PASSED" in line]
    assert len(probe) == 5, "\n".join(probe)
