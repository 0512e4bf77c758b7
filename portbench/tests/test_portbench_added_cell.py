"""A guard on the promise that a cell comes by new files alone: a copy of
the checkout with one more cell, added by new files and list entries
only (a renamed copy of ``hpcg64-cg-b1``), passes the tests that read
the spec's list of cells."""
import json
import os
import subprocess
import sys

from portbench.harness import ROOT, read_json
from portbench.tests.pb_tiny import add_cell, copy_checkout

HPCG = "hpcg64-cg-b1"
FILES = ("test_portbench_second_config.py", "test_portbench_harness.py",
         "test_portbench_traffic.py")


def test_the_tests_pass_with_one_more_cell(tmp_path):
    spec = copy_checkout(tmp_path)
    cell = [w for w in spec["workloads"] if w["name"] == HPCG][0]
    source = [c for c in spec["configs"] if c["name"] == cell["config"]][0]
    config = {**read_json(os.path.join(ROOT, source["file"])), "name": "probe-config"}
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]
               if HPCG in m.get("workloads", ())]
    add_cell(tmp_path, spec, "probe-cell", config, cell["traffic"],
             read_json(os.path.join(ROOT, "portbench", "cells", f"{HPCG}.json")), metrics)
    assert len(json.loads((tmp_path / "BENCHMARK.json").read_text())["workloads"]) == len(
        read_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]) + 1
    tests = [os.path.join("portbench", "tests", f) for f in FILES]
    # A session of its own: nothing of the calling session's workers.
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{tmp_path / 'src'}"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         *tests], cwd=tmp_path, capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert " passed" in out.stdout.splitlines()[-1]
