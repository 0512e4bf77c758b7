"""A cell of a second configuration, generator and traffic mix, added as
new files and new entries only: it is cut to a CPU test's size by its
own generator's ``TINY``, gets the fault cases its traffic can have, and
runs through ``run_cell`` with no edit to a file the harness has."""
import json
import os
import shutil

import numpy as np
import pytest

import portbench.matrices
from portbench import harness
from portbench.harness import HERE, ROOT, read_json
from portbench.matrices import generator
from portbench.tests.pb_tiny import SPEC, fault_cases, run, tiny
from portbench.tests.test_portbench_faults import CASES, FAULTS

# A generator module that the harness has never seen: the 2-D 5-point
# Laplacian (SPD), 4 on the diagonal and -1 for each grid neighbour.
LAP5 = '''
import numpy as np

from portbench.matrices import Matrix

TINY = {"nx": 9, "ny": 8}


def graphs(config, seed):
    nx, ny = config["nx"], config["ny"]
    iy, ix = np.divmod(np.arange(nx * ny), nx)
    rows, cols, vals = [np.arange(nx * ny)], [np.arange(nx * ny)], [np.full(nx * ny, 4.0)]
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ok = (ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) & (iy + dy < ny)
        rows.append(np.nonzero(ok)[0])
        cols.append(ix[ok] + dx + nx * (iy[ok] + dy))
        vals.append(np.full(int(ok.sum()), -1.0))
    return {"g": Matrix(nx * ny, np.concatenate(rows).astype(np.int32),
                        np.concatenate(cols).astype(np.int32),
                        np.concatenate(vals).astype(np.float32))}
'''


@pytest.fixture
def second(tmp_path):
    """A checkout's ``BENCHMARK.json`` and ``portbench/`` with a second
    configuration's files added beside the first's."""
    pb = tmp_path / "portbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "matrices" / "lap5_test.py").write_text(LAP5)
    (pb / "configs" / "lap5-2048.json").write_text(json.dumps(
        {"name": "lap5-2048", "generator": "lap5_test", "nx": 2048, "ny": 2048,
         "plan": {"nodes": 4, "cores": 4, "combo": "NL-HC", "exchange": "selective",
                  "block": 16, "seed": 0, "executor": "simulate"}, "reduced": []}))
    (pb / "traffic" / "cg-uniform-b1-i20.json").write_text(json.dumps(
        {"loop": "solve", "solver": "cg", "graph": "g", "arg": "b", "batch": 1, "iters": 20,
         "payload": "uniform", "pool": 2}))
    (pb / "cells" / "lap5-cg-b1.json").write_text(json.dumps(
        {"sample": 2, "limits": {"x_err": 2e-5, "unanswered": 0}}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "lap5-2048", "file": "portbench/configs/lap5-2048.json",
                            "reduced": []})
    spec["workloads"].append({"name": "lap5-cg-b1", "config": "lap5-2048",
                              "traffic": "cg-uniform-b1-i20", "chips": 1})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and m["source"] != "device_trace":
            m["workloads"].append("lap5-cg-b1")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # The harness finds the new generator in the checkout, as it finds
    # the cell's other files.
    assert not os.path.exists(os.path.join(HERE, "matrices", "lap5_test.py"))
    return spec, str(tmp_path)


def test_the_second_cell_is_cut_by_its_own_generator(second):
    spec, root = second
    cell = tiny("lap5-cg-b1", spec, root)
    assert (cell.config["nx"], cell.config["ny"]) == (9, 8)
    assert cell.config["plan"]["nodes"] == 2 and cell.config["plan"]["cores"] == 2
    assert "nz" not in cell.config
    # The first cell is cut as it always was.
    first = tiny("hpcg64-cg-b1", spec, root)
    assert (first.config["nx"], first.config["ny"], first.config["nz"]) == (6, 7, 5)


def test_the_second_cell_gets_no_half_batch_case(second):
    spec, root = second
    cases = fault_cases(FAULTS, spec, root)
    assert [f for w, f in cases if w == "lap5-cg-b1"] == [
        "state_unchanged", "no_exchange", "answer_altered"]
    assert [c for c in cases if c[0] == "hpcg64-cg-b1"] == CASES


def test_the_second_cell_runs_and_is_correct(second):
    spec, root = second
    cell = tiny("lap5-cg-b1", spec, root)
    assert cell.traffic["payload"] == "uniform"
    out = run("lap5-cg-b1", cell=cell, seconds=0.3)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"solve_rhs_iters_per_s", "setup_s"}
    traced = run("lap5-cg-b1", cell=tiny("lap5-cg-b1", spec, root), seconds=0.3, trace=True)
    assert traced["correct"] is True
    assert {"plan_s", "cg_iter_host_ms", "plan_partition_s", "plan_pack_s"} <= set(
        traced["metrics"])


@pytest.mark.parametrize("fault", ["state_unchanged", "no_exchange", "answer_altered"])
def test_a_fault_makes_the_second_cell_incorrect(second, monkeypatch, fault):
    spec, root = second
    FAULTS[fault](monkeypatch)
    out = run("lap5-cg-b1", cell=tiny("lap5-cg-b1", spec, root), seconds=0.3)
    assert out["correct"] is False, out["checks"]


def test_every_generator_declares_its_test_size():
    folder = os.path.dirname(portbench.matrices.__file__)
    names = [f[:-3] for f in os.listdir(folder) if f.endswith(".py") and f != "__init__.py"]
    configs = [read_json(os.path.join(ROOT, c["file"])) for c in SPEC["configs"]]
    assert names
    for name in names:
        mod = generator({"generator": name})
        assert callable(mod.graphs) and mod.TINY and isinstance(mod.TINY, dict)
        for c in configs:
            if c["generator"] == name:
                assert set(mod.TINY) <= set(c)


def test_the_stencil_is_cut_as_before():
    cell = tiny("hpcg64-cg-b1")
    assert {k: cell.config[k] for k in ("nx", "ny", "nz")} == {"nx": 6, "ny": 7, "nz": 5}
    assert cell.config["plan"]["nodes"] == 2 and cell.config["plan"]["cores"] == 2
    assert CASES == [("hpcg64-cg-b1", f)
                     for f in ("state_unchanged", "no_exchange", "answer_altered")]
    full = harness.resolve(SPEC, "hpcg64-cg-b1").config
    assert np.prod([full[k] for k in ("nx", "ny", "nz")]) == 64**3
