"""The harness: files found by name, the import guard, and the exits
without a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.harness import BANNED, HERE, ROOT, read_json, banned_modules, reader, resolve

SPEC = read_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_name_in_the_spec_has_its_file():
    for w in SPEC["workloads"]:
        cell = resolve(SPEC, w["name"])
        assert cell.traffic["loop"] in ("solve", "open", "closed")
        assert set(cell.cell["limits"]) == {"x_err", "unanswered"}
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(reader(m["name"]))
    for c in SPEC["configs"]:
        cfg = read_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg)


def test_a_new_cell_is_found_by_its_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new
    files and new entries, without a change to the harness."""
    pb = tmp_path / "portbench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        (pb / sub).mkdir(parents=True)
    (pb / "configs" / "hpcg-27pt-8.json").write_text(json.dumps(
        {"name": "hpcg-27pt-8", "generator": "stencil27", "nx": 8, "ny": 8, "nz": 8,
         "plan": {"nodes": 2, "cores": 2, "combo": "NL-HC", "exchange": "replicated",
                  "block": 8, "seed": 0, "executor": "simulate"}, "reduced": []}))
    (pb / "traffic" / "cg-b2-i5.json").write_text(json.dumps(
        {"loop": "solve", "solver": "cg", "graph": "a", "arg": "b", "batch": 2, "iters": 5,
         "payload": "normal", "pool": 2}))
    (pb / "cells" / "tiny-cg.json").write_text(json.dumps(
        {"sample": 1, "limits": {"x_err": 1e-4, "unanswered": 0}}))
    (pb / "metrics" / "solves_per_s.py").write_text(
        "def read(run):\n    return run.attempted / run.window_s\n")
    spec = {"configs": [{"name": "hpcg-27pt-8", "file": "portbench/configs/hpcg-27pt-8.json"}],
            "workloads": [{"name": "tiny-cg", "config": "hpcg-27pt-8", "traffic": "cg-b2-i5",
                           "chips": 1}],
            "end_to_end": [{"name": "solves_per_s", "unit": "1/s"}], "per_layer": []}
    cell = resolve(spec, "tiny-cg", root=str(tmp_path))
    assert cell.config["nx"] == 8 and cell.traffic["batch"] == 2
    out = harness.run_cell(cell, seed=5, seconds=0.2, trace=False, device="cpu", t_start=0.0)
    assert out["correct"] is True
    value = reader("solves_per_s", root=str(tmp_path))
    assert value is not None
    with pytest.raises(KeyError):
        resolve(spec, "no-such-cell", root=str(tmp_path))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(BANNED), (path, tops & set(BANNED))


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources():
        if os.sep + "reference" + os.sep in path:
            tops = {name.split(".")[0] for name in _imports(path)}
            assert "repro_torch" not in tops and not tops & set(BANNED), path


def test_the_guard_compares_whole_top_level_names():
    assert banned_modules({"repro_torch": 1, "repro_torch.api": 1, "reprox": 1}) == []
    assert banned_modules({"repro.api": 1, "jaxlib.xla": 1, "numpy": 1}) == ["jaxlib", "repro"]
    assert banned_modules({"flax": 1, "jax": 1}) == ["flax", "jax"]


def test_a_cpu_run_loads_no_banned_module():
    code = ("import sys, time; sys.path[0:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "from portbench.tests.pb_tiny import run; from portbench.harness import banned_modules;"
            "run('hpcg64-cg-b1', seconds=0.2); print(banned_modules())")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run_py(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "hpcg64-cg-b1",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": ""})


def test_run_exits_non_zero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the exit without one")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_exits_non_zero_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
