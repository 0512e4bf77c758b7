"""Cells of new configurations, generators, traffic mixes and solvers,
added to a copy of the checkout as new files and new entries only: each
is cut to a CPU test's size by its own generator's ``TINY``, gets the
fault cases its traffic can have, and runs through ``run_cell`` with no
edit to a file the harness has. The expectations about
``hpcg64-cg-b1`` hold whatever other cells the spec has."""
import json
import os

import numpy as np
import pytest

import portbench.matrices
from portbench import harness
from portbench.harness import HERE, ROOT, read_json
from portbench.matrices import generator, make_graphs
from portbench.tests.pb_tiny import SPEC, add_cell, copy_checkout, fault_cases, run, tiny
from portbench.tests.test_portbench_faults import CASES, FAULTS

HPCG = "hpcg64-cg-b1"
PLAN = {"nodes": 4, "cores": 4, "combo": "NL-HC", "exchange": "selective", "block": 16,
        "seed": 0, "executor": "simulate"}
# What a cell reports that is neither CG's nor read from the device trace.
SOLVE_METRICS = ("solve_rhs_iters_per_s", "plan_s", "plan_partition_s", "plan_pack_s")

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

# A directed graph with dangling columns (every fourth vertex links
# nowhere) and skewed in-degrees, weights of both signs: what PageRank's
# column scan, dangling restart and |A| view have to get right.
DIGRAPH = '''
import numpy as np

from portbench.matrices import Matrix

TINY = {"n": 240}


def graphs(config, seed):
    n, k = config["n"], config["degree"]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 9])
    src = np.repeat(np.arange(n), k)
    dst = (rng.random(n * k) ** 3 * n).astype(np.int64)
    keep = src % 4 != 0
    row, col = np.divmod(np.unique(dst[keep] * n + src[keep]), n)
    val = rng.choice([-1.0, 1.0], row.size) * rng.uniform(0.5, 2.0, row.size)
    return {"g": Matrix(n, row.astype(np.int32), col.astype(np.int32), val.astype(np.float32))}
'''

# A plain reference for a solver that the package's reference lacks:
# PageRank as the program's ``pagerank(normalize="auto")`` documents it.
PAGERANK = '''
"""PageRank over the column-stochastic |A| (each column over its sum),
a dangling column's mass restarted at the teleport, damping 0.85, the L1
norm renormalised every step, from the teleport itself."""
import numpy as np
import torch

from portbench.matrices import Matrix
from portbench.reference import Operator

DAMPING = 0.85


def solve(m, seeds, iters, precision):
    op = Operator(Matrix(m.n, m.row, m.col, np.abs(m.val)), precision, seeds.device)
    colsum = np.bincount(m.col, weights=np.abs(m.val.astype(np.float64)), minlength=m.n)
    inv = np.where(colsum > 0, 1.0 / np.maximum(colsum, 1e-300), 0.0)
    inv = torch.as_tensor(inv, dtype=op.dtype, device=seeds.device)
    dangling = torch.as_tensor(colsum == 0, dtype=op.dtype, device=seeds.device)
    s = seeds.to(op.dtype)
    s = s / s.abs().sum(dim=-1, keepdim=True)
    r = s
    for _ in range(iters):
        mass = (r * dangling).sum(dim=-1, keepdim=True)
        r = DAMPING * (op(r * inv) + mass * s) + (1.0 - DAMPING) * s
        r = r / r.abs().sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return r
'''


@pytest.fixture
def second(tmp_path):
    """A checkout with a second configuration's files added beside the
    first's: a new generator under CG."""
    spec = copy_checkout(tmp_path)
    add_cell(tmp_path, spec, "lap5-cg-b1",
             {"name": "lap5-2048", "generator": "lap5_test", "nx": 2048, "ny": 2048,
              "plan": PLAN, "reduced": []},
             "cg-uniform-b1-i20", {"sample": 2, "limits": {"x_err": 2e-5, "unanswered": 0}},
             SOLVE_METRICS + ("cg_iter_host_ms",),
             files={"matrices/lap5_test.py": LAP5,
                    "traffic/cg-uniform-b1-i20.json": json.dumps(
                        {"loop": "solve", "solver": "cg", "graph": "g", "arg": "b", "batch": 1,
                         "iters": 20, "payload": "uniform", "pool": 2})})
    # The harness finds the new generator in the checkout, as it finds
    # the cell's other files.
    assert not os.path.exists(os.path.join(HERE, "matrices", "lap5_test.py"))
    return spec, str(tmp_path)


@pytest.fixture
def pagerank(tmp_path):
    """A checkout with a cell of a new configuration and a new solver:
    its generator, traffic and plain reference all new files."""
    spec = copy_checkout(tmp_path)
    add_cell(tmp_path, spec, "digraph-pagerank-b1",
             {"name": "digraph-test", "generator": "digraph_test", "n": 131072, "degree": 16,
              "plan": PLAN, "reduced": []},
             "pagerank-uniform-b1-i20", {"sample": 2, "limits": {"x_err": 2e-5, "unanswered": 0}},
             SOLVE_METRICS,
             files={"matrices/digraph_test.py": DIGRAPH, "reference/pagerank.py": PAGERANK,
                    "traffic/pagerank-uniform-b1-i20.json": json.dumps(
                        {"loop": "solve", "solver": "pagerank", "graph": "g", "arg": "seeds",
                         "batch": 1, "iters": 20, "payload": "uniform", "pool": 2})})
    return spec, str(tmp_path)


def test_the_second_cell_is_cut_by_its_own_generator(second):
    spec, root = second
    cell = tiny("lap5-cg-b1", spec, root)
    assert (cell.config["nx"], cell.config["ny"]) == (9, 8)
    assert cell.config["plan"]["nodes"] == 2 and cell.config["plan"]["cores"] == 2
    assert "nz" not in cell.config
    # The first cell is cut as it always was.
    first = tiny(HPCG, spec, root)
    assert (first.config["nx"], first.config["ny"], first.config["nz"]) == (6, 7, 5)


def test_the_second_cell_gets_no_half_batch_case(second):
    spec, root = second
    cases = fault_cases(FAULTS, spec, root)
    assert [f for w, f in cases if w == "lap5-cg-b1"] == [
        "state_unchanged", "no_exchange", "answer_altered"]
    assert [c for c in cases if c[0] == HPCG] == [c for c in CASES if c[0] == HPCG]


def test_the_second_cell_runs_and_is_correct(second):
    spec, root = second
    cell = tiny("lap5-cg-b1", spec, root)
    assert cell.traffic["payload"] == "uniform"
    out = run("lap5-cg-b1", cell=cell, seconds=0.3)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"solve_rhs_iters_per_s", "setup_s"} <= set(out["metrics"])
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
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


def test_the_pagerank_cell_runs_and_is_correct(pagerank):
    spec, root = pagerank
    cell = tiny("digraph-pagerank-b1", spec, root)
    assert cell.config["n"] == 240 and cell.traffic["arg"] == "seeds"
    m = make_graphs(cell.config, 7, root)["g"]
    colsum = np.bincount(m.col, minlength=m.n)
    assert (colsum == 0).sum() >= m.n // 4 and (m.val < 0).any()  # dangling; |A| differs
    out = run("digraph-pagerank-b1", cell=cell, seconds=0.3)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["x_err"]["value"] < 2e-6
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"solve_rhs_iters_per_s", "setup_s"} <= set(out["metrics"])


def test_the_pagerank_cell_reports_its_host_metrics_traced(pagerank):
    spec, root = pagerank
    cell = tiny("digraph-pagerank-b1", spec, root)
    out = run("digraph-pagerank-b1", cell=cell, seconds=0.3, trace=True)
    assert out["correct"] is True, out["checks"]
    host = {m["name"] for m in cell.per_layer if m["source"] == "host_clock"}
    assert "plan_s" in host and host <= set(out["metrics"])
    assert {"plan_partition_s", "plan_pack_s"} <= set(out["metrics"])
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("fault", ["state_unchanged", "no_exchange", "answer_altered"])
def test_a_fault_makes_the_pagerank_cell_incorrect(pagerank, monkeypatch, fault):
    spec, root = pagerank
    assert (("digraph-pagerank-b1", fault) in fault_cases(FAULTS, spec, root))
    FAULTS[fault](monkeypatch)
    out = run("digraph-pagerank-b1", cell=tiny("digraph-pagerank-b1", spec, root), seconds=0.3)
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
    cell = tiny(HPCG)
    assert {k: cell.config[k] for k in ("nx", "ny", "nz")} == {"nx": 6, "ny": 7, "nz": 5}
    assert cell.config["plan"]["nodes"] == 2 and cell.config["plan"]["cores"] == 2
    assert [c for c in CASES if c[0] == HPCG] == [
        (HPCG, f) for f in ("state_unchanged", "no_exchange", "answer_altered")]
    full = harness.resolve(SPEC, HPCG).config
    assert np.prod([full[k] for k in ("nx", "ny", "nz")]) == 64**3
