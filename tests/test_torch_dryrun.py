"""The port's dry-run (``repro_torch.launch.dryrun``) on small fake meshes.

The counterpart of ``tests/test_dryrun_artifacts.py``'s checks, on cells
the test makes itself: reduced qwen3-1.7b's ``train_4k`` step on a fake
process group of 4 ranks, ``(data, model) = (2, 2)``, and of 8 ranks,
``(pod, data, model) = (2, 2, 2)``, every tensor on ``meta``; and the
decode step and the SSD on meshes where DTensor alone cannot place them:
qwen3's decode on ``(1, 4)`` (four query heads over four ranks, two K / V
heads), hymba's on ``(1, 4)`` and its ``long_500k`` decode on ``(2, 2)``
(a batch of one, the cache sharded over the sequence), and mamba2's
``train_4k`` step on ``(1, 4)``. One subprocess runs every cell (and a
cell the arch cannot run), writing the artifacts to a temporary
directory; a fake group left behind would then die with it.
"""
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH_PATHS = (("qwen3-1.7b", "decode_32k", (1, 4)), ("hymba-1.5b", "decode_32k", (1, 4)),
              ("hymba-1.5b", "long_500k", (2, 2)), ("mamba2-2.7b", "train_4k", (1, 4)))

_CELLS = textwrap.dedent(
    """
    import sys
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    dryrun.ARTIFACT_DIR = sys.argv[1]
    MESH_PATHS = {mesh_paths!r}
    dryrun.run_cell("qwen3-1.7b", "train_4k", reduced=True, mesh_shape=(2, 2))
    dryrun.run_cell("qwen3-1.7b", "train_4k", reduced=True, mesh_shape=(2, 2, 2),
                    multi_pod=True)
    dryrun.run_cell("qwen3-1.7b", "long_500k", reduced=True, mesh_shape=(2, 2))
    for arch, shape, mesh in MESH_PATHS:
        dryrun.run_cell(arch, shape, reduced=True, mesh_shape=mesh)
    assert not dist.is_initialized()
    """
).format(mesh_paths=MESH_PATHS)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_torch"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", _CELLS, out], check=True, env=env, cwd=REPO,
                   timeout=300, capture_output=True)
    found = {}
    for path in glob.glob(os.path.join(out, "*.json")):
        with open(path) as fh:
            cell = json.load(fh)
        found[(cell["arch"], cell["shape"], cell["mesh"])] = cell
    return found


def _qwen3(shape, mesh):
    return ("qwen3-1.7b", shape, mesh)


def _mesh_name(mesh):
    return "mesh" + "x".join(map(str, mesh))


def test_cells_ran(cells):
    assert set(cells) == {_qwen3("train_4k", "mesh2x2"), _qwen3("train_4k", "mesh2x2x2"),
                          _qwen3("long_500k", "mesh2x2")} | {
        (a, s, _mesh_name(m)) for a, s, m in MESH_PATHS}
    for key in (_qwen3("train_4k", "mesh2x2"), _qwen3("train_4k", "mesh2x2x2")):
        assert cells[key]["status"] == "ok", cells[key].get("trace")
        assert cells[key]["kind"] == "train"
    assert cells[_qwen3("train_4k", "mesh2x2")]["chips"] == 4
    assert cells[_qwen3("train_4k", "mesh2x2x2")]["chips"] == 8
    skipped = cells[_qwen3("long_500k", "mesh2x2")]
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]


@pytest.mark.parametrize("mesh", ["mesh2x2", "mesh2x2x2"])
def test_roofline_fields_consistent(cells, mesh):
    c = cells[_qwen3("train_4k", mesh)]
    assert c["flops_per_device"] > 0 and c["bytes_per_device"] > 0
    assert c["compute_term_s"] == c["flops_per_device"] / PEAK_FLOPS_BF16
    assert c["memory_term_s"] == c["bytes_per_device"] / HBM_BW
    assert c["collective_term_s"] == c["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": c["compute_term_s"], "memory": c["memory_term_s"],
             "collective": c["collective_term_s"]}
    assert c["dominant"] == max(terms, key=terms.get)
    per_device = c["model_flops_global"] / c["chips"]
    assert c["useful_flop_ratio"] == pytest.approx(per_device / c["flops_per_device"])
    assert c["mfu"] == pytest.approx(per_device / (PEAK_FLOPS_BF16 * max(terms.values())))
    assert 0 <= c["useful_flop_ratio"] < 1.6 and 0 <= c["mfu"] <= 1.0
    assert c["raw_fullL"] == {"flops": c["flops_per_device"], "bytes": c["bytes_per_device"],
                              "coll": c["collective_bytes_per_device"]}
    wire = sum(2 * b if op == "all-reduce" else b for op, b in c["collective_breakdown"].items())
    assert wire == pytest.approx(c["collective_bytes_per_device"])
    assert set(c["collective_counts"]) == set(c["collective_breakdown"])
    mem = c["memory"]
    assert mem["argument_bytes_per_device"] > 0 and mem["output_bytes_per_device"] > 0
    assert "temp_bytes_per_device" not in mem  # no counterpart in an eager program


def test_multi_pod_halves_per_device_load(cells):
    """2× the chips (same global batch) → per-device compute term about
    half (batch sharded over pod × data)."""
    ratio = (cells[_qwen3("train_4k", "mesh2x2x2")]["compute_term_s"]
             / cells[_qwen3("train_4k", "mesh2x2")]["compute_term_s"])
    assert 0.3 < ratio < 0.75, ratio


@pytest.mark.parametrize("arch,shape,mesh", MESH_PATHS,
                         ids=[f"{a}-{s}-{_mesh_name(m)}" for a, s, m in MESH_PATHS])
def test_decode_and_ssd_cells_run_on_a_mesh(cells, arch, shape, mesh):
    c = cells[(arch, shape, _mesh_name(mesh))]
    assert c["status"] == "ok", c.get("trace")
    assert c["kind"] == ("train" if shape.startswith("train") else "decode")
    assert c["flops_per_device"] > 0 and c["collective_bytes_per_device"] > 0
