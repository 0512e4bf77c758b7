"""The port stands alone: ``repro_torch`` loads neither JAX nor any module
of the JAX package, its entry points run on the card unless the caller
asks for the CPU, and what this slice leaves out says so."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import (
    EXCHANGES,
    EXECUTORS,
    PARTITIONERS,
    SOLVERS,
    Topology,
    distribute,
    session_from_numpy,
)
from repro_torch.kernels.spmv import bell_spmm, bell_tiles
from repro_torch.sparse.generate import random_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.join(dirpath, fn)
    for dirpath, _, files in os.walk(os.path.join(REPO, "src", "repro_torch"))
    for fn in files
    if fn.endswith(".py")
) + [os.path.join(REPO, "chip_smoke.py")]


def test_import_loads_no_jax_and_no_reference_module():
    code = textwrap.dedent(
        """
        import sys
        import repro_torch, repro_torch.api, repro_torch.kernels.spmv
        import repro_torch.kernels.gmm, repro_torch.kernels.attn
        import repro_torch.kernels.build, repro_torch.pmvc.dist
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "repro")
                     or m.startswith(("jax.", "jaxlib.", "repro.")))
        print(",".join(bad))
        """
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_file_of_the_port_imports_jax_or_repro(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, node.lineno, name)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    assert repro_torch.DEFAULT_DEVICE == torch.device("cuda")


def test_distribute_without_device_raises_before_planning(monkeypatch):
    _no_card(monkeypatch)
    a = random_coo(64, 300, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distribute(a, topology=Topology(2, 1))


def test_session_from_numpy_without_device_raises(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        session_from_numpy(
            shape=(4, 4), row=[0], col=[0], val=[1.0], topology=(1, 1),
            combo="NL-HL", elem_unit=[0], device_plan={}, exchange="replicated",
        )


def test_bell_spmm_refuses_other_devices():
    bt = bell_tiles(
        torch.zeros((1, 1, 8, 8), device="meta"), np.zeros((1, 1), np.int32),
        np.zeros((1, 1), np.int32), np.ones(1), 1,
    )
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        bell_spmm(bt, torch.zeros((1, 1, 8, 2), device="meta"))


def test_slice_surface():
    assert set(PARTITIONERS.names()) >= {"NL-HL", "NL-HC", "NC-HL", "NC-HC", "nezgt", "hyper"}
    assert set(EXCHANGES.names()) == {"replicated", "selective", "overlap"}
    assert set(EXECUTORS.names()) == {"reference", "simulate"}
    assert set(SOLVERS.names()) == {
        "power_iteration", "block_power_iteration", "jacobi", "pagerank", "cg",
    }


def test_unported_parts_say_so():
    a = random_coo(64, 300, seed=1)
    topo = Topology(2, 1)
    with pytest.raises(NotImplementedError, match="plan cache"):
        distribute(a, topology=topo, device="cpu", cache_dir="plans")
    with pytest.raises(NotImplementedError, match="linter"):
        distribute(a, topology=topo, device="cpu", validate="strict")
    sess = distribute(a, topology=topo, device="cpu")
    with pytest.raises(KeyError, match="unknown executor 'shard_map'"):
        sess.spmv(np.ones(64, np.float32), executor="shard_map")
