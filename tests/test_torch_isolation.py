"""The port stands alone: ``repro_torch``, its examples, ``chip_smoke.py``
and the card's tests load neither JAX nor any module of the JAX
package, its entry points — the plan store's and the train driver's
included — run on the card unless the caller asks for the CPU, and the
parts ported last (the fault runtime, the ``shard_map`` executor, the
schedule audit, the launch layer and the roofline) are there and refuse
what they cannot do."""
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
    STEPPERS,
    SparseSession,
    Topology,
    distribute,
    hydrate_session,
    load_session,
    session_from_numpy,
)
from repro_torch.kernels.spmv import bell_spmm, bell_tiles
from repro_torch.runtime import FaultInjector, Heartbeat
from repro_torch.serve import SparseServeEngine
from repro_torch.sparse.generate import random_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.join(dirpath, fn)
    for dirpath, _, files in os.walk(os.path.join(REPO, "src", "repro_torch"))
    for fn in files
    if fn.endswith(".py")
) + sorted(
    os.path.join(REPO, "examples", fn)
    for fn in os.listdir(os.path.join(REPO, "examples"))
    if fn.endswith("_torch.py")
) + [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_gpu.py")]
# Files of the port that the isolation checks must find (a rename would
# otherwise drop them from the list silently).
NAMED = ("src/repro_torch/models/encdec.py", "examples/quickstart_torch.py",
         "examples/pmvc_cluster_torch.py", "examples/serve_sparse_torch.py",
         "examples/train_lm_torch.py", "examples/serve_lm_torch.py",
         "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/shardings.py",
         "src/repro_torch/launch/specs.py", "src/repro_torch/launch/train.py",
         "src/repro_torch/launch/dryrun.py", "src/repro_torch/roofline/hw.py",
         "src/repro_torch/roofline/analysis.py",
         "tests/test_torch_gpu.py", "chip_smoke.py")


def test_import_loads_no_jax_and_no_reference_module():
    code = textwrap.dedent(
        """
        import sys
        import repro_torch, repro_torch.api, repro_torch.kernels.spmv
        import repro_torch.kernels.gmm, repro_torch.kernels.attn
        import repro_torch.kernels.build, repro_torch.pmvc.dist
        import repro_torch.serve, repro_torch.serve.driver, repro_torch.serve.sparse
        import repro_torch.api.plancache, repro_torch.sparse.delta
        import repro_torch.analysis, repro_torch.analysis.__main__
        import repro_torch.analysis.schedule_audit, repro_torch.runtime
        import repro_torch.runtime.elastic, repro_torch.runtime.fault
        import repro_torch.config, repro_torch.configs, repro_torch.data.synthetic
        import repro_torch.models, repro_torch.serve.engine
        import repro_torch.optim, repro_torch.train, repro_torch.checkpoint
        import repro_torch.core.expert_placement, repro_torch.models.moe
        import repro_torch.launch, repro_torch.launch.mesh, repro_torch.launch.shardings
        import repro_torch.launch.specs, repro_torch.launch.train, repro_torch.launch.dryrun
        import repro_torch.roofline, repro_torch.roofline.analysis, repro_torch.roofline.hw
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


def test_the_isolation_checks_cover_the_named_files():
    assert set(NAMED) <= {os.path.relpath(p, REPO) for p in PORT_FILES}


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
    assert set(EXECUTORS.names()) == {"reference", "simulate", "shard_map"}
    assert set(SOLVERS.names()) == {
        "power_iteration", "block_power_iteration", "jacobi", "pagerank", "cg",
    }
    assert set(STEPPERS.names()) == {"pagerank", "jacobi", "spmv", "cg"}


def test_unported_parts_say_so(tmp_path):
    """The ``shard_map`` executor is registered under the JAX package's
    name, and without a process group it says so: the first ``spmv``
    raises ``RuntimeError`` — directly, through ``with_executor`` and
    through an archive whose meta names it — and nothing substitutes
    ``simulate``."""
    a = random_coo(64, 300, seed=1)
    topo = Topology(2, 1)
    sess = distribute(a, topology=topo, device="cpu")
    x = np.ones(64, np.float32)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        sess.spmv(x, executor="shard_map")
    with pytest.raises(RuntimeError, match="never runs the units on one device"):
        sess.with_executor("shard_map").spmv(x)
    path = distribute(a, topology=topo, device="cpu", executor="shard_map").save(
        str(tmp_path / "plan.npz"))
    loaded = SparseSession.load(path, device="cpu")
    assert loaded.executor == "shard_map"
    with pytest.raises(RuntimeError, match="process group"):
        loaded.spmv(x)
    assert np.array_equal(loaded.spmv(x, executor="simulate"), sess.spmv(x))


def test_unported_serving_parts_say_so(tmp_path):
    """The engine takes the fault-tolerance wiring; what still needs an
    argument says so: ``checkpoint_graph`` without a ``recovery_dir``
    raises, as in the JAX package."""
    sess = distribute(random_coo(64, 300, seed=2), topology=Topology(2, 1), device="cpu")
    eng = SparseServeEngine(
        device="cpu", fault_injector=FaultInjector(), heartbeat=Heartbeat(2),
        recovery_dir=str(tmp_path / "recovery"), latency_probe=dict,
        straggler_factor=4.0, straggler_patience=2, max_recoveries=1,
    )
    eng.register_graph("g", sess)
    eng.register_graph("p", sess.save(str(tmp_path / "p.npz")))
    assert eng.graphs() == ["g", "p"]
    assert eng.checkpoint_graph("g") == 0
    eng.mark_unit_silent(0)
    assert (eng.dead_units, eng.recoveries, eng.recovery_log) == (set(), 0, [])
    with pytest.raises(RuntimeError, match="requires recovery_dir"):
        SparseServeEngine(device="cpu").checkpoint_graph("g")
    with pytest.raises(TypeError, match="SparseSession or a plan path"):
        eng.register_graph("h", object())


@pytest.mark.parametrize("module", ["repro_torch.runtime", "repro_torch.api.executors",
                                    "repro_torch.analysis.schedule_audit",
                                    "repro_torch.models", "repro_torch.serve.engine",
                                    "repro_torch.optim", "repro_torch.train",
                                    "repro_torch.checkpoint", "repro_torch.core.expert_placement",
                                    "repro_torch.models.moe", "repro_torch.models.encdec",
                                    "repro_torch.launch", "repro_torch.launch.train",
                                    "repro_torch.launch.dryrun", "repro_torch.roofline"])
def test_last_ported_parts_import_alone_without_jax(module):
    """The fault runtime, the executor registry with ``shard_map`` and
    the schedule audit, each imported alone in a fresh interpreter, load
    no JAX and no module of the JAX package."""
    code = (f"import sys, {module}\n"
            "print(','.join(sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'repro'))))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_plan_store_without_device_raises(monkeypatch, tmp_path):
    """Loading, hydrating or cache-planning with no device given and no
    card present raises before any archive is read or plan made."""
    sess = distribute(random_coo(64, 300, seed=3), topology=Topology(2, 1), device="cpu")
    path = sess.save(str(tmp_path / "plan.npz"))
    _no_card(monkeypatch)
    for call in (lambda: load_session(path), lambda: SparseSession.load(path),
                 lambda: hydrate_session(path),
                 lambda: distribute(sess.matrix, topology=Topology(2, 1),
                                    cache_dir=str(tmp_path / "c"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(tmp_path / "c")
    assert load_session(path, device="cpu").device == torch.device("cpu")


def test_lm_entry_points_without_device_raise(monkeypatch):
    """``build(cfg).init``, ``lm_from_numpy`` and ``ServeEngine`` run on
    the card unless given ``device="cpu"``: with no card they raise
    before any weight is drawn or any cache made."""
    from repro_torch.config import get_arch
    from repro_torch.models import build, lm_from_numpy, lm_to_numpy
    from repro_torch.serve import ServeEngine

    model = build(get_arch("qwen3-1.7b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    _no_card(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(gen)
    assert gen.initial_seed() == 0 and torch.equal(gen.get_state(),
                                                   torch.Generator().manual_seed(0).get_state())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_from_numpy(model.cfg, lm_to_numpy(params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    assert ServeEngine(model, params, device="cpu").device == torch.device("cpu")


def test_train_entry_points_without_device_raise(monkeypatch):
    """The optimizer state's loader runs on the card unless given
    ``device="cpu"``; the train step and loop run where the weights are."""
    from repro_torch.config import get_arch
    from repro_torch.models import build
    from repro_torch.models.interop import opt_from_numpy, opt_to_numpy
    from repro_torch.optim import init_opt

    model = build(get_arch("granite-moe-1b-a400m").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = opt_to_numpy(init_opt(params))
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt_from_numpy(model.cfg, state)
    assert opt_from_numpy(model.cfg, state, device="cpu").mu["embed"].device.type == "cpu"


def test_cublas_workspace_is_set_for_deterministic_steps():
    """Importing the port names a deterministic cuBLAS workspace unless the
    caller named one: PyTorch refuses cuBLAS under deterministic
    algorithms without it, and reads it once, at the first cuBLAS call."""
    code = "import os, repro_torch; print(os.environ['CUBLAS_WORKSPACE_CONFIG'])"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    run = lambda: subprocess.run([sys.executable, "-c", code], capture_output=True,  # noqa: E731
                                 text=True, env=env, timeout=120, check=True).stdout.strip()
    assert run() == ":4096:8"
    env["CUBLAS_WORKSPACE_CONFIG"] = ":16:8"
    assert run() == ":16:8"


def test_launch_train_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """``python -m repro_torch.launch.train`` without ``--device`` runs on
    the card: with none present it raises before any process group, mesh
    or weight is made; ``--device cpu`` is the CPU."""
    import torch.distributed as dist

    from repro_torch.launch.train import main

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert not dist.is_initialized() and not os.path.exists(tmp_path / "ckpt")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_the_mesh_layer_uses_public_dtensor_names(path):
    """The models run under DTensor's public ``implicit_replication``
    (``mesh_scope``), not by writing its dispatcher's private switch: a
    private name renamed between PyTorch versions would fail only where
    that version runs."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    private = {"_op_dispatcher", "_allow_implicit_replication"}
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)} & private
    assert not used, (path, used)


def test_mesh_scope_nests():
    """An inner ``mesh_scope`` leaving does not end the outer one's
    implicit replication (the library's own context manager turns it off
    on leaving), and the outer one leaving ends it."""
    from torch.distributed.tensor import DTensor

    from _torch_gloo import one_rank_mesh
    from repro_torch.models.mesh import MeshCtx, as_dtensor, mesh_scope

    with one_rank_mesh() as mesh:
        ctx = MeshCtx(mesh)
        d = as_dtensor(torch.ones(3), ctx)
        with mesh_scope(ctx):
            with mesh_scope(ctx):
                pass
            assert isinstance(d * torch.ones(3), DTensor)
        with pytest.raises(RuntimeError, match="mixed torch.Tensor and DTensor"):
            d * torch.ones(3)
