"""The port's mesh paths on gloo process groups, against the JAX package.

The JAX side runs in a subprocess with eight forced host devices: the
MoE layer of reduced granite-moe-1b-a400m (8 experts, top-2, d_model 64)
on an input ``[4, 8, 64]``, meshless and on the ``(2, 2)`` and ``(1, 4)``
``(data, model)`` meshes with ``moe_a2a`` off and on, and
``python -m repro.launch.train --arch qwen3-1.7b --reduced --data 2
--model 2 --steps 4 --seq 32 --batch 4``, whose initial weights and loss
history it writes out. The port's side runs on gloo groups of CPU ranks
(``tests/_torch_gloo.py``) on those numpy weights and inputs:

* ``moe_ffn`` on both meshes and both branches within 1e-5 of the JAX
  package's mesh path (and its gradients within 1e-5 of the port's
  meshless ones, relative to their largest entry);
* ``repro_torch.launch.train`` on ``(2, 2)``: the loss history within
  1e-5 relative of the reference's;
* ``act_anchor`` changes the logits of reduced qwen3 on ``(2, 2)`` by
  rounding only (within 1e-5), and the mesh forward is within 1e-5 of
  the meshless one;
* the decode step and the SSD on ``(2, 2)`` and ``(1, 4)``, within 1e-5
  of the port's meshless paths (held against the JAX package's in
  tests/test_torch_lm_models.py): reduced qwen3 decoding a batch of 4
  and one of 1 (its cache then sharded over the sequence, the softmax
  combined over that axis), reduced mamba2 and hymba (the latter also
  cut to 2 SSD heads, which the 4 model ranks do not divide): a forward,
  6 decode steps, and hymba's loss gradients;
* the counterpart of ``tests/test_system.py::test_elastic_rescale_subprocess``:
  a tree placed with ``P("model")`` on 4 ranks is checkpointed, restored
  by ``elastic_restart`` onto 8 ranks, ``np.asarray`` bitwise, each rank
  holding a ``(1, 8)`` block.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from _torch_gloo import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
MESHES = ((2, 2), (1, 4))

_JAX_SIDE = textwrap.dedent(
    """
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro.config import get_arch
    from repro.models import moe
    from repro.runtime import make_mesh_any
    import repro.launch.train as lt

    out = sys.argv[1]
    res = {}
    base = get_arch("granite-moe-1b-a400m").reduced()
    p = moe.init_moe(jax.random.PRNGKey(0), base, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, base.d_model), jnp.float32)
    res["moe/x"] = np.asarray(x)
    res.update({f"moe/p/{k}": np.asarray(v) for k, v in p.items()})
    res["moe/meshless"] = np.asarray(moe.moe_ffn(p, x, base, moe.MeshCtx())[0])
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh_any(shape, ("data", "model"))
        for a2a in (0, 1):
            cfg = dataclasses.replace(base, moe_a2a=bool(a2a))
            ctx = moe.MeshCtx(mesh, ("data",))
            y = jax.jit(lambda p, x: moe.moe_ffn(p, x, cfg, ctx)[0])(p, x)
            res[f"moe/{shape[0]}x{shape[1]}/{a2a}"] = np.asarray(y)

    hist = []
    class Loop(lt.TrainLoop):
        def run(self, params, num_steps, **kw):
            flat, _ = jax.tree_util.tree_flatten_with_path(params)
            for path, v in flat:
                res["train/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                        for k in path)] = np.asarray(v)
            r = super().run(params, num_steps, **kw)
            hist.extend(float(h["loss"]) for h in r.metrics_history)
            return r
    lt.TrainLoop = Loop
    sys.argv = ["train", "--arch", "qwen3-1.7b", "--reduced", "--data", "2", "--model", "2",
                "--steps", "4", "--seq", "32", "--batch", "4",
                "--ckpt-dir", os.path.join(out, "jax_ckpt")]
    lt.main()
    np.savez(os.path.join(out, "jax.npz"), **res)
    with open(os.path.join(out, "jax_hist.json"), "w") as fh:
        json.dump(hist, fh)
    """
)


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _moe_cells(jax_npz):
    """Every rank: the MoE layer on both meshes, both branches, and the
    port's meshless layer, outputs and gradients as numpy."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.config import get_arch
    from repro_torch.launch.shardings import param_shardings, place
    from repro_torch.models import MeshCtx, moe
    from repro_torch.models.interop import params_from_numpy

    with np.load(jax_npz) as z:
        weights = {k.split("/")[-1]: z[k] for k in z.files if k.startswith("moe/p/")}
        x_np = z["moe/x"]
    base = get_arch("granite-moe-1b-a400m").reduced()
    tree = params_from_numpy({"layers": [{"moe": weights}]}, torch.float32, "cpu")

    def grads(layer, cfg, ctx, x):
        x = x.requires_grad_(True)
        for w in layer.parameters():
            w.requires_grad_(True)
        with moe.mesh_scope(ctx):
            y, _ = moe.moe_ffn(layer, x, cfg, ctx)
            gx, gw = torch.autograd.grad((y * y).sum(), [x, layer["w_gate"]])
        if ctx is None:
            return y.detach().numpy(), gx.numpy(), gw.numpy()
        return (y.full_tensor().detach().numpy(), gx.full_tensor().numpy(),
                gw.full_tensor().numpy())

    out = {"meshless": grads(tree["layers"][0]["moe"], base, None, torch.tensor(x_np))}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        for a2a in (0, 1):
            cfg = dataclasses.replace(base, moe_a2a=bool(a2a))
            placed = place(tree, param_shardings(tree, cfg, mesh))
            x = distribute_tensor(torch.tensor(x_np), mesh, [Replicate(), Replicate()],
                                  src_data_rank=None)
            out[f"{shape[0]}x{shape[1]}/{a2a}"] = grads(
                placed["layers"][0]["moe"], cfg, MeshCtx(mesh, ("data",)), x)
    return out


def _anchor_cells():
    """Every rank: reduced qwen3's logits on (2, 2) with act_anchor off
    and on, and meshless."""
    from repro_torch.config import get_arch
    from repro_torch.launch.mesh import batch_axes_of, make_test_mesh
    from repro_torch.launch.shardings import batch_shardings, param_shardings, place
    from repro_torch.models import MeshCtx, build

    base = get_arch("qwen3-1.7b").reduced()
    params = build(base).init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, base.vocab_size, (4, 16)))
    mesh = make_test_mesh(2, 2, device_type="cpu")
    ctx = MeshCtx(mesh, batch_axes_of(mesh))
    out = {}
    with torch.no_grad():
        out["meshless"] = build(base).forward(params, {"tokens": toks})[0].numpy()
        for anchor in (0, 1):
            cfg = dataclasses.replace(base, act_anchor=bool(anchor))
            batch = {"tokens": toks}
            logits, _ = build(cfg).forward(place(params, param_shardings(params, cfg, mesh)),
                                           place(batch, batch_shardings(batch, mesh)), ctx)
            out[anchor] = logits.full_tensor().numpy()
    return out


DECODE_CELLS = (("qwen3-1.7b", 4, {}), ("qwen3-1.7b", 1, {}), ("mamba2-2.7b", 4, {}),
                ("hymba-1.5b", 4, {}), ("hymba-1.5b", 4, {"ssm_head_dim": 64}))


def _decode_ssd_cells():
    """Every rank, on (2, 2) and (1, 4), for each of DECODE_CELLS: the
    logits of a forward over 16 tokens and of 6 decode steps over the
    first 6, meshless and on the mesh; for hymba also the loss gradients
    (as numpy, whole)."""
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.launch.mesh import batch_axes_of, make_test_mesh
    from repro_torch.launch.shardings import (batch_shardings, decode_state_shardings,
                                              param_shardings, place)
    from repro_torch.models import MeshCtx, build
    from repro_torch.models.mesh import mesh_scope
    from repro_torch.train.step import value_and_grad

    def run(model, params, toks, ctx, mesh):
        batch = {"tokens": toks}
        state = model.init_state(params, batch, max_len=8)
        if mesh is not None:
            params = place(params, param_shardings(params, model.cfg, mesh))
            batch = place(batch, batch_shardings(batch, mesh))
            state = place(state, decode_state_shardings(state, model.cfg, mesh))
        whole = (lambda t: t) if mesh is None else (lambda t: t.full_tensor())
        with torch.no_grad():
            out = {"forward": whole(model.forward(params, batch, ctx)[0]).numpy()}
            for t in range(6):
                logits, state = model.decode_step(params, toks[:, t:t + 1], state, ctx)
                out[f"decode{t}"] = whole(logits).numpy()
        if model.cfg.family == "hybrid":
            tc = TrainConfig()
            with mesh_scope(ctx):
                _, _, grads = value_and_grad(model, params, batch, ctx, tc)
            out.update({f"grad/{n}": whole(g).numpy() for n, g in grads.items()})
        return out

    out = {}
    for shape in MESHES:
        mesh = make_test_mesh(*shape, device_type="cpu")
        ctx = MeshCtx(mesh, batch_axes_of(mesh))
        for i, (arch, b, cut) in enumerate(DECODE_CELLS):
            cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **cut)
            model = build(cfg)
            params = model.init(torch.Generator().manual_seed(i), device="cpu")
            toks = torch.tensor(np.random.default_rng(i).integers(0, cfg.vocab_size, (b, 16)))
            if shape == MESHES[0]:
                out[f"meshless/{i}"] = run(model, params, toks, None, None)
            out[f"{shape[0]}x{shape[1]}/{i}"] = run(model, params, toks, ctx, mesh)
    return out


def _train_cell(jax_npz, ckpt_dir):
    from repro_torch.config import get_arch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import lm_from_numpy

    cfg = get_arch("qwen3-1.7b").reduced()
    with np.load(jax_npz) as z:
        flat = {k[len("train/"):]: z[k] for k in z.files if k.startswith("train/")}
    params = lm_from_numpy(cfg, _nest(flat), device="cpu")
    res = train(cfg, make_test_mesh(2, 2, device_type="cpu"), steps=4, seq=32, batch=4,
                ckpt_dir=ckpt_dir, device="cpu", params=params)
    return [h["loss"] for h in res.metrics_history]


def _elastic_tree():
    return {"w": np.arange(64.0).reshape(8, 8), "b": np.ones((8,))}


def _elastic_spec(key, leaf):
    from repro_torch.runtime.elastic import P

    return P("model") if np.ndim(leaf) else P()


def _wait_for(path, timeout=300.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if os.path.exists(path + ".failed") or time.monotonic() > deadline:
            raise RuntimeError(f"the JAX side wrote no {os.path.basename(path)}")
        time.sleep(0.2)


def _four_ranks(rank, world, work):
    """The cells of the 4-rank group, in one spawn: those that need no JAX
    output first, while the JAX side runs."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import reshard_tree

    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    placed = reshard_tree(_elastic_tree(), mesh4, _elastic_spec)
    CheckpointManager(os.path.join(work, "elastic", f"rank{rank}")).save(3, placed)
    out = {"elastic_local": tuple(placed["w"].to_local().shape), "anchor": _anchor_cells(),
           "decode": _decode_ssd_cells()}
    _wait_for(os.path.join(work, "jax_hist.json"))
    jax_npz = os.path.join(work, "jax.npz")
    out.update(moe=_moe_cells(jax_npz), train=_train_cell(jax_npz, os.path.join(work, "ckpt")))
    return out


def _eight_ranks(rank, world, ckpt_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import elastic_restart

    mesh8 = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
    restored, step = elastic_restart(CheckpointManager(ckpt_dir), _elastic_tree(), mesh8,
                                     _elastic_spec)
    return {"step": step, "w": np.asarray(restored["w"]), "b": np.asarray(restored["b"]),
            "local": tuple(restored["w"].to_local().shape)}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("launch_mesh"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    jax_side = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, work], env=env, cwd=REPO,
                                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def watch():  # tells the ranks waiting for the JAX side that it failed
        _, err = jax_side.communicate(timeout=300)
        if jax_side.returncode:
            with open(os.path.join(work, "jax_hist.json.failed"), "w") as fh:
                fh.write(err)

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        four = run_ranks(_four_ranks, 4, os.path.join(work, "g4"), work)
    finally:
        watcher.join()
    eight = run_ranks(_eight_ranks, 8, os.path.join(work, "g8"),
                      os.path.join(work, "elastic", "rank0"))
    with open(os.path.join(work, "jax_hist.json")) as fh:
        jax_hist = json.load(fh)
    with np.load(os.path.join(work, "jax.npz")) as z:
        jax_moe = {k: z[k] for k in z.files if k.startswith("moe/")}
    return {"jax_moe": jax_moe, "jax_hist": jax_hist, "four": four, "eight": eight}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("a2a", [0, 1], ids=["replicated", "a2a"])
def test_moe_mesh_branches_match_the_reference(cells, shape, a2a):
    key = f"{shape[0]}x{shape[1]}/{a2a}"
    ref = cells["jax_moe"][f"moe/{key}"]
    for rank in cells["four"]:
        y, gx, gw = rank["moe"][key]
        assert _rel(y, ref) <= TOL
        y0, gx0, gw0 = rank["moe"]["meshless"]
        assert _rel(gx, gx0) <= TOL and _rel(gw, gw0) <= TOL
    assert _rel(cells["four"][0]["moe"]["meshless"][0], cells["jax_moe"]["moe/meshless"]) <= TOL


def test_launch_train_matches_the_reference_loss_history(cells):
    ref = np.asarray(cells["jax_hist"])
    assert len(ref) == 4
    for rank in cells["four"]:
        got = np.asarray(rank["train"])
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref) / np.abs(ref)) <= TOL
    assert ref[-1] < ref[0]


def test_act_anchor_changes_nothing(cells):
    """The anchor moves where the model axis's partial sums are reduced
    (the residual stream is made whole before each block), so logits may
    differ in the last bits: held at the float32 parity tolerance."""
    for rank in cells["four"]:
        out = rank["anchor"]
        assert _rel(out[1], out[0]) <= TOL
        assert _rel(out[0], out["meshless"]) <= TOL and _rel(out[1], out["meshless"]) <= TOL


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("cell", range(len(DECODE_CELLS)),
                         ids=[f"{a}-b{b}{'-cut' if c else ''}" for a, b, c in DECODE_CELLS])
def test_decode_and_ssd_on_a_mesh_match_meshless(cells, shape, cell):
    for rank in cells["four"]:
        ref = rank["decode"][f"meshless/{cell}"]
        got = rank["decode"][f"{shape[0]}x{shape[1]}/{cell}"]
        assert got.keys() == ref.keys()
        for key in ref:
            assert _rel(got[key], ref[key]) <= TOL, key


def test_elastic_rescale_four_to_eight_ranks(cells):
    tree = _elastic_tree()
    assert {r["elastic_local"] for r in cells["four"]} == {(2, 8)}
    for rank in cells["eight"]:
        assert rank["step"] == 3
        assert np.array_equal(rank["w"], tree["w"]) and np.array_equal(rank["b"], tree["b"])
        assert rank["local"] == (1, 8)
