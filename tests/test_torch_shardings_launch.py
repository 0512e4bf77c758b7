"""The port's launch layer against the JAX package's: sharding rules at
full width, input stand-ins, mesh factories, and the train driver.

The counterpart of ``tests/test_shardings_launch.py`` and
``tests/test_perf_opts.py::test_kv_fsdp_spec``. Every arch at full width
on abstract trees — the port's on ``torch.device("meta")``, the
reference's by ``jax.eval_shape`` — on the production ``(16, 16)`` and
``(2, 16, 16)`` abstract meshes, ``kv_fsdp`` off and on:

* each port spec is the reference's with the stacked layer entry
  dropped (the port keeps one leaf per layer);
* the reference's divisibility and > 90 %-sharded-bytes checks, and no
  leaf over 64 MiB replicated;
* ZeRO-1 moment bytes per device equal the reference's, leaf by leaf,
  except the per-layer SSD vectors named in ``ZERO1_LAYER_AXIS``: the
  reference shards those over ``data`` on the stacked layer axis (32 and
  64 layers), which a per-layer leaf lacks, and none of their own dims
  divides 16;
* decode-state and batch specs equal, entry for entry;
* ``input_specs`` equal shapes for every arch × shape and equal
  ``long_500k`` skips.
"""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config import SHAPES as J_SHAPES
from repro.config import get_arch as j_get_arch
from repro.config import shape_applicable as j_shape_applicable
from repro.configs import ARCH_IDS
from repro.launch import shardings as J
from repro.launch.mesh import make_abstract_mesh as j_abstract_mesh
from repro.launch.specs import abstract_params as j_abstract_params
from repro.launch.specs import abstract_state as j_abstract_state
from repro.launch.specs import input_specs as j_input_specs
from repro.models import build as j_build
from repro.optim.adamw import init_opt as j_init_opt
from repro_torch.config import SHAPES, get_arch, shape_applicable
from repro_torch.launch import shardings as T
from repro_torch.launch.mesh import axis_sizes, make_abstract_mesh
from repro_torch.launch.specs import abstract_params, abstract_state, input_specs
from repro_torch.models import build
from repro_torch.optim import init_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_LAYER = re.compile(r"^((?:mu/|nu/)?(?:layers|enc_layers|dec_layers))/\d+/")
_SSD_VECTORS = ("a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "norm")
# Per-device moment bytes (reference, port) of the leaves where the
# reference's ZeRO-1 takes the stacked layer axis and the port's
# per-layer leaf has no dim that divides the data axis: the same on both
# meshes (the pod axis takes no moment).
ZERO1_LAYER_AXIS = {
    "hymba-1.5b": {"a_log": (400, 6400), "conv_b": (1600, 25600), "conv_w": (6400, 102400),
                   "d_skip": (400, 6400), "dt_bias": (400, 6400), "norm": (1600, 25600)},
    "mamba2-2.7b": {"a_log": (80, 1280), "conv_b": (5120, 81920), "conv_w": (20480, 327680),
                    "d_skip": (80, 1280), "dt_bias": (80, 1280), "norm": (5120, 81920)},
}


def _meshes(name):
    shape, axes = MESHES[name]
    return j_abstract_mesh(shape, axes), make_abstract_mesh(shape, axes)


_cache = {}


def _trees(arch):
    """(reference params, reference opt state, port params, port opt
    state), abstract, built once per arch."""
    if arch not in _cache:
        jp = j_abstract_params(j_build(j_get_arch(arch)))
        pp = abstract_params(build(get_arch(arch)))
        _cache[arch] = (jp, jax.eval_shape(j_init_opt, jp), pp, init_opt(pp))
    return _cache[arch]


def _j_paths(tree):
    """``{path: leaf}`` of a reference tree (leaves: arrays or shardings)."""
    out = {}
    J.tree_path_map(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _j_specs(fn, tree):
    return {p: (fn(p, leaf), leaf) for p, leaf in _j_paths(tree).items()}


def _ref_path(path):
    return _LAYER.sub(r"\1/", path)


def _bytes_per_device(shape, spec, sizes, itemsize):
    n = int(np.prod(shape)) * itemsize
    for entry in spec:
        for axis in entry if isinstance(entry, tuple) else (entry,):
            if axis is not None:
                n //= sizes[axis]
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references_without_the_layer_entry(arch, mesh):
    jm, pm = _meshes(mesh)
    jp, _, pp, _ = _trees(arch)
    j_cfg, cfg = j_get_arch(arch), get_arch(arch)
    sizes = axis_sizes(pm)
    for kv_fsdp in (False, True):
        ref = _j_specs(lambda p, leaf: J.param_spec(p, leaf, j_cfg, jm, kv_fsdp=kv_fsdp), jp)
        leaves = T.tree_path_map(lambda _, leaf: leaf, pp)
        got = {p: (s.spec, leaves[p])
               for p, s in T.param_shardings(pp, cfg, pm, kv_fsdp=kv_fsdp).items()}
        assert {_ref_path(p) for p in got} == set(ref)
        sharded = total = 0.0
        for path, (spec, leaf) in got.items():
            rspec, rleaf = ref[_ref_path(path)]
            rspec = tuple(rspec) + (None,) * (rleaf.ndim - len(tuple(rspec)))
            if _ref_path(path) != path:
                assert rspec[0] is None and tuple(rleaf.shape[1:]) == tuple(leaf.shape), path
                rspec = rspec[1:]
            assert tuple(spec) + (None,) * (leaf.ndim - len(spec)) == rspec, (path, spec, rspec)
            for dim, axis in enumerate(spec):  # divisible, as the reference's test holds
                if axis is not None:
                    assert leaf.shape[dim] % sizes[axis] == 0, (path, dim, axis)
            b = float(leaf.numel())
            total += b
            sharded += b if any(a is not None for a in spec) else 0.0
            if leaf.numel() * 2 > 64 * 2**20:
                assert any(a is not None for a in spec), f"{path} replicated"
        assert sharded / total > 0.9


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_moment_bytes_per_device(arch, mesh):
    jm, pm = _meshes(mesh)
    jp, jo, pp, po = _trees(arch)
    sizes = axis_sizes(pm)
    ref_specs = _j_paths(J.opt_shardings(jo, jp, j_get_arch(arch), jm))
    ref = {p: _bytes_per_device(leaf.shape, tuple(ref_specs[p].spec), sizes, leaf.dtype.itemsize)
           for p, leaf in _j_paths(jo).items() if p != "step"}
    leaves = T.tree_path_map(lambda _, leaf: leaf, po)
    got = {}
    for path, sh in T.opt_shardings(po, pp, get_arch(arch), pm).items():
        leaf = leaves[path]
        if path == "step":
            assert tuple(sh.spec) == ()
            continue
        key = _ref_path(path)
        got[key] = got.get(key, 0) + _bytes_per_device(tuple(leaf.shape), tuple(sh.spec),
                                                       sizes, leaf.element_size())
    assert set(got) == set(ref)
    listed = ZERO1_LAYER_AXIS.get(arch, {})
    for key, ref_bytes in ref.items():
        name = key.rsplit("/", 1)[-1]
        if "/ssm/" in key and name in listed:
            assert (ref_bytes, got[key]) == listed[name], key
        else:
            assert got[key] == ref_bytes, key
    assert all(n in _SSD_VECTORS for n in listed)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_and_batch_specs(arch):
    j_cfg, cfg = j_get_arch(arch), get_arch(arch)
    for mesh in MESHES:
        jm, pm = _meshes(mesh)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            batch = input_specs(arch, name)
            jbatch = j_input_specs(arch, name)
            rb = {p: tuple(s.spec) for p, s in _j_paths(J.batch_shardings(jbatch, jm)).items()}
            assert {p: tuple(s.spec) for p, s in T.batch_shardings(batch, pm).items()} == rb
            if shape.kind != "decode":
                continue
            jstate = j_abstract_state(j_build(j_cfg), j_cfg, J_SHAPES[name])
            state = abstract_state(build(cfg), cfg, shape)
            rs = {p: tuple(s.spec) for p, s in
                  _j_paths(J.decode_state_shardings(jstate, j_cfg, jm)).items()}
            got = {p: tuple(s.spec) for p, s in T.decode_state_shardings(state, cfg, pm).items()}
            assert got == rs, (arch, name, mesh)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_cells(arch, shape):
    cfg = get_arch(arch)
    ok, why = shape_applicable(cfg, SHAPES[shape])
    assert (ok, why) == j_shape_applicable(j_get_arch(arch), J_SHAPES[shape])
    specs = input_specs(arch, shape)
    ref = j_input_specs(arch, shape)
    assert set(specs) == set(ref)
    for k, t in specs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape), k
        assert str(t.dtype).rsplit(".", 1)[-1] == str(ref[k].dtype), k


def test_long500k_skips():
    skips = [a for a in ARCH_IDS if not shape_applicable(get_arch(a), SHAPES["long_500k"])[0]]
    refs = [a for a in ARCH_IDS
            if not j_shape_applicable(j_get_arch(a), J_SHAPES["long_500k"])[0]]
    assert skips == refs and "granite-20b" in skips and "qwen3-1.7b" in skips


def test_kv_fsdp_spec():
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    cfg = get_arch("granite-20b")  # kv=1 — can't head-shard
    leaf = torch.empty((6144, 1, 128), dtype=torch.bfloat16, device="meta")
    base = T.param_spec("layers/0/attn/wk", leaf, cfg, mesh)
    opt = T.param_spec("layers/0/attn/wk", leaf, cfg, mesh, kv_fsdp=True)
    assert base[0] == "model"  # row-parallel baseline
    assert opt[0] == "data"  # FSDP-style weight sharding


def test_abstract_trees_allocate_nothing():
    params = abstract_params(build(get_arch("llava-next-34b")))
    assert {p.device.type for p in params.parameters()} == {"meta"}
    assert sum(p.numel() for p in params.parameters()) > 30e9


def test_mesh_factories_are_lazy():
    """Importing the launch layer starts no process group and no CUDA."""
    code = ("import sys, torch, torch.distributed as dist\n"
            "import repro_torch.launch, repro_torch.launch.mesh, repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun, repro_torch.roofline\n"
            "print(dist.is_initialized(), torch.cuda.is_initialized())")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert out.stdout.strip() == "False False"
    assert not dist.is_initialized()


def test_the_driver_runs_on_a_group_it_starts(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` without a
    launcher: a gloo group of one rank on a file store, a (1, 1) mesh,
    the reference's last line; the group is gone afterwards."""
    from repro_torch.launch.train import main

    main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "2", "--seq", "16", "--batch", "2",
          "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("mesh {'data': 1, 'model': 1} — loss ") and "over 2 steps" in line
    assert not dist.is_initialized()
