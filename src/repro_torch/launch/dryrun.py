"""Multi-pod dry-run: count one step of every (arch × shape × mesh) cell.

Proves, without the cards, that the distribution config is coherent: a
``"fake"`` process group of the mesh's world (256 ranks on the
single-pod 16×16 mesh, 512 on the multi-pod 2×16×16 one), every weight,
optimizer moment, batch and cache a meta tensor placed by the sharding
rules, and the cell's step run once under
:func:`~repro_torch.roofline.step_costs` as rank 0. Meta tensors carry
shapes and no storage, so a full-width step allocates nothing; the fake
group's collectives move nothing.

The counts are per device. The reference extrapolates from 1- and
2-layer compiles because XLA's cost analysis counts a scan body once;
the port's eager run executes every layer, so it runs at full depth and
extrapolates nothing (``raw_fullL`` holds the same counts). The step's
time is not a compile time: ``compile_s`` is the seconds of the counted
run. ``memory`` holds the argument and output bytes per device, from the
local shard shapes; the port has no counterpart of XLA's temporary
buffers, so ``temp_bytes_per_device`` is absent, not 0.

Each cell of ``main`` runs in a process of its own, with a time limit
(CELL_TIMEOUT_S). Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all            # every cell, both meshes
    python -m repro_torch.launch.dryrun --all --single-pod-only
Artifacts land in artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.config import SHAPES, TrainConfig, get_arch, shape_applicable
from repro_torch.configs import ARCH_IDS
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.launch.shardings import (
    batch_shardings,
    decode_state_shardings,
    opt_shardings,
    param_shardings,
    place,
    tree_path_map,
)
from repro_torch.launch.specs import StepBundle, make_step_bundle
from repro_torch.models.moe import MeshCtx
from repro_torch.roofline.analysis import model_flops, roofline_terms, step_costs

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")

OPTS = (
    "kv_fsdp", "chunked_attn", "vocab_pad", "remat_none", "microbatch4",
    "act_anchor", "moe_sort", "moe_a2a", "ssm_chunk64",
)

_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}
# Seconds a cell of ``main`` may take, in a process of its own: a cell
# that hangs (DTensor planning the redistribution of a layout no per-shard
# path covers) is recorded as an error, not waited for.
CELL_TIMEOUT_S = 900


def _apply_opts(cfg, opts: set):
    """Beyond-paper §Perf knobs applied to an (arch, shape) cell."""
    kw = {}
    if "chunked_attn" in opts:
        kw["chunked_attn"] = True
    if "vocab_pad" in opts:
        kw["vocab_pad_to"] = 256
    if "act_anchor" in opts:
        kw["act_anchor"] = True
    if "moe_sort" in opts:
        kw["moe_sort_dispatch"] = True
    if "moe_a2a" in opts:
        kw["moe_a2a"] = True
    if "ssm_chunk64" in opts:
        kw["ssm_chunk"] = 64
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _train_cfg_opts(train_cfg, opts: set):
    tc = train_cfg or TrainConfig(remat="dots")
    if "remat_none" in opts:
        tc = dataclasses.replace(tc, remat="none")
    if "microbatch4" in opts:
        tc = dataclasses.replace(tc, microbatches=4)
    return tc


def _placed_args(bundle: StepBundle, cfg, mesh, *, kv_fsdp: bool = False) -> Tuple:
    """The bundle's stand-ins placed on the mesh by the sharding rules."""
    if bundle.kind == "train":
        params, opt, batch, rng = bundle.args
        return (
            place(params, param_shardings(params, cfg, mesh, kv_fsdp=kv_fsdp)),
            place(opt, opt_shardings(opt, params, cfg, mesh, kv_fsdp=kv_fsdp)),
            place(batch, batch_shardings(batch, mesh)),
            rng,
        )
    if bundle.kind == "prefill":
        params, batch = bundle.args
        return (
            place(params, param_shardings(params, cfg, mesh, kv_fsdp=kv_fsdp)),
            place(batch, batch_shardings(batch, mesh)),
        )
    params, tokens, state = bundle.args
    return (
        place(params, param_shardings(params, cfg, mesh, kv_fsdp=kv_fsdp)),
        place({"tokens": tokens}, batch_shardings({"tokens": tokens}, mesh))["tokens"],
        place(state, decode_state_shardings(state, cfg, mesh)),
    )


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (rank 0's)."""
    total = 0
    for leaf in tree_path_map(lambda _, leaf: leaf, tree).values():
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def _mesh_name(shape: Tuple[int, ...], multi_pod: bool, production: bool) -> str:
    if production:
        return "pod2x16x16" if multi_pod else "pod16x16"
    return "mesh" + "x".join(str(n) for n in shape)


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    train_cfg: Optional[TrainConfig] = None,
    save: bool = True,
    tag: str = "",
    opts: Optional[set] = None,
    reduced: bool = False,
    mesh_shape: Optional[Tuple[int, ...]] = None,
) -> dict:
    """One cell on the production mesh (``multi_pod`` picks which), or on
    a mesh of ``mesh_shape`` with the same axis names (``reduced`` cuts
    the arch to its smoke size; both for tests). Starts a fake group of
    the mesh's world and destroys it before returning; a group already
    running is an error."""
    opts = opts or set()
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = _apply_opts(cfg, opts)
    train_cfg = _train_cfg_opts(train_cfg, opts)
    shape = SHAPES[shape_name]
    prod_shape, axes = _PRODUCTION[multi_pod]
    mshape = tuple(mesh_shape) if mesh_shape else prod_shape
    if len(mshape) != len(axes):
        raise ValueError(f"a {'multi' if multi_pod else 'single'}-pod mesh has axes {axes}, "
                         f"not the shape {mshape}")
    mesh_name = _mesh_name(mshape, multi_pod, mesh_shape is None)
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
            "opts": sorted(opts)}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        cell.update(status="skipped", reason=why)
        if save:
            _save(cell)
        return cell

    from torch.testing._internal.distributed.fake_pg import FakeStore

    chips = 1
    for n in mshape:
        chips *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=chips)
    t0 = time.monotonic()
    try:
        mesh = init_device_mesh("cpu", mshape, mesh_dim_names=axes)
        ctx = MeshCtx(mesh, batch_axes_of(mesh))
        kv_fsdp = "kv_fsdp" in opts
        bundle = make_step_bundle(cfg, shape, ctx, train_cfg)
        args = _placed_args(bundle, cfg, mesh, kv_fsdp=kv_fsdp)
        t_run = time.monotonic()
        costs, coll, out = step_costs(bundle.step_fn, *args)
        run_s = time.monotonic() - t_run
        flops_dev = costs["flops"]
        bytes_dev = costs["bytes accessed"]
        coll_dev = coll.wire_bytes
        mem = {
            "argument_bytes_per_device": _local_bytes(args),
            "output_bytes_per_device": _local_bytes(out),
        }
        terms = roofline_terms(
            hlo_flops=flops_dev,
            hlo_bytes=bytes_dev,
            collective_bytes=coll_dev,
            chips=1,  # the counts are per device; rates are per chip
            cfg=cfg,
            shape=shape,
            mflops=model_flops(cfg, shape) / chips,
        )
        cell.update(
            status="ok",
            kind=bundle.kind,
            chips=chips,
            compile_s=round(run_s, 2),
            setup_s=round(t_run - t0, 2),
            flops_per_device=flops_dev,
            bytes_per_device=bytes_dev,
            collective_bytes_per_device=coll_dev,
            raw_fullL={"flops": flops_dev, "bytes": bytes_dev, "coll": coll_dev},
            collective_breakdown=coll.bytes_by_op,
            collective_counts=coll.count_by_op,
            memory=mem,
            compute_term_s=terms.compute_s,
            memory_term_s=terms.memory_s,
            collective_term_s=terms.collective_s,
            dominant=terms.dominant,
            model_flops_global=model_flops(cfg, shape),
            useful_flop_ratio=terms.useful_flop_ratio,
            mfu=terms.mfu,
        )
    except Exception as e:  # a failure here is a bug in our system: recorded
        cell.update(
            status="error",
            error=f"{type(e).__name__}: {e}",
            trace=traceback.format_exc()[-2000:],
        )
    finally:
        dist.destroy_process_group()
    if save:
        _save(cell)
    return cell


def _save(cell: dict) -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    suffix = f"__{cell['tag']}" if cell.get("tag") else ""
    name = f"{cell['arch']}__{cell['shape']}__{cell['mesh']}{suffix}.json"
    with open(os.path.join(ARTIFACT_DIR, name), "w") as f:
        json.dump(cell, f, indent=1)


def _cell_in_child(arch: str, shape: str, multi_pod: bool, tag: str, opts: list) -> dict:
    """``run_cell`` in a fresh interpreter, killed after CELL_TIMEOUT_S."""
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            "a = json.loads(sys.argv[1])\n"
            "cell = dryrun.run_cell(a['arch'], a['shape'], multi_pod=a['multi_pod'], "
            "tag=a['tag'], opts=set(a['opts']))\n"
            "print(json.dumps(cell))")
    arg = json.dumps({"arch": arch, "shape": shape, "multi_pod": multi_pod, "tag": tag,
                      "opts": opts})
    try:
        out = subprocess.run([sys.executable, "-c", code, arg], capture_output=True, text=True,
                             timeout=CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        cell = {"arch": arch, "shape": shape, "mesh": "pod2x16x16" if multi_pod else "pod16x16",
                "tag": tag, "opts": sorted(opts), "status": "error",
                "error": f"TimeoutError: no result in {CELL_TIMEOUT_S} s"}
        _save(cell)
        return cell
    if out.returncode:
        raise RuntimeError(f"the dry-run of {arch} {shape} died: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", action="append", default=[], choices=list(OPTS),
                    help="enable a §Perf optimization (repeatable)")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if args.multi_pod or args.all or args.multi_pod_only:
        if not args.single_pod_only:
            meshes.append(True)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                suffix = f"__{args.tag}" if args.tag else ""
                path = os.path.join(
                    ARTIFACT_DIR, f"{arch}__{shape}__{mesh_name}{suffix}.json"
                )
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {arch} {shape} {mesh_name}")
                    continue
                cell = _cell_in_child(arch, shape, mp, args.tag, list(args.opt))
                status = cell["status"]
                extra = (
                    f"dom={cell.get('dominant')} mfu={cell.get('mfu', 0):.3f} "
                    f"run={cell.get('compile_s')}s"
                    if status == "ok"
                    else cell.get("reason", cell.get("error", ""))[:120]
                )
                print(f"[{status}] {arch} {shape} {mesh_name}: {extra}", flush=True)


if __name__ == "__main__":
    main()
