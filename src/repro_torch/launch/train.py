"""Mesh-aware training driver.

The step the dry-run counts, executed for real on the running process
group: a ``(data, model)`` ``DeviceMesh``, the weights and the optimizer
state placed as DTensors by the sharding rules, the batches sharded over
``data``, and the fault-tolerant :class:`~repro_torch.train.TrainLoop`
with checkpoints.

On the card (NCCL, one rank per card; one rank when no launcher set the
group up)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 8

On the CPU, four gloo ranks of a (2, 2) mesh::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-1.7b --reduced --data 2 --model 2 --steps 4 --seq 32 \\
      --batch 4 --device cpu

Without torchrun's environment the driver starts a group of one rank on
a ``file://`` store in a temporary directory, and destroys it at the
end. As in the reference, :class:`TrainLoop` builds its own optimizer
state, whose moments take the weights' placements
(``src/repro/launch/train.py`` places a ZeRO-1 state by ``opt_shardings``
and leaves it unused); the driver does not build that unused state,
which for uncut qwen3-1.7b in float32 is 13.8 GB of moments.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ArchConfig, TrainConfig, get_arch
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch.mesh import axis_sizes, batch_axes_of, make_test_mesh
from repro_torch.launch.shardings import batch_shardings, param_shardings, place
from repro_torch.models import MeshCtx, build
from repro_torch.models.common import Params
from repro_torch.train import TrainLoop, TrainResult, make_train_step

__all__ = ["main", "train", "process_group"]


@contextlib.contextmanager
def process_group(device: torch.device) -> Iterator[None]:
    """The process group to train in: the running one if any; torchrun's
    (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` in the environment), or
    else one rank on a ``file://`` store in a temporary directory — NCCL
    on the card, gloo on the CPU. A group this function started is
    destroyed when the block ends."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"file://{os.path.join(d, 'store')}",
                                    world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def train(
    cfg: ArchConfig,
    mesh,
    *,
    steps: int = 20,
    seq: int = 64,
    batch: int = 8,
    ckpt_dir: Optional[str],
    device=None,
    params: Optional[Params] = None,
    learning_rate: float = 3e-3,
) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps on ``mesh`` (a ``DeviceMesh``
    named ``data`` / ``model`` over the running group), as the reference's
    driver: AdamW at ``learning_rate`` (the reference's 3e-3) with a warmup
    of a tenth of the steps, a checkpoint every half, ``SyntheticStream`` batches of ``batch`` ×
    ``seq`` tokens from seed 0. ``params`` are the whole weights on every
    rank (the model's init from seed 0 when omitted). Each rank of a group
    of more than one checkpoints into its own subdirectory of
    ``ckpt_dir`` (a checkpoint holds whole leaves, so any one restores on
    any mesh); ``ckpt_dir=None`` runs the loop without checkpoints (a
    whole float32 tree of qwen3-1.7b and its moments is 20.7 GB a save)."""
    device = resolve_device(device)
    ctx = MeshCtx(mesh, batch_axes_of(mesh))
    model = build(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    params = place(params, param_shardings(params, cfg, mesh))

    tc = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1),
                     learning_rate=learning_rate, checkpoint_every=max(steps // 2, 1))
    step = make_train_step(model, tc, ctx)
    dc = DataConfig(cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)

    def batch_fn(s: int):
        return {"tokens": SyntheticStream(dc, start_step=s).batch_at(s)}

    def to_device(b):
        b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        return place(b, batch_shardings(b, mesh))

    ckpt = None
    if ckpt_dir is not None:
        if dist.get_world_size() > 1:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{dist.get_rank()}")
        ckpt = CheckpointManager(ckpt_dir, keep=2)
    loop = TrainLoop(step, batch_fn, tc, ckpt=ckpt, to_device=to_device)
    return loop.run(params, num_steps=steps)  # the loop's own optimizer state


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_launch_train"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    with process_group(device):
        mesh = make_test_mesh(args.data, args.model, device_type=device.type)
        res = train(cfg, mesh, steps=args.steps, seq=args.seq, batch=args.batch,
                    ckpt_dir=args.ckpt_dir, device=device)
        hist = res.metrics_history
        if dist.get_rank() == 0:
            print(f"mesh {axis_sizes(mesh)} — loss {hist[0]['loss']:.4f} -> "
                  f"{hist[-1]['loss']:.4f} over {len(hist)} steps")


if __name__ == "__main__":
    main()
