"""End-to-end LM training driver with fault tolerance, on the port — the
counterpart of ``examples/train_lm.py``, on the card unless asked for
the CPU.

Presets:
  tiny  (default) — ~3M params, 100 steps.
  100m            — ~100M-param qwen3-family config, a few hundred steps.

    PYTHONPATH=src python examples/train_lm_torch.py --preset tiny --steps 100

Checkpoints go to ``--ckpt-dir``, or to a temporary directory removed at
the end when none is given.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig, get_arch
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import build
from repro_torch.models.common import count_params
from repro_torch.runtime import FaultInjector
from repro_torch.train import TrainLoop, make_train_step


def preset_cfg(name: str):
    base = get_arch("qwen3-1.7b")
    if name == "tiny":
        return dataclasses.replace(
            base.reduced(), num_layers=4, d_model=128, d_ff=512, vocab_size=1024,
        ), 64, 8
    if name == "100m":
        # ~100M params: 12L, d=768, ff=2304, vocab=32k (tied embeddings).
        return dataclasses.replace(
            base, name="qwen3-100m", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2304,
            vocab_size=32768, dtype="float32",
        ), 512, 8
    raise ValueError(name)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--inject-fault-at", type=int, default=-1,
                    help="simulate a worker failure at this step")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg, seq_len, batch = preset_cfg(args.preset)
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    print(f"{cfg.name}: {count_params(params)/1e6:.1f}M params, "
          f"seq={seq_len} batch={batch} steps={args.steps} on {device}")

    tc = TrainConfig(total_steps=args.steps, warmup_steps=max(args.steps // 20, 1),
                     learning_rate=3e-3, checkpoint_every=max(args.steps // 5, 1))
    step_fn = make_train_step(model, tc)
    dc = DataConfig(cfg.vocab_size, seq_len=seq_len, global_batch=batch, seed=0)

    def batch_fn(step: int):
        return {"tokens": torch.as_tensor(SyntheticStream(dc, start_step=step).batch_at(step),
                                          device=device)}

    with tempfile.TemporaryDirectory() as scratch:
        ckpt_dir = args.ckpt_dir or scratch
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt = CheckpointManager(ckpt_dir, keep=3)
        faults = (FaultInjector(schedule={args.inject_fault_at: 0})
                  if args.inject_fault_at >= 0 else None)
        loop = TrainLoop(step_fn, batch_fn, tc, ckpt=ckpt, fault_injector=faults)
        res = loop.run(params, num_steps=args.steps)

    hist = res.metrics_history
    for h in hist[:: max(len(hist) // 10, 1)]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  {h['sec']*1e3:.0f} ms")
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(restarts={res.restarts}, stragglers={res.straggler_steps})")


if __name__ == "__main__":
    main()
