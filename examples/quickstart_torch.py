"""Quickstart on the PyTorch port: train a tiny LM on the synthetic Markov
stream, checkpoint it, and greedy-decode a few tokens — the port's
counterpart of ``examples/quickstart.py``. It runs on the card unless
asked for the CPU:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig, get_arch
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import build
from repro_torch.serve import greedy_generate
from repro_torch.train import TrainLoop, make_train_step


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the card)")
    args = parser.parse_args()
    device = resolve_device(args.device)

    cfg = get_arch("qwen3-1.7b").reduced()  # same family, CPU-sized
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)

    tc = TrainConfig(total_steps=30, warmup_steps=3, learning_rate=1e-2,
                     checkpoint_every=10)
    step_fn = make_train_step(model, tc)
    dc = DataConfig(cfg.vocab_size, seq_len=64, global_batch=8, seed=0)

    def batch_fn(step: int):
        return {"tokens": SyntheticStream(dc, start_step=step).batch_at(step)}

    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, keep=2)
        loop = TrainLoop(step_fn, batch_fn, tc, ckpt=ckpt)
        res = loop.run(params, num_steps=30)
        first, last = res.metrics_history[0], res.metrics_history[-1]
        print(f"loss: {first['loss']:.3f} -> {last['loss']:.3f} "
              f"({len(res.metrics_history)} steps, {res.restarts} restarts, on {device}; "
              f"checkpoints at steps {ckpt.all_steps()})")

        prompts = batch_fn(999)["tokens"][:2, :8]
        out = greedy_generate(model, res.params, prompts, max_new=8)
        print("generated:", out.tolist())


if __name__ == "__main__":
    main()
