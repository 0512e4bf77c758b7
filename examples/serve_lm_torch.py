"""Batched serving driver on the port, the counterpart of
``examples/serve_lm.py``: wave-scheduled greedy decoding over the
unified decode API, on the card unless asked for the CPU. It takes every
architecture; as in the reference, the engine's waves carry tokens only,
so the encoder-decoder family (seamless-m4t-medium), whose decode state
starts from encoder frames, ends in ``KeyError: 'frontend_embeds'``
(``greedy_generate(frontend_embeds=...)`` serves it).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-2.7b --requests 6
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import get_arch
from repro_torch.configs import ARCH_IDS
from repro_torch.models import build
from repro_torch.serve import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()  # small, same family
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)

    eng = ServeEngine(model, params, batch_slots=args.slots, max_len=64, device=device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, 4 + rid % 5).astype(np.int32)
        eng.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    eng.run_until_drained()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in eng.completed)
    print(f"{args.arch} ({cfg.family}): {len(eng.completed)} requests, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s, {eng.ticks} engine ticks) on {device}")
    for r in sorted(eng.completed, key=lambda r: r.rid)[:4]:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} out={r.out}")


if __name__ == "__main__":
    main()
