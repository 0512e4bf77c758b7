#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which stops the run with a non-zero exit when it fails:

1. **card** — the device's name and count, and ``nvidia-smi``'s name and
   power limit;
2. **build** — the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``bell_spmm``, ``gmm``, ``flash_attention``, ``cg_update``, ``gather_rows``), all ``nvcc`` processes
   started together, with ``-Xptxas -v``'s registers and spills, each
   line after the name of its kernel;
3. **main path** — ``distribute`` → ``spmv`` → ``solve`` at the repo's
   headline scale config (banded 60,000 × 60,000 with 1.2 M non-zeros,
   ``Topology(4, 4)``, ``NL-HC``, block 16, seed 0) for the replicated,
   selective and ``overlap:2`` exchanges, held against the float64 CSR
   ``reference`` executor; each kernel's launch counter, set to 0 just
   before a path runs, must have risen on it, only on variants that
   ``spmm_variant`` names for its tiles (``ring`` at B up to 3, ``stream``
   past it), and the device-loop CG must have run the fused update
   (``cg_update``) once an iteration, one call within 1e-6 of
   ``cg_update_plain`` on the loop's first state and two calls bitwise,
   and its solve within 1e-6 of the same loop with the plain update
   (residuals within 1e-9); the exchange's gather (``gather_rows``) must
   have run once a product selective, K times under overlap:K, never
   replicated, and on the session's own step, for each exchange and
   each batch width, bitwise ``gather_rows_plain`` with its zero slots
   zero and two launches bitwise;
4. **serve** — the serving path on the main path's sessions (nothing
   re-planned), for each exchange: one ``SparseServeEngine``
   (``batch_slots`` 8, 20 iterations, ``A`` as ``a`` and the SPD matrix
   as ``spd``) serves 64 requests from 4 tenants, made from ``--seed``
   (pagerank with sparse seeds and spmv on ``a``, jacobi and cg on
   ``spd``), ticked until drained; every result must be bitwise its
   direct batched-of-1 solve on the same session, the B = 8 spmv's
   columns bitwise the B = 1 spmv, one request per solver within 1e-4 of
   the float64 CSR oracle's direct solve, every ``bell_spmm`` launch
   ``ring`` or ``stream``, and the same requests through a ``ServeDriver`` thread
   bitwise the same; it prints the tick wall time and its split between
   the spmv calls and the steppers' host arithmetic, one lane step's
   time by solver, the device time (CUDA events around each lane step's
   spmv), the device's idle share, requests per second against the 64
   direct solves in sequence, latency, and peak device memory;
5. **plans** — the plan store, ``update`` and the linter on the main
   path's sessions (nothing planned twice, a ``TemporaryDirectory`` for
   the archives): each exchange saved (v2) and loaded lazily on the card,
   its first spmv timed beside its planning time in ``[main]`` and its
   B = 1 and B = 8 spmv bitwise the planned session's, likewise an eager
   load and a v1 archive (replicated); ``distribute(cache_dir=...)``'s
   miss, memo hit and disk hit, bitwise; a value-only delta of 12,000
   existing entries and a structural one of 6,000 in-band inserts and
   6,000 deletes, made from ``--seed``, patched (forced, with what the
   patch-or-replan rule would decide printed) on every exchange, each
   patched spmv bitwise a cold ``pack_units`` session on the same
   assignment and within 1e-5 of the float64 oracle, and one forced
   replan (replicated); a ``SparseServeEngine`` over a graph registered
   by path (16 requests bitwise their direct solves), ``update_graph``
   with lanes in flight (old lanes bitwise the old session, later
   requests the new), and a warm pool of one session alternating two
   path graphs, the evicted session collected and its device memory
   released; ``verify("strict")`` on a loaded session,
   ``verify("full")`` on a patched one and ``python -m
   repro_torch.analysis`` over the directory, each without a finding.
   Every ``bell_spmm`` launch of the phase must be ``ring`` or ``stream``;
6. **faults** — the fault-tolerance runtime on the replicated and
   selective sessions (overlap:2's update replans, at every replay): per
   exchange an engine under a ``recovery_dir`` in a temporary directory
   checkpoints both graphs, journals one ``update_graph`` of the
   ``[plans]`` value delta and serves 32 requests of the ``[serve]``
   mix; then, on engines over the updated graphs, a ``FaultInjector``
   kill at a mid-tick and at a post-refill point, a heartbeat death
   (``mark_unit_silent``), a straggler demotion through
   ``latency_probe``, and a kill between the archive write and the
   marker commit of a second ``checkpoint_graph``: every run bitwise the
   uninterrupted one with every ticket terminal once, the sessions from
   before a recovery collected; it prints each recovery's seconds by
   part (the last good generation's load, the journal replay, the remap
   round trip, the steppers' rebuild), a rebuilt session's first spmv,
   ``checkpoint_graph`` seconds, requests/s with and without the fault
   and the device memory allocated after recovery. Every ``bell_spmm``
   launch must be ``ring`` or ``stream``;
7. **dist** — the ``shard_map`` executor on an NCCL process group of one
   rank (a file store in a temporary directory), all 16 units stacked on
   it, on the three sessions at B = 1 / 8 / 64: within 1e-5 of the
   float64 oracle, its difference from ``simulate`` and whether it is
   bitwise, whether column b is bitwise the B = 1 spmv (printed, not
   checked), the recorded schedule equal to ``golden_signature``, every
   ``bell_spmm`` launch ``ring`` or ``stream``, and the device time by CUDA events
   beside ``simulate``'s. The cross-card traffic of 4 ranks stays
   unverified on one card;
8. **lm kernels** — the other two kernels on their own entry points at
   the full width of the repo's language-model configs: the MoE expert
   FFN of granite-moe-1b-a400m (``plan_groups`` → gather → three
   ``grouped_matmul`` calls, bf16 and f32), its causal prefill
   attention, and h2o-danube-1.8b's sliding-window prefill (``mha``),
   the attention in bf16 and f32, each held against its plain version
   (bf16 attention also to 2⁻⁶·|ref| + 2e-3 elementwise); each launch
   counter, set to 0 just before its path, must have risen on it, and
   so must the per-variant counts of the ``wgmma`` variants (bf16) and
   of the register-blocked ones (f32), never those of ``simt`` (nor of
   ``mma`` for attention);
9. **lm serve** — the language-model serving path (``repro_torch.models``,
   ``repro_torch.serve.engine``), which calls no kernel of the port (the
   three launch counters, set to 0 at its start, must stay 0): each
   family at ``.reduced()`` size in float32 (qwen3-1.7b, h2o-danube-1.8b
   over a ring that wraps twice, mamba2-2.7b, hymba-1.5b, llava-next-34b
   with frontend embeddings, seamless-m4t-medium over encoder frames),
   the same weights on the CPU and, through
   ``lm_to_numpy`` → ``lm_from_numpy``, on the card: forward and every
   decode step within 1e-5 of the CPU's; then qwen3-1.7b at full width
   (28 layers, d_model 2048, vocab 151,936), weights from ``--seed`` on
   the card: teacher-forced forward against step-by-step decode on 2
   prompts of 64 tokens, within 1e-4 in float32 (bf16 printed, with its
   top-1 agreement with float32); then ``ServeEngine(batch_slots=8,
   max_len=256)`` in bf16 over 16 requests of 16–128 prompt tokens from
   ``SyntheticStream`` and ``--seed``, 32 new tokens each (2 waves),
   printing tick wall, prompt-only against generating ticks, generated
   tokens/s, requests/s, time to first token, the device's busy time
   per tick by ``torch.profiler`` and its idle share, the decode step's
   byte bound and device memory; last a check wave of 8 equal prompts
   of 16 tokens through an engine of ``max_len`` 48 (``greedy_generate``'s
   cache length), every request bitwise ``greedy_generate`` on the same
   batch, and its agreement with batch-1 ``greedy_generate`` printed as
   a measurement; then seamless-m4t-medium at full width (12 encoder
   and 12 decoder layers, d_model 1024, vocab 256,206), weights from
   ``--seed``: float32 forward against step-by-step decode on 2 prompts
   of 64 tokens over 128 frames of ``frontend_stub``, within 1e-4; bf16
   ``greedy_generate`` of 8 prompts of 16 tokens over 128 frames, 32 new
   tokens each (the encode time, the decode step's wall p50 and the
   generated tokens/s printed); and the LM ``ServeEngine``, whose
   tokens-only wave must raise the reference's
   ``KeyError('frontend_embeds')`` on this family;
10. **lm train** — the training path (``repro_torch.optim``,
   ``repro_torch.train``, ``repro_torch.checkpoint``, the MoE family),
   which calls no kernel of the port (the three launch counters, set to 0
   at its start, must stay 0): one train step of each family at
   ``.reduced()`` size in float32 (the six of ``[lm serve]``,
   granite-moe-1b-a400m and moonshot-v1-16b-a3b) on the card against the
   CPU on the same weights, the loss within 1e-5 relative and each
   gradient leaf within 1e-4 of its max |g| (the worst printed); on
   qwen3 and granite-moe, remat ``"full"`` and ``"dots"`` bitwise
   ``"none"`` and two microbatches against one; then qwen3-1.7b and
   granite-moe-1b-a400m uncut in bf16, weights from ``--seed``, on
   ``SyntheticStream`` batches of 4 × 512 tokens under each remat mode:
   the step split into forward, backward and optimizer by CUDA events,
   tokens/s, model FLOPs utilisation (6 · active parameters · tokens
   over the step time and 989 TFLOP/s, recomputation not counted), peak
   memory; finite loss and gradient norm, the loss falling over 10
   steps, granite's aux loss and share of tokens dropped at capacity;
   seamless-m4t-medium uncut in bf16 the same way on ``make_batch``'s 4 ×
   512 tokens with 128 frames, 10 steps under remat ``"none"`` and 10
   under ``"full"``, the loss falling under each, its
   MFU over 6 · (encoder parameters · frames + decoder-and-head
   parameters · tokens); then ``TrainLoop`` with a ``CheckpointManager`` in a temporary
   directory on both (reduced, float32): two uninterrupted runs bitwise
   equal and a run with a failure at step 5 bitwise them, one restart;
   last a checkpoint of qwen3-1.7b at full width cut to 2 layers (about
   4.9 GB of npz): a blocking save, a restore (bitwise), an async save
   and the stall it puts on the next step;
11. **launch** — the launch layer (``repro_torch.launch``,
   ``repro_torch.roofline``), which calls no kernel of the port (the three
   launch counters, set to 0 at its start, must stay 0): on a one-rank
   NCCL ``(data, model) = (1, 1)`` mesh (a file store), qwen3-1.7b and
   granite-moe-1b-a400m (``moe_a2a`` and ``act_anchor`` on) uncut in
   float32, weights from ``--seed``: step one's loss and gradients on the
   mesh within 1e-5 / 1e-4 of the meshless step (bitwise or not printed),
   then 8 steps of the meshless step and of the driver's ``train`` at its
   8 x 64 tokens (granite at ``[lm train]``'s learning rate: at the
   driver's 3e-3 its loss rises), the step wall p50 of each printed and
   the loss on step 0's batch falling; the driver with its checkpoints at
   reduced size, a second run on the directory restoring the last one
   bitwise (uncut, a float32 tree and its moments is 20.7 GB a save);
   ``reshard_tree`` with ``P("model")`` and ``elastic_restart`` from a
   checkpoint, bitwise; the dry-run of qwen3-1.7b ``train_4k`` on the
   production 16 x 16 mesh (a fake group of 256 ranks, meta tensors) in a
   process of its own with its own time limit, its terms on the card's
   constants; and ``step_costs`` of ``[lm train]``'s bf16 qwen3 step, its
   compute and memory terms beside the step time ``[lm train]`` measured;
12. **times** — each kernel's time per launch at its path's shapes
   (CUDA events), its bound, its plain version's time, one PyTorch
   library call computing the same function, the earlier variants' times
   at the same shapes (the kernels of the previous slices, compared within
   the run: ``stream`` and ``simt`` for ``bell_spmm``, ``simt`` and for
   bf16 attention ``mma``); ``ring`` beside ``stream`` at B = 1, 2, 3
   (``ring``'s widths), and ``stream`` at 4, 8 and 64, on the banded plan,
   each time with its bound and share and the two bitwise equal, and on
   its float16 tiles at B = 1 and 8; the spmv wall
   time and peak device memory per exchange, the
   shares of the replicated spmv's device time taken by the kernel and by
   the unit sum (beside the ``cumsum`` it replaced, and whether the two
   are bitwise equal), every exchange's spmv at each B inside the train
   step's ``deterministic()`` block bitwise the same spmv outside it, and
   — a measurement, not a check — whether column j of the replicated
   spmv at B = 64 is bitwise the B = 1 spmv.

Then one JSON line with the kernels' numbers, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. With no CUDA device the
script exits non-zero before printing any result.

Each kernel against its plain version over a sweep of shapes and types
is ``tests/test_torch_gpu.py``'s, and the benchmark's CG problem (HPCG's
27-point stencil at 64³) is ``portbench/run.py``'s ``hpcg64-cg-b1``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# benchmarks/bench_partition.py: SCALE_CONFIG — the repo's headline scale.
SCALE_CONFIG = {"n": 60_000, "nnz": 1_200_000, "topology": (4, 4),
                "combo": "NL-HC", "block": 16, "seed": 0}
EXCHANGES = ("replicated", "selective", "overlap:2")
SPMV_BATCHES = (1, 8, 64)
# [times]'s ring-beside-stream widths.
RING_TIME_BATCHES = (1, 2, 3, 4, 8, 64)
# Tolerance relative to the result's scale: max |y - y_ref| / max |y_ref|.
TOL_F32 = 1e-5  # kernel vs plain, and spmv vs the float64 CSR oracle
# Published peaks of one H100 SXM (NVIDIA data sheet, at 700 W): HBM
# bytes/s, float32 FLOP/s outside the tensor cores, and dense bf16 FLOP/s
# on the tensor cores — repro_torch.roofline.hw's, the one copy of them.
from repro_torch.roofline.hw import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.roofline.hw import PEAK_FLOPS_BF16 as PEAK_BF16_FLOPS  # noqa: E402
from repro_torch.roofline.hw import PEAK_FLOPS_F32 as PEAK_F32_FLOPS  # noqa: E402
from repro_torch.roofline.hw import LINK_BW  # noqa: E402
# The reference tests' tolerances, as rtol and atol: tests/test_kernels_gmm.py
# and tests/test_kernels_attn.py.
GMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
# The [plans] phase's deltas: 1 % of the main path's non-zeros given new
# values, and half as many inserts within the band plus as many deletes.
PLAN_VALUE_EDITS = 12_000
PLAN_STRUCT_EDITS = 6_000
# The [serve] phase: BENCH_serve.json's batch_slots and iters, 64 requests
# from 4 tenants.
SERVE_SLOTS = 8
SERVE_ITERS = 20
SERVE_REQUESTS = 64
SERVE_TENANTS = 4
# The [faults] phase: 32 requests of the [serve] mix on two exchanges. On
# overlap:2 the [plans] value delta touches 35 % of the tiles and the rule
# replans (8 s), again at every journal replay.
FAULT_REQUESTS = 32
FAULT_EXCHANGES = ("replicated", "selective")
# bf16 attention on the [lm attn] path: two bf16 ulps of the result plus a
# floor, elementwise, against the plain version with the kernel's tiles.
ATTN_BF16_REL, ATTN_BF16_ABS = 2.0**-6, 2e-3
# src/repro/configs/granite_moe_1b_a400m.py: d_model 1024, 16 heads (8 kv
# heads), head_dim 64, moe_d_ff 512, 32 experts, top-8. Four sequences of
# 4096 tokens; one layer's experts, random weights from a seed.
GRANITE = {"d_model": 1024, "heads": 16, "kv_heads": 8, "head_dim": 64,
           "moe_d_ff": 512, "experts": 32, "top_k": 8, "batch": 4, "seq": 4096}
# src/repro/configs/h2o_danube_1_8b.py: 32 heads (8 kv heads), head_dim 80,
# sliding window 4096. One sequence of 8192 tokens.
H2O = {"heads": 32, "kv_heads": 8, "head_dim": 80, "window": 4096, "batch": 1,
       "seq": 8192}
GMM_BM = 128
ATTN_TILE = 128  # bq = bkv
# The [lm serve] phase. Card against CPU: each family of the LM serving path
# at .reduced() size in float32, the sequence lengths of
# tests/test_torch_lm_models.py (h2o's 40 positions wrap its ring of window
# + 1 = 17 slots twice; hymba's 24 reach past its window of 16).
LM_FAMILIES = (("qwen3-1.7b", 16), ("h2o-danube-1.8b", 40), ("mamba2-2.7b", 16),
               ("hymba-1.5b", 24), ("llava-next-34b", 16), ("seamless-m4t-medium", 16))
LM_TOL_CARD = 1e-5  # card vs CPU, max |d| / max |logit|
# Full width: src/repro/configs/qwen3_1_7b.py, all 28 layers, random weights
# from --seed; forward against step-by-step decode on 2 prompts of 64 tokens
# (tests/test_models_smoke.py:68-86 checks the same property).
LM_ARCH = "qwen3-1.7b"
LM_PROMPTS, LM_PROMPT_LEN = 2, 64
LM_TOL_F32 = 1e-4  # forward vs decode, max |d| / max |logit|, float32
# The engine, bf16: 16 requests of 16-128 prompt tokens and 32 new tokens
# through 8 slots (2 waves). Then a check wave of 8 equal prompts of 16
# tokens through an engine whose max_len is 16 + 32, so that its cache has
# greedy_generate's length: the same shapes, the same arithmetic.
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 8, 256, 16, 32
LM_PROMPT_RANGE = (16, 128)
LM_CHECK_LEN = 16
LM_PROFILED_TICKS = 3
# The encoder-decoder family at full width: src/repro/configs/seamless_m4t_medium.py
# uncut (12 + 12 layers, d_model 1024, vocab 256,206), weights from --seed;
# forward against decode on LM_PROMPTS prompts of LM_PROMPT_LEN tokens over
# ENCDEC_FRAMES frames of frontend_stub, within LM_TOL_F32 in float32; then
# bf16 greedy_generate of ENCDEC_PROMPTS prompts of LM_CHECK_LEN tokens, LM_NEW
# new each. The LM ServeEngine must fail on the family as the reference's does.
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_FRAMES = 128
ENCDEC_PROMPTS = 8
# The [lm train] phase. Card against CPU: one train step of each family at
# .reduced() size in float32 (the [lm serve] families and both MoE ones).
LM_TRAIN_FAMILIES = LM_FAMILIES + (("granite-moe-1b-a400m", 16), ("moonshot-v1-16b-a3b", 16))
TRAIN_LOSS_TOL = 1e-5  # |card - CPU| / |CPU| of the loss
TRAIN_GRAD_TOL = 1e-4  # max |card - CPU| / max |CPU|, per gradient leaf
# Full width, bf16: src/repro/configs/qwen3_1_7b.py and granite_moe_1b_a400m.py
# uncut, weights from --seed, SyntheticStream batches of 4 x 512 tokens;
# TRAIN_STEPS steps under remat "none" (the loss must fall), steps 1 to
# TRAIN_TIMED timed by parts under each mode.
TRAIN_ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m")
# seamless-m4t-medium uncut in bf16 on make_batch's batches (4 x 512 tokens
# and 512 // 4 = 128 frames, its config having no frontend_len), TRAIN_STEPS
# steps under remat "none" and under "full", the loss falling under each
# ("dots" is the reference's "none" for this family).
TRAIN_ENCDEC_REMATS = ("none", "full")
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_TIMED = 10, 3
TRAIN_LR = 3e-4  # TrainConfig's default; at 1e-3 granite-moe's loss rose over 10 updates
# The checkpoint's cost: qwen3-1.7b at full width cut to 2 layers (the
# embedding's 311 M parameters dominate: about 4.9 GB of npz).
CKPT_LAYERS = 2
# The [launch] phase: repro_torch.launch on the card. The train driver at its
# defaults (src/repro/launch/train.py: 8 sequences of 64 tokens a step, lr
# 3e-3) for LAUNCH_STEPS steps on a one-rank NCCL (data, model) = (1, 1) mesh,
# each arch uncut, in float32 so that the train gates (TRAIN_LOSS_TOL,
# TRAIN_GRAD_TOL) hold step one against the meshless step, with the options
# named beside it. Uncut, the driver runs without checkpoints: a whole
# float32 tree with its moments is 20.7 GB (qwen3), four saves a run, some
# 83 GB of disk writes for a smoke run; its checkpoints run at .reduced() size
# (LAUNCH_CKPT_ARCH). granite-moe trains at [lm train]'s TRAIN_LR: at the
# driver's 3e-3 its loss on step 0's batch rose from 11.3902 to 12.5890 over
# the 8 steps on an H100 80GB HBM3 at 700 W, as [lm train] saw at 1e-3.
LAUNCH_ARCHS = (("qwen3-1.7b", {}, 3e-3),
                ("granite-moe-1b-a400m", {"moe_a2a": True, "act_anchor": True}, TRAIN_LR))
LAUNCH_STEPS, LAUNCH_SEQ, LAUNCH_BATCH = 8, 64, 8
LAUNCH_CKPT_ARCH = "qwen3-1.7b"
# The driver's LAUNCH_STEPS losses against the meshless steps' on the same
# weights and batches, max |mesh - meshless| / |meshless|: this gates the
# update on the mesh (clip, AdamW over DTensors), which step one's loss and
# gradients do not reach.
LAUNCH_LOSS_TOL = 2e-4
# Step one's updated leaves on the mesh against the meshless step's: the
# share of entries (of the whole tree) off by more than LAUNCH_UPDATE_ATOL
# times the step's lr. Not a max: Adam's first update is about lr times
# each gradient entry's sign, and an entry near 0 whose sign rounds the
# other way moves by 2 lr.
LAUNCH_UPDATE_ATOL, LAUNCH_UPDATE_SHARE = 1e-3, 1e-3
# The dry-run's cells on the production (16, 16) mesh (a fake group of 256
# ranks, meta tensors), in one process of their own with its own time
# limit: a train step, a decode step and the SSD's train step.
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"),
                ("mamba2-2.7b", "train_4k"))
DRYRUN_TIMEOUT_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def scaled_err(y: torch.Tensor, y_ref: torch.Tensor) -> float:
    """max |y - y_ref| / max |y_ref|: the kernel and its plain version sum
    in different orders (FMA against separate multiply and add), so their
    difference is held relative to the size of the result."""
    return float((y - y_ref).abs().max() / y_ref.abs().max().clamp(min=1e-30))


def allclose_err(y: torch.Tensor, y_ref: torch.Tensor, tol: float) -> tuple:
    """(max |y - y_ref|, whether |y - y_ref| <= tol + tol·|y_ref| everywhere):
    the reference tests' ``assert_allclose(rtol=tol, atol=tol)``."""
    diff = (y.float() - y_ref.float()).abs()
    ok = bool((diff <= tol + tol * y_ref.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card, by CUDA events around
    ``reps`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 1: card -----------------------------------------------------------


def phase_card() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[card] {name} x{count}; nvidia-smi: {smi}")
    log(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return {"name": name, "count": count, "smi": smi}


# -- phase 2: build ----------------------------------------------------------


def ptxas_usage(nvcc_log: str) -> list:
    """``-Xptxas -v``'s register and spill lines, each after the kernel it
    is about: the name and integer template arguments read from the
    mangled name (``attn_wgmma_kernel<64, 2>``)."""
    lines, kernel = [], "?"
    for ln in nvcc_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            name = entry.group(1)
            pos, ident = (3 if name.startswith("_ZN") else 2), name
            while pos < len(name) and name[pos].isdigit():  # <length><identifier> ...
                digits = re.match(r"\d+", name[pos:]).group()
                pos += len(digits)
                ident, pos = name[pos:pos + int(digits)], pos + int(digits)
            args = re.findall(r"Li(\d+)E", name)
            kind = ", bf16" if "nv_bfloat16" in name else ""
            kernel = ident + (f"<{', '.join(args)}{kind}>" if args or kind else "")
        elif "registers" in ln or "spill" in ln:
            lines.append(f"{kernel}: {ln.strip()}")
    return lines


def phase_build() -> None:
    from repro_torch.kernels.build import build

    t0 = time.perf_counter()
    libs = build(["bell_spmm", "gmm", "flash_attention", "cg_update", "gather_rows"])
    log(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log(f"[build] {lib.name}: nvcc {lib.seconds:.2f} s -> {os.path.basename(lib.path)}")
        for ln in ptxas_usage(lib.log):
            log(f"[build]   {ln}")


# -- bell_spmm by its C entry points ----------------------------------------


def spmm_launcher(variant: str, bt, xsrc) -> tuple:
    """``(launch, out)``: ``launch()`` runs one ``bell_spmm`` variant on the
    tile set and x into ``out`` by its C entry point, whichever the wrapper
    would choose at these shapes, its arguments built once, so that a
    timing loop of a short kernel measures the device and not Python."""
    from repro_torch.kernels.spmv.ops import _library

    u_n, t_n, bm, bn = bt.tiles.shape
    batch = int(xsrc.shape[3])
    out = torch.empty((u_n, bt.nrb, bm, batch), dtype=torch.float32, device=bt.tiles.device)
    ustride = 0 if xsrc.shape[0] == 1 else int(xsrc.shape[1]) * bn * batch
    name = "f16" if bt.tiles.dtype == torch.float16 else "f32"
    ptrs = (bt.tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(), xsrc.data_ptr())
    if variant == "ring":
        args = (*ptrs, bt.pieces.data_ptr(), out.data_ptr(), int(bt.pieces.shape[0]), u_n, t_n)
    elif variant == "stream":
        args = (*ptrs, bt.spans.data_ptr(), out.data_ptr(), int(bt.spans.shape[0]), t_n)
    else:
        args = (*ptrs, out.data_ptr(), u_n, t_n)
    fn = getattr(_library(), f"bell_spmm_{variant}_{name}")
    args = (*args, bt.nrb, bm, bn, batch, ustride, torch.cuda.current_stream().cuda_stream)

    def launch():
        rc = fn(*args)
        check(rc == 0, f"bell_spmm_{variant}_{name} launch failed ({rc})")

    return launch, out


def spmm_entry(variant: str, bt, xsrc) -> torch.Tensor:
    """One ``bell_spmm`` variant's result by its C entry point: the earlier
    variants, for the cross-variant checks and times."""
    launch, out = spmm_launcher(variant, bt, xsrc)
    launch()
    return out


# -- phase 3: main path ------------------------------------------------------


def spd_from(a):
    """A symmetric, strictly diagonally dominant (so SPD) matrix with the
    pattern of ``a + aᵀ`` plus the diagonal."""
    from repro_torch.sparse.formats import COO

    n = a.shape[0]
    diag = np.arange(n, dtype=np.int64)
    rows = np.concatenate([a.row, a.col]).astype(np.int64)
    cols = np.concatenate([a.col, a.row]).astype(np.int64)
    vals = np.concatenate([a.val, a.val]).astype(np.float64)
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    dom = np.bincount(rows, weights=np.abs(vals), minlength=n) + 1.0
    rows, cols = np.concatenate([rows, diag]), np.concatenate([cols, diag])
    vals = np.concatenate([vals, dom])
    key, inv = np.unique(rows * n + cols, return_inverse=True)
    summed = np.bincount(inv, weights=vals)
    return COO((n, n), (key // n).astype(np.int32), (key % n).astype(np.int32),
               summed.astype(np.float32))


def rel_err(y, y_ref) -> float:
    return float(np.abs(y - y_ref).max() / (np.abs(y_ref).max() + 1e-30))


def run_solves(sess, ref, seeds):
    """Every solver of the path on ``sess``, host loop and device loop,
    checked against each other and against the float64 CSR oracle's
    results ``ref``."""
    runs = {
        "power_iteration": {"iters": 20},
        "pagerank": {"iters": 20, "seeds": seeds},
    }
    for name, kw in runs.items():
        host = sess.solve(name, **kw)
        dev = sess.solve(name, device_loop=True, **kw)
        for res in (host, dev):
            check(np.isfinite(res.x).all() and res.x.shape == ref[name].x.shape,
                  f"{name}: non-finite or misshapen x")
            check(res.iters_run == ref[name].iters_run, f"{name}: iters_run")
            check(abs(res.value - ref[name].value) <= 1e-4 * abs(ref[name].value) + 1e-6,
                  f"{name}: value {res.value} vs reference {ref[name].value}")
            check(rel_err(res.x, ref[name].x) < 1e-4,
                  f"{name}: x off the reference by {rel_err(res.x, ref[name].x):.2e}")


def check_main_variants(by_variant: dict, launches: int, what: str) -> None:
    """Every ``bell_spmm`` launch of a path on the main path's tiles (float32,
    block 16) ran on a variant that ``spmm_variant`` names for them at some
    batch width (``ring`` at narrow B, ``stream`` past it), never ``simt``."""
    from repro_torch.kernels.spmv import spmm_variant

    block = SCALE_CONFIG["block"]
    named = {spmm_variant(torch.float32, block, block, b) for b in range(1, 65)}
    check(launches > 0 and sum(by_variant[v] for v in named) == launches,
          f"{what} ran a bell_spmm variant that spmm_variant does not name for its tiles "
          f"({sorted(named)}): {by_variant}")


def check_cg_update(sess, b: np.ndarray, fused, what: str, **kw) -> None:
    """CG's fused update against its plain version on ``sess``'s device
    loop: one call on the loop's first state within 1e-6 of the plain
    update (rs within 1e-12) and two calls bitwise equal; the fused solve
    ``fused`` (``b``, ``**kw``) within 1e-6 of the solve with the plain
    update in its place in ``repro_torch.api.solvers``, the residuals
    within 1e-9."""
    import repro_torch.api.solvers as solvers
    from repro_torch.kernels.spmv.cg_update import cg_buffers, cg_update, cg_update_plain

    mv = sess.device_spmm()
    bt = torch.as_tensor(b, device=sess.device)
    z = torch.zeros_like(bt)
    r = bt - mv(z)
    rs = (r.double() * r.double()).sum(dim=-1)
    ap = mv(r)
    want, got, again = (cg_buffers(z.clone(), r.clone(), r.clone(), rs, 1) for _ in range(3))
    cg_update_plain(want, ap, 1)
    cg_update(got, ap, 1)
    cg_update(again, ap, 1)
    call_err = 0.0
    for name in ("z", "r", "p"):
        check(torch.equal(getattr(got, name), getattr(again, name)),
              f"{what}: two cg_update calls differ in {name}")
        err = scaled_err(getattr(got, name), getattr(want, name))
        check(err <= 1e-6, f"{what}: cg_update's {name} off the plain update by {err:.2e}")
        call_err = max(call_err, err)
    rs_err = float((got.rs[1] / want.rs[1] - 1.0).abs().max())
    check(rs_err <= 1e-12, f"{what}: cg_update's rs off the plain update by {rs_err:.2e}")
    solvers.cg_update = cg_update_plain
    try:
        plain = sess.solve("cg", b=b, device_loop=True, **kw)
    finally:
        solvers.cg_update = cg_update
    err = rel_err(fused.x, plain.x)
    check(err < 1e-6, f"{what}: fused cg x off the plain update's by {err:.2e}")
    res_err = float(np.max(np.abs(np.asarray(fused.residuals) / np.asarray(plain.residuals) - 1)))
    check(len(fused.residuals) == len(plain.residuals) and res_err <= 1e-9,
          f"{what}: fused cg residuals off the plain update's by {res_err:.2e}")
    log(f"[main] {what}: cg_update one call within {call_err:.2e} of plain, rs "
        f"{rs_err:.2e}, two calls bitwise; solve x {err:.2e}, residuals {res_err:.2e}")


def check_exchange_gather(sess, xs: dict, what: str) -> None:
    """The exchange's gather (``gather_rows``) against its plain version
    on the session's own step: for each of its exchanges (one selective,
    one a wave under overlap) and each batch width in ``xs``, the padded
    x gathered by the step's composed index bitwise
    ``gather_rows_plain``'s, its −1 slots zero, two launches bitwise."""
    from repro_torch.kernels.spmv.gather import gather_rows, gather_rows_plain
    from repro_torch.pmvc.dist import make_simulate_fn, pad_x

    dp = sess.device_plan
    step = make_simulate_fn(dp, sess.selective, device=sess.device,
                            transform=sess.tile_transform)
    check(bool(step.exchanges) and all(ex.composed for ex in step.exchanges),
          f"{what}: the one-device step did not compose its exchange")
    zeros = 0
    for b, x in xs.items():
        x4 = pad_x(torch.as_tensor(x, device=sess.device), dp.num_col_blocks, dp.bn)
        for k, ex in enumerate(step.exchanges):
            got, again = gather_rows(x4, ex.index), gather_rows(x4, ex.index)
            want = gather_rows_plain(x4, ex.index)
            check(got.shape == want.shape and torch.equal(got, want),
                  f"{what}: gather_rows differs from the plain gather (B={b}, exchange {k})")
            check(torch.equal(got, again), f"{what}: two gather_rows launches differ (B={b})")
            zero = ex.index < 0
            check(not bool(got[zero].any()), f"{what}: a zero slot is not zero (B={b})")
            zeros += int(zero.sum())
    log(f"[main] {what}: gather_rows bitwise the plain gather on the step's "
        f"{len(step.exchanges)} index(es) [{', '.join(str(list(ex.index.shape)) for ex in step.exchanges)}] "
        f"at B={sorted(xs)}, {zeros} zero slot(s), two launches bitwise")


def phase_main_path(device) -> dict:
    from repro_torch.api import Topology, distribute
    from repro_torch.kernels.spmv import bell_spmm
    from repro_torch.kernels.spmv.cg_update import cg_update
    from repro_torch.kernels.spmv.gather import gather_rows
    from repro_torch.sparse.generate import banded_coo

    cfg = SCALE_CONFIG
    topo = Topology(*cfg["topology"])
    common = {"topology": topo, "combo": cfg["combo"], "block": cfg["block"],
              "seed": cfg["seed"]}
    a = banded_coo(cfg["n"], cfg["nnz"], seed=cfg["seed"])
    spd = spd_from(a)
    rng = np.random.default_rng(cfg["seed"])
    xs = {b: rng.standard_normal((b, a.shape[1])).astype(np.float32)
          for b in SPMV_BATCHES}
    seeds = (rng.random((8, a.shape[1])) < 1e-3).astype(np.float32)
    seeds[:, 0] = 1.0  # every row has mass
    b_cg = rng.standard_normal((4, spd.shape[0])).astype(np.float32)

    # The float64 CSR oracle, on the host: what every exchange is held to.
    t0 = time.perf_counter()
    ref_sess = distribute(a, exchange="replicated", executor="reference",
                          device=device, **common)
    y_ref = {b: ref_sess.spmv(x) for b, x in xs.items()}
    ref_solves = {
        "power_iteration": ref_sess.solve("power_iteration", iters=20),
        "pagerank": ref_sess.solve("pagerank", iters=20, seeds=seeds),
    }
    spd_ref = distribute(spd, exchange="replicated", executor="reference",
                         device=device, **common)
    cg_ref = spd_ref.solve("cg", iters=30, b=b_cg)
    log(f"[main] reference planning + oracle runs: {time.perf_counter() - t0:.1f} s")
    dp = ref_sess.device_plan
    log(f"[main] plan: tiles {list(dp.tiles.shape)}, real {int(dp.real_tiles.sum())}, "
        f"{dp.tiles.nbytes / 1e6:.1f} MB payload")

    out = {"launches": 0, "variant_launches": dict.fromkeys(bell_spmm.variant_launches, 0),
           "sessions": {}, "spd_sessions": {}, "plan_s": {}, "ref": ref_sess,
           "spd_ref": spd_ref}
    for ex in EXCHANGES:
        bell_spmm.launches = 0
        bell_spmm.variant_launches = dict.fromkeys(bell_spmm.variant_launches, 0)
        gather_rows.launches = 0
        t0 = time.perf_counter()
        sess = distribute(a, exchange=ex, **common)  # on the card by default
        t_plan_a = time.perf_counter() - t0
        spd_sess = distribute(spd, exchange=ex, **common)
        t_plan = time.perf_counter() - t0
        for b, x in xs.items():
            y = sess.spmv(x if b > 1 else x[0])
            y = y if b > 1 else y[None]
            check(y.shape == y_ref[b].shape and np.isfinite(y).all(),
                  f"{ex}: spmv B={b} misshapen or non-finite")
            err = rel_err(y, y_ref[b])
            check(err < TOL_F32, f"{ex}: spmv B={b} off the oracle by {err:.2e}")
            log(f"[main] {ex}: spmv B={b} rel err vs reference {err:.3e}")
        run_solves(sess, ref_solves, seeds)
        for device_loop in (False, True):
            fused_before = cg_update.launches
            res = spd_sess.solve("cg", iters=30, b=b_cg, device_loop=device_loop)
            check(np.isfinite(res.x).all() and res.iters_run == cg_ref.iters_run,
                  f"{ex}: cg device_loop={device_loop} iters or finiteness")
            fused = cg_update.launches - fused_before
            check(fused == (res.iters_run if device_loop else 0),
                  f"{ex}: cg device_loop={device_loop} ran the fused update {fused} times")
            err = rel_err(res.x, cg_ref.x)
            check(err < 1e-4, f"{ex}: cg device_loop={device_loop} x off by {err:.2e}")
            if device_loop:
                check_cg_update(spd_sess, b_cg, res, ex, iters=30)
        torch.cuda.synchronize()
        launches = bell_spmm.launches
        by_variant = dict(bell_spmm.variant_launches)
        check(launches > 0, f"{ex}: bell_spmm was never launched on the main path")
        check_main_variants(by_variant, launches, f"{ex}: the main path")
        # One gather a product's exchange: one a product selective (one
        # bell_spmm launch), K under overlap:K (1 + K launches).
        gathers = gather_rows.launches
        waves = getattr(sess.selective, "waves", 1) if sess.selective is not None else 0
        per = 1 + waves if ex.startswith("overlap") else 1  # bell_spmm launches a product
        products = launches // per
        check(launches % per == 0 and gathers == waves * products,
              f"{ex}: the exchange's gather ran {gathers} times for {products} products "
              f"({waves} a product expected)")
        if sess.selective is not None:
            check_exchange_gather(sess, xs, ex)
        log(f"[main] {ex}: planning {t_plan:.1f} s (A alone {t_plan_a:.2f} s), spmv + "
            f"power_iteration + pagerank + cg (host and device loops) ok; bell_spmm launches "
            f"{launches} {by_variant}; gather_rows launches {gathers}")
        out["launches"] += launches
        for v, c in by_variant.items():
            out["variant_launches"][v] += c
        out["sessions"][ex] = sess
        out["spd_sessions"][ex] = spd_sess
        out["plan_s"][ex] = t_plan_a
    return out


# -- phase 4: serve ----------------------------------------------------------


class DeviceClock:
    """Clocks on each spmv of the ``timed`` executor while ``on``: CUDA
    events around its device work (x on the card to y on the card, the
    span PERF.md §5 calls an spmv's device time, here with whatever gaps
    the host leaves between its launches), and the host clock around the
    whole call, copies in and out included."""

    def __init__(self):
        self.pairs = []
        self.wall_s = 0.0
        self.on = False

    def executor(self, session):
        """The ``simulate`` executor's spmv (the same closure, the same
        row-major copy out) with the clocks around it."""
        mv = session.device_spmm()

        def spmv(x):
            t0 = time.perf_counter()
            xt = torch.as_tensor(np.asarray(x, np.float32), device=session.device)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = mv(xt).contiguous()
            stop.record()
            out = y.cpu().numpy()
            if self.on:
                self.pairs.append((start, stop))
                self.wall_s += time.perf_counter() - t0
            return out

        return spmv

    def take(self) -> tuple:
        """(device ms, spmv wall ms) since the last take."""
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        wall_ms = self.wall_s * 1e3
        self.pairs, self.wall_s = [], 0.0
        return ms, wall_ms


def serve_requests(rng, n: int, count: int = SERVE_REQUESTS) -> list:
    """``count`` requests from SERVE_TENANTS tenants, a quarter each of
    pagerank with sparse seeds and spmv on ``a``, and jacobi and cg with
    random right-hand sides on ``spd``: (graph, solver, payload, tenant)."""
    kinds = (("a", "pagerank"), ("a", "spmv"), ("spd", "jacobi"), ("spd", "cg"))
    out = []
    for i in range(count):
        graph, solver = kinds[i % len(kinds)]
        if solver == "pagerank":
            seeds = (rng.random(n) < 1e-3).astype(np.float32)
            seeds[rng.integers(n)] = 1.0  # mass everywhere
            payload = {"seeds": seeds}
        elif solver == "spmv":
            payload = {"x": rng.standard_normal(n).astype(np.float32)}
        else:
            payload = {"b": rng.standard_normal(n).astype(np.float32)}
        out.append((graph, solver, payload, f"t{i % SERVE_TENANTS}"))
    return out


def direct_solve(sess, solver, payload):
    """The engine's parity reference: the direct batched-of-1 solve
    (tests/test_serve_sparse.py::_direct), x only."""
    if solver == "spmv":
        return sess.spmv(payload["x"][None])[0]
    kw = {k: v[None] for k, v in payload.items()}
    return sess.solve(solver, iters=SERVE_ITERS, **kw).x[0]


def lane_step_ms(graphs: dict, requests: list, clock: DeviceClock, reps: int = 5) -> dict:
    """Per solver, the host wall time of one step of a full stepper
    (SERVE_SLOTS slots, the requests' first payloads) and of its spmv call,
    in ms, the mean of ``reps`` steps after one untimed step."""
    out = {}
    for solver in ("pagerank", "spmv", "jacobi", "cg"):
        mine = [(g, p) for g, name, p, _ in requests if name == solver][:SERVE_SLOTS]
        stepper = graphs[mine[0][0]].batch_stepper(solver, SERVE_SLOTS)
        for slot, (_, payload) in enumerate(mine):
            stepper.load(slot, **payload)
        active = np.ones(SERVE_SLOTS, dtype=bool)
        stepper.step(active)
        clock.take()
        clock.on = True
        t0 = time.perf_counter()
        for _ in range(reps):
            stepper.step(active)
        wall = (time.perf_counter() - t0) / reps * 1e3
        clock.on = False
        out[solver] = (wall, clock.take()[1] / reps)
    return out


def phase_serve(main: dict, card: dict, seed: int) -> dict:
    from repro_torch.api import register_executor
    from repro_torch.kernels.spmv import bell_spmm
    from repro_torch.serve import ServeDriver, SparseServeEngine, Status

    clock = DeviceClock()
    register_executor("timed", clock.executor)
    where = card["smi"]
    n = main["ref"].matrix.shape[0]
    requests = serve_requests(np.random.default_rng(seed), n)
    # The float64 CSR oracle's direct solve, one request per solver.
    t0 = time.perf_counter()
    oracle = {}
    for i, (graph, solver, payload, _) in enumerate(requests):
        if solver not in {r[1] for r in oracle.values()}:
            ref = main["ref"] if graph == "a" else main["spd_ref"]
            oracle[i] = (direct_solve(ref, solver, payload), solver)
    log(f"[serve] oracle solves for {sorted(r[1] for r in oracle.values())}: "
        f"{time.perf_counter() - t0:.1f} s")

    out = {"launches": 0, "variant_launches": dict.fromkeys(bell_spmm.variant_launches, 0)}
    for ex in EXCHANGES:
        graphs = {"a": main["sessions"][ex].with_executor("timed"),
                  "spd": main["spd_sessions"][ex].with_executor("timed")}
        # pagerank's |A| link session hoists its tiles at its first spmv,
        # once per session: here, not inside the first timed tick.
        graphs["a"].solve("pagerank", iters=1)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()

        def engine():
            eng = SparseServeEngine(batch_slots=SERVE_SLOTS, default_iters=SERVE_ITERS,
                                    max_queue=SERVE_REQUESTS)
            for name, sess in graphs.items():
                eng.register_graph(name, sess)
            return eng

        def counted(what: str, run):
            """Run ``run`` with the launch counters set to 0 just before and
            read just after; every launch must be on a variant that
            ``spmm_variant`` names for the main path's tiles."""
            bell_spmm.launches = 0
            bell_spmm.variant_launches = dict.fromkeys(bell_spmm.variant_launches, 0)
            got = run()
            torch.cuda.synchronize()
            by_variant = dict(bell_spmm.variant_launches)
            check_main_variants(by_variant, bell_spmm.launches, f"{ex}: {what}")
            return got, by_variant

        # The engine, ticked here: wall time per tick, device time per lane step.
        def serve():
            eng = engine()
            clock.take()
            clock.on = True
            t0 = time.perf_counter()
            tickets = [eng.submit(g, solver, payload=p, tenant=t)
                       for g, solver, p, t in requests]
            ticks = []
            while eng.pending():
                check(len(ticks) < 10_000, f"{ex}: the engine did not drain")
                t1 = time.perf_counter()
                eng.step()
                ticks.append(time.perf_counter() - t1)
            wall = time.perf_counter() - t0
            clock.on = False
            return eng, tickets, ticks, wall, *clock.take()

        (eng, tickets, ticks, wall, device_ms, spmv_ms), by_variant = counted("the engine",
                                                                             serve)
        check(all(t.status is Status.DONE for t in tickets),
              f"{ex}: not every request reached DONE: "
              f"{sorted({t.status.value for t in tickets})}")
        snap = eng.metrics.snapshot()

        # Bitwise: every served result is its direct batched-of-1 solve, and
        # the spmv's columns at B = SERVE_SLOTS are the B = 1 spmv's.
        def compare():
            t0 = time.perf_counter()
            direct = [direct_solve(graphs[g], solver, p) for g, solver, p, _ in requests]
            seq_wall = time.perf_counter() - t0
            for t, x, (_, solver, _, _) in zip(tickets, direct, requests, strict=True):
                check(np.isfinite(t.result.x).all() and t.result.x.shape == (n,),
                      f"{ex}: ticket {t.tid} ({solver}) non-finite or misshapen")
                check(np.array_equal(t.result.x, x),
                      f"{ex}: ticket {t.tid} ({solver}) is not bitwise its direct solve")
            xs = np.random.default_rng(seed + 1).standard_normal((SERVE_SLOTS, n)).astype(
                np.float32)
            y = graphs["a"].spmv(xs)
            for j in range(SERVE_SLOTS):
                check(np.array_equal(y[j], graphs["a"].spmv(xs[j:j + 1])[0]),
                      f"{ex}: column {j} of the B={SERVE_SLOTS} spmv is not the B=1 spmv")
            return seq_wall

        seq_wall, _ = counted("the direct solves", compare)
        worst = 0.0
        for i, (x_ref, solver) in oracle.items():
            err = rel_err(tickets[i].result.x, x_ref)
            check(err < 1e-4, f"{ex}: served {solver} off the float64 oracle by {err:.2e}")
            worst = max(worst, err)

        # The same requests through a driver thread: the same results, bitwise.
        def drive():
            eng2 = engine()
            with ServeDriver(eng2):
                again = [eng2.submit(g, solver, payload=p, tenant=t)
                         for g, solver, p, t in requests]
                for t in again:
                    check(t.wait(600.0), f"{ex}: the driver never finished ticket {t.tid}")
            return again

        again, drv_variants = counted("the driver", drive)
        for first, second in zip(tickets, again, strict=True):
            check(second.status is Status.DONE and np.array_equal(first.result.x, second.result.x),
                  f"{ex}: ticket {second.tid} through the driver differs from the engine's")
        peak = torch.cuda.max_memory_allocated() / 2**20
        launches, drv_launches = sum(by_variant.values()), sum(drv_variants.values())
        by_solver, _ = counted("the lane-step timing",
                               lambda: lane_step_ms(graphs, requests, clock))

        tick_ms = np.asarray(ticks) * 1e3
        idle = 1.0 - device_ms / (wall * 1e3)
        rps, seq_rps = SERVE_REQUESTS / wall, SERVE_REQUESTS / seq_wall
        log(f"[serve] {ex}: {SERVE_REQUESTS} requests, {len(ticks)} ticks, "
            f"{snap['lane_steps']} lane steps (B={SERVE_SLOTS}), occupancy {snap['occupancy']}; "
            f"bell_spmm launches {launches} {by_variant}, driver run {drv_launches}; "
            f"every result bitwise its direct solve, the B={SERVE_SLOTS} spmv's columns "
            f"bitwise the B=1 spmv, the driver's results bitwise the engine's; worst served "
            f"vs float64 oracle {worst:.3e}")
        steps = snap["lane_steps"]
        log(f"[serve] {ex}: tick wall mean {tick_ms.mean():.3f} ms (p50 "
            f"{np.percentile(tick_ms, 50):.3f}, p99 {np.percentile(tick_ms, 99):.3f}, total "
            f"{wall * 1e3:.1f} ms); of the total, the spmv calls {spmv_ms:.1f} ms "
            f"({spmv_ms / steps:.4f} ms a lane step, copies in and out included) and the "
            f"steppers' host arithmetic with the scheduler {tick_ms.sum() - spmv_ms:.1f} ms "
            f"({(tick_ms.sum() - spmv_ms) / steps:.4f} ms a lane step); device {device_ms:.1f} "
            f"ms ({device_ms / steps:.4f} ms a lane step); device idle share {idle:.1%} "
            f"[{where}]")
        log(f"[serve] {ex}: one full lane step (B={SERVE_SLOTS}) by solver, wall ms (of it the "
            f"spmv call): " + ", ".join(f"{k} {w:.3f} ({m:.3f})" for k, (w, m) in by_solver.items())
            + f" [{where}]")
        log(f"[serve] {ex}: engine {rps:.1f} requests/s against {seq_rps:.1f} requests/s "
            f"for the {SERVE_REQUESTS} direct solves in sequence ({rps / seq_rps:.2f}x); "
            f"latency p50 {snap['total_p50_s'] * 1e3:.1f} ms, p99 "
            f"{snap['total_p99_s'] * 1e3:.1f} ms; peak device memory {peak:.0f} MiB "
            f"({resident:.0f} MiB resident before the phase) [{where}]")
        out["launches"] += launches + drv_launches
        for v in by_variant:
            out["variant_launches"][v] += by_variant[v] + drv_variants[v]
    return out


# -- phase 5: plans ----------------------------------------------------------


def plan_deltas(a, rng) -> tuple:
    """The [plans] phase's two deltas on ``a``: PLAN_VALUE_EDITS existing
    entries given new values, and PLAN_STRUCT_EDITS inserts within the
    band plus as many deletes of existing entries."""
    from repro_torch.sparse.delta import SparseDelta

    n = a.shape[0]
    pick = rng.choice(a.nnz, PLAN_VALUE_EDITS + PLAN_STRUCT_EDITS, replace=False)
    val_idx, del_idx = pick[:PLAN_VALUE_EDITS], pick[PLAN_VALUE_EDITS:]
    value = SparseDelta.upserts(a.shape, a.row[val_idx], a.col[val_idx],
                                rng.standard_normal(val_idx.size).astype(np.float32))
    half = int(np.abs(a.row.astype(np.int64) - a.col).max())
    row = rng.integers(0, n, 4 * PLAN_STRUCT_EDITS)
    col = row + rng.integers(-half, half + 1, row.size)
    ok = (col >= 0) & (col < n)
    row, col = row[ok], col[ok]
    key = row * n + col
    fresh = ~np.isin(key, a.row.astype(np.int64) * n + a.col)
    _, first = np.unique(key, return_index=True)
    ins = np.intersect1d(np.nonzero(fresh)[0], first)[:PLAN_STRUCT_EDITS]
    check(ins.size == PLAN_STRUCT_EDITS, f"only {ins.size} free in-band coordinates")
    structural = SparseDelta.merge(
        a.shape, up_row=row[ins], up_col=col[ins],
        up_val=rng.standard_normal(ins.size).astype(np.float32),
        del_row=a.row[del_idx], del_col=a.col[del_idx])
    return value, structural


def timed(fn, *args, **kw):
    """(result, seconds) of ``fn(*args, **kw)`` on the host clock, the
    card drained before the clock stops."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_plans(main: dict, card: dict, seed: int, device) -> dict:
    import gc
    import tempfile
    import weakref

    from repro_torch.api import SparseSession, Topology, distribute, plancache
    from repro_torch.api.exchange import resolve_exchange
    from repro_torch.api.session import PATCH_DRIFT_LIMIT, PATCH_TOUCH_LIMIT
    from repro_torch.kernels.spmv import bell_spmm
    from repro_torch.pmvc.plan_device import pack_units
    from repro_torch.serve import SparseServeEngine, Status

    where = card["smi"]
    cfg = SCALE_CONFIG
    common = {"topology": Topology(*cfg["topology"]), "combo": cfg["combo"],
              "block": cfg["block"], "seed": cfg["seed"]}
    sessions = main["sessions"]
    a = sessions["replicated"].matrix
    n = a.shape[0]
    rng = np.random.default_rng(seed + 2)
    x1 = rng.standard_normal((1, n)).astype(np.float32)
    x8 = rng.standard_normal((8, n)).astype(np.float32)
    value_delta, struct_delta = plan_deltas(a, rng)

    def same(s, ref, what):
        for x in (x1, x8):
            check(np.array_equal(s.spmv(x), ref.spmv(x)),
                  f"{what}: spmv B={x.shape[0]} is not bitwise the reference session's")

    bell_spmm.launches = 0
    bell_spmm.variant_launches = dict.fromkeys(bell_spmm.variant_launches, 0)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        # save -> load, each exchange: v2, lazy, first spmv against planning.
        paths = {}
        for ex, sess in sessions.items():
            path, t_save = timed(sess.save, os.path.join(d, f"plan-{ex}.npz"))
            paths[ex] = path
            loaded, t_meta = timed(plancache.load_session, path)
            check(loaded.device == device and not loaded.is_materialized,
                  f"{ex}: the lazy load is not a lazy card session")
            _, t_first = timed(loaded.spmv, x1)
            same(loaded, sess, f"{ex} loaded")
            t_plan = main["plan_s"][ex]
            log(f"[plans] {ex}: save v2 {os.path.getsize(path) / 1e6:.1f} MB in {t_save:.2f} s; "
                f"lazy load: meta {t_meta * 1e3:.1f} ms, first spmv (materialize + hoist + "
                f"launch) {t_first:.2f} s, together {t_meta + t_first:.2f} s against planning "
                f"{t_plan:.2f} s ({t_plan / (t_meta + t_first):.1f}x); spmv B=1 and B=8 bitwise "
                f"the planned session's [{where}]")
        rep = sessions["replicated"]
        eager, t_eager = timed(plancache.load_session, paths["replicated"], lazy=False)
        check(eager.is_materialized, "lazy=False left a thunk")
        same(eager, rep, "replicated eager load")
        v1, t_v1save = timed(rep.save, os.path.join(d, "plan-replicated-v1.npz"),
                               format_version=1)
        v1s = plancache.load_session(v1)
        _, t_v1first = timed(v1s.spmv, x1)
        same(v1s, rep, "replicated v1 load")
        log(f"[plans] replicated: eager load {t_eager:.2f} s; v1 archive "
            f"{os.path.getsize(v1) / 1e6:.1f} MB saved in {t_v1save:.2f} s, lazy load to first "
            f"spmv {t_v1first:.2f} s; both bitwise [{where}]")

        # The cache layers in front of planning.
        cache = os.path.join(d, "cache")
        plancache.clear_memo()
        miss, t_miss = timed(distribute, a, exchange="replicated", cache_dir=cache, **common)
        check(len(os.listdir(cache)) == 1, "the miss wrote no archive")
        hit, t_hit = timed(distribute, a, exchange="replicated", cache_dir=cache, **common)
        check(hit.device_plan is miss.device_plan, "the memo hit is not the memoized plan")
        plancache.clear_memo()
        disk, t_disk = timed(distribute, a, exchange="replicated", cache_dir=cache, **common)
        check(not disk.is_materialized, "the disk hit planned instead of loading")
        _, t_disk_first = timed(disk.spmv, x1)
        same(disk, miss, "replicated disk hit")
        log(f"[plans] cache_dir: miss (plan + write) {t_miss:.2f} s, memo hit "
            f"{t_hit * 1e3:.2f} ms, disk hit {t_disk * 1e3:.1f} ms + first spmv "
            f"{t_disk_first:.2f} s, bitwise the miss's [{where}]")
        del miss, hit, disk
        plancache.clear_memo()

        # update at full width, both deltas, every exchange.
        patched_sel = None
        for ex, sess in sessions.items():
            for kind, delta in (("value", value_delta), ("structural", struct_delta)):
                # Forced: the rule replans a delta that touches more than
                # PATCH_TOUCH_LIMIT of the tiles, which the line reports.
                new, t_patch = timed(sess.update, delta, force="patch")
                r = new.update_report
                check(r.action == "patched" and r.structural == (kind == "structural"),
                      f"{ex} {kind}: {r}")
                rule = ("replan" if r.touched_fraction > PATCH_TOUCH_LIMIT
                        or r.t_model_patched > PATCH_DRIFT_LIMIT * r.t_model_baseline
                        else "patch")
                _, t_first = timed(new.spmv, x1)
                mutated = new.matrix
                dp = new.device_plan
                cold_dp = pack_units(mutated, new.partition.elem_unit, dp.num_units, dp.bm,
                                     dp.bn)
                cold = SparseSession(mutated, new.topology, new.partition, cold_dp,
                                     exchange=ex, selective=resolve_exchange(ex)(cold_dp),
                                     executor="simulate", device=device)
                same(new, cold, f"{ex} {kind} patch against the cold pack")
                y = new.spmv(x8)
                err = rel_err(y, new.spmv(x8, executor="reference"))
                check(err < TOL_F32, f"{ex} {kind}: patched spmv off the oracle by {err:.2e}")
                log(f"[plans] {ex}: {kind} delta ({delta.num_upserts} upserts, "
                    f"{delta.num_deletes} deletes): {r.action} on the host in {t_patch:.2f} s "
                    f"({r.touched_tiles}/{r.total_tiles} tiles touched, "
                    f"{r.touched_fraction:.2%}; modeled t_iter {r.t_model_patched:.4e} s against "
                    f"baseline {r.t_model_baseline:.4e} s; the unforced rule would {rule}), "
                    f"first spmv {t_first:.2f} s; bitwise the cold pack, {err:.2e} off the "
                    f"float64 oracle [{where}]")
                if ex == "selective" and kind == "structural":
                    patched_sel = new
                del new, cold
        replan, t_replan = timed(rep.update, struct_delta, force="replan")
        check(replan.update_report.action == "replanned", f"{replan.update_report}")
        err = rel_err(replan.spmv(x8), replan.spmv(x8, executor="reference"))
        check(err < TOL_F32, f"replicated replan off the oracle by {err:.2e}")
        log(f"[plans] replicated: forced replan of the structural delta {t_replan:.2f} s "
            f"(against the patch above), {err:.2e} off the float64 oracle [{where}]")
        del replan

        # The engine over graphs registered by path.
        def requests(count):
            out = []
            for i in range(count):
                if i % 2:
                    out.append(("spmv", {"x": rng.standard_normal(n).astype(np.float32)}))
                else:
                    seeds = (rng.random(n) < 1e-3).astype(np.float32)
                    seeds[rng.integers(n)] = 1.0
                    out.append(("pagerank", {"seeds": seeds}))
            return out

        eng = SparseServeEngine(batch_slots=SERVE_SLOTS, default_iters=SERVE_ITERS,
                                max_queue=64)
        eng.register_graph("g", paths["replicated"])
        reqs = requests(16)
        tickets = [eng.submit("g", s, payload=p) for s, p in reqs]
        _, t_serve = timed(eng.run_until_drained)
        for t, (s, p) in zip(tickets, reqs, strict=True):
            check(t.status is Status.DONE and np.array_equal(t.result.x, direct_solve(rep, s, p)),
                  f"path graph: ticket {t.tid} ({s}) is not bitwise its direct solve")
        old = eng._session("g")
        early_reqs, late_reqs = requests(8), requests(8)
        early = [eng.submit("g", s, payload=p) for s, p in early_reqs]
        eng.step()
        eng.step()
        report, t_upd = timed(eng.update_graph, "g", struct_delta)
        new = eng._session("g")
        check(new is not old and report.action == "patched", f"update_graph: {report}")
        late = [eng.submit("g", s, payload=p) for s, p in late_reqs]
        eng.run_until_drained()
        for tickets_, reqs_, sess_, what in ((early, early_reqs, old, "old"),
                                            (late, late_reqs, new, "new")):
            for t, (s, p) in zip(tickets_, reqs_, strict=True):
                check(t.status is Status.DONE
                      and np.array_equal(t.result.x, direct_solve(sess_, s, p)),
                      f"update_graph: ticket {t.tid} ({s}) is not bitwise the {what} session")
        log(f"[plans] engine: graph registered by path, 16 requests in {t_serve:.2f} s (lazy "
            f"hydration included), each bitwise its direct solve; update_graph with 8 in "
            f"flight {t_upd:.2f} s ({report.action}), the 8 in flight bitwise the old session, "
            f"the 8 after bitwise the new [{where}]")
        del eng, old, new, tickets, early, late

        # Warm pool of one: alternate two graphs, the evicted plan's tiles freed.
        limits = plancache.set_memo_limit()
        plancache.clear_memo()
        plancache.set_memo_limit(max_sessions=1)
        eng = SparseServeEngine(batch_slots=SERVE_SLOTS, default_iters=SERVE_ITERS,
                                max_queue=64)
        eng.register_graph("replicated", paths["replicated"])
        eng.register_graph("selective", paths["selective"])
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        held, resident = {}, []
        for i, name in enumerate(("replicated", "selective", "replicated", "selective")):
            reqs = requests(2)
            tickets = [eng.submit(name, s, payload=p) for s, p in reqs]
            eng.run_until_drained()
            for t, (s, p) in zip(tickets, reqs, strict=True):
                check(t.status is Status.DONE
                      and np.array_equal(t.result.x, direct_solve(sessions[name], s, p)),
                      f"warm pool: {name} ticket {t.tid} ({s}) not bitwise its direct solve")
            held[i] = weakref.ref(eng._session(name))
            del tickets
            gc.collect()
            torch.cuda.synchronize()
            resident.append((name, torch.cuda.memory_allocated() - base))
            if i:
                check(held[i - 1]() is None, f"switch {i}: the evicted session is still alive")
        one = resident[0][1]
        check(all(m < 1.5 * max(one, 1) for _, m in resident),
              f"device memory grew across switches: {resident}")
        log("[plans] warm pool of 1 session, two graphs by path alternated: device memory "
            "above the phase's base after each switch and gc.collect(): "
            + ", ".join(f"{nm} {m / 2**20:.0f} MiB" for nm, m in resident)
            + f"; every evicted session collected [{where}]")
        del eng
        plancache.set_memo_limit(**limits)
        plancache.clear_memo()

        # The linter: strict on a loaded session, full on a patched one, the CLI.
        rep_loaded = plancache.load_session(paths["replicated"])
        strict, t_strict = timed(rep_loaded.verify, "strict")
        full, t_full = timed(patched_sel.verify, "full")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        cli, t_cli = timed(
            subprocess.run, [sys.executable, "-m", "repro_torch.analysis", d],
            capture_output=True, text=True, env=env, timeout=600)
        check(cli.returncode == 0, f"python -m repro_torch.analysis: {cli.stdout}{cli.stderr}")
        summary = cli.stdout.strip().splitlines()[-1]
        log(f"[plans] linter: verify('strict') on a loaded session {t_strict:.2f} s "
            f"({len(strict.passes_run)} passes), verify('full') on a patched one {t_full:.2f} s "
            f"({len(full.passes_run)} passes), python -m repro_torch.analysis {t_cli:.2f} s "
            f"({summary}); no finding [{where}]")
    torch.cuda.synchronize()
    launches = bell_spmm.launches
    by_variant = dict(bell_spmm.variant_launches)
    check_main_variants(by_variant, launches, "[plans]")
    log(f"[plans] phase {time.perf_counter() - t_phase:.1f} s; bell_spmm launches {launches} "
        f"{by_variant}")
    return {"launches": launches, "variant_launches": by_variant, "value_delta": value_delta}


# -- phase 6: faults ---------------------------------------------------------


def phase_faults(main: dict, plans: dict, card: dict, seed: int) -> dict:
    import gc
    import tempfile
    import weakref

    from repro_torch.api import plancache
    from repro_torch.kernels.spmv import bell_spmm
    from repro_torch.runtime import FaultInjector, Heartbeat
    from repro_torch.serve import SparseServeEngine, Status

    where = card["smi"]
    units = main["sessions"]["replicated"].topology.units
    n = main["ref"].matrix.shape[0]
    requests = serve_requests(np.random.default_rng(seed + 3), n, FAULT_REQUESTS)
    x1 = np.random.default_rng(seed + 4).standard_normal((1, n)).astype(np.float32)

    def engine(graphs, d, **kw):
        eng = SparseServeEngine(batch_slots=SERVE_SLOTS, default_iters=SERVE_ITERS,
                                max_queue=64, recovery_dir=d, **kw)
        for name, sess in graphs.items():
            eng.register_graph(name, sess)
        return eng

    def serve(eng, before_tick=None):
        """The requests through ``eng``, ticked until drained: the tickets,
        the fault counter before each tick, the wall seconds."""
        tickets = [eng.submit(g, solver, payload=p, tenant=t) for g, solver, p, t in requests]
        starts = []
        t0 = time.perf_counter()
        while eng.pending():
            check(len(starts) < 10_000, "[faults] the engine did not drain")
            if before_tick is not None:
                before_tick(len(starts))
            starts.append(eng._fault_steps)
            eng.step()
        torch.cuda.synchronize()
        return tickets, starts, time.perf_counter() - t0

    def resident(eng) -> float:
        """Device MiB allocated with ``eng`` alive, after a collection."""
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() / 2**20

    bell_spmm.launches = 0
    bell_spmm.variant_launches = dict.fromkeys(bell_spmm.variant_launches, 0)
    t_phase = time.perf_counter()
    for ex in FAULT_EXCHANGES:
        a0, spd = main["sessions"][ex], main["spd_sessions"][ex]
        with tempfile.TemporaryDirectory() as d:
            # Each engine gets sessions of its own (shared host plans, cold
            # closure caches), so what a recovery leaves behind can be seen.
            eng = engine({"a": a0._derive(), "spd": spd._derive()}, d)
            _, t_ckpt_a = timed(eng.checkpoint_graph, "a")
            _, t_ckpt_spd = timed(eng.checkpoint_graph, "spd")
            report, t_upd = timed(eng.update_graph, "a", plans["value_delta"])
            base, starts, wall0 = serve(eng)
            check(all(t.status is Status.DONE for t in base), f"[faults] {ex}: uninterrupted run")
            mib0 = resident(eng)
            updated = eng._graphs["a"]._derive()  # the updated plan, its closures cold
            y_updated = updated._derive().spmv(x1)
            off = starts[0]  # the checkpoints' and the update's fault points
            del eng
            log(f"[faults] {ex}: checkpoint_graph a {t_ckpt_a:.2f} s, spd {t_ckpt_spd:.2f} s; "
                f"update_graph of the [plans] value delta {t_upd:.2f} s ({report.action}, "
                f"journaled); {FAULT_REQUESTS} requests uninterrupted in {wall0:.2f} s "
                f"({FAULT_REQUESTS / wall0:.1f} requests/s, {len(starts)} ticks), "
                f"{mib0:.0f} MiB allocated [{where}]")

            def fault_run(what, collected=True, before=None, tick=None, **kw):
                """Serve the requests on a fresh engine over the updated
                graphs with ``kw``'s fault wiring (``before(eng)`` first,
                ``tick(eng, i)`` before tick i); every result bitwise the
                uninterrupted run's, every ticket terminal once, and
                (``collected``: a recovery rebuilt its lanes) the sessions
                it started with collected."""
                graphs = {"a": updated._derive(), "spd": spd._derive()}
                old = [weakref.ref(g) for g in graphs.values()]
                eng = engine(graphs, d, **kw)
                del graphs
                if before is not None:
                    before(eng)
                got, _, wall = serve(eng, tick and (lambda i: tick(eng, i)))
                for t0, t1 in zip(base, got, strict=True):
                    check(t1.status is Status.DONE and t0.tid == t1.tid
                          and np.array_equal(t0.result.x, t1.result.x)
                          and t0.result.residuals == t1.result.residuals,
                          f"[faults] {ex} {what}: ticket {t1.tid} is not bitwise the "
                          f"uninterrupted run's ({t1.status}, {t1.error})")
                check(eng.metrics.completed == FAULT_REQUESTS and eng.recoveries >= 1,
                      f"[faults] {ex} {what}: completed {eng.metrics.completed}, "
                      f"recoveries {eng.recoveries}")
                mib = resident(eng)
                check(not collected or (all(r() is None for r in old)
                                        and mib < 1.25 * mib0 + 64),
                      f"[faults] {ex} {what}: the sessions before the recovery are still "
                      f"alive or resident memory grew ({mib:.0f} MiB against {mib0:.0f})")
                parts = ", ".join(
                    f"unit {r['unit']}: {r['total_s']:.2f} s (load {r['load_s']:.2f}, replay "
                    f"{r['replay_s']:.2f}, remap {r['remap_s']:.2f}, rebind {r['rebind_s']:.2f})"
                    for r in eng.recovery_log)
                log(f"[faults] {ex} {what}: bitwise the uninterrupted run, {eng.recoveries} "
                    f"recover{'y' if eng.recoveries == 1 else 'ies'} [{parts}]; "
                    f"{FAULT_REQUESTS / wall:.1f} requests/s with the fault, {mib:.0f} MiB "
                    f"allocated after it"
                    + (", every session before it collected" if collected else "")
                    + f" [{where}]")
                return eng

            # Kills at a mid-tick point (after the second lane's step of tick
            # 3) and at a post-refill point (tick 8); the rerun of the killed
            # tick passes its points again, which shifts the later ones.
            mid = starts[3] - off + 2
            check(starts[4] - starts[3] >= 3, f"[faults] {ex}: tick 3 ran too few lanes")
            post = starts[8] - off + (mid - (starts[3] - off) + 1)
            injector = FaultInjector(schedule={mid: 1, post: 2})
            eng = fault_run(f"kills at fault points {mid} (mid-tick) and {post} (post-refill)",
                            fault_injector=injector)
            check(injector.fired == [mid, post] and eng.dead_units == {1, 2},
                  f"[faults] {ex}: fired {injector.fired}, dead {eng.dead_units}")
            rebuilt = eng._graphs["a"]._derive()  # the rebuilt session, its closures cold
            del eng  # measure each run with no other engine alive
            _, t_first = timed(rebuilt.spmv, x1)
            check(np.array_equal(rebuilt.spmv(x1), y_updated),
                  f"[faults] {ex}: the rebuilt session is not bitwise the updated one")
            log(f"[faults] {ex}: first spmv of a rebuilt session (hoist + launch) "
                f"{t_first:.3f} s [{where}]")
            del rebuilt

            def silence(eng, tick):
                if tick == 2:
                    eng.mark_unit_silent(5)
                    time.sleep(0.1)

            eng = fault_run("heartbeat death of unit 5",
                            heartbeat=Heartbeat(units, timeout=0.05), tick=silence)
            check(eng.dead_units == {5}, f"[faults] {ex}: heartbeat dead {eng.dead_units}")
            del eng
            latency = {u: 1.0 for u in range(units)}

            def slow(eng, tick):
                if tick == 2:
                    latency[7] = 25.0

            eng = fault_run("straggler demotion of unit 7", latency_probe=lambda: dict(latency),
                            tick=slow)
            check(eng.dead_units == {7}, f"[faults] {ex}: straggler dead {eng.dead_units}")
            del eng
            gens = {}

            def second_checkpoint(eng):
                gens["gen"], gens["s"] = timed(eng.checkpoint_graph, "a")

            injector = FaultInjector(schedule={1: 3})  # between archive and marker commit
            # No lane is live at the kill, so the recovery rebuilds nothing.
            eng = fault_run("kill inside a second checkpoint_graph", collected=False,
                            fault_injector=injector, before=second_checkpoint)
            last = plancache.last_good_generation(d, "a")
            check(injector.fired == [1] and last == gens["gen"] > 0,
                  f"[faults] {ex}: checkpoint kill fired {injector.fired}, marker {last}, "
                  f"committed {gens['gen']}")
            log(f"[faults] {ex}: the killed checkpoint_graph left generation 0 committed, "
                f"recovered and committed generation {gens['gen']} in {gens['s']:.2f} s "
                f"[{where}]")
            del eng, updated
    torch.cuda.synchronize()
    launches = bell_spmm.launches
    by_variant = dict(bell_spmm.variant_launches)
    check_main_variants(by_variant, launches, "[faults]")
    log(f"[faults] phase {time.perf_counter() - t_phase:.1f} s; bell_spmm launches {launches} "
        f"{by_variant}")
    return {"launches": launches, "variant_launches": by_variant}


# -- phase 7: dist -----------------------------------------------------------


def phase_dist(main: dict, card: dict, device) -> dict:
    import tempfile

    import torch.distributed as dist

    from repro_torch.analysis import audit_session, golden_signature, schedule_signature
    from repro_torch.kernels.spmv import bell_spmm
    from repro_torch.pmvc.dist import Communicator, make_pmvc_step, make_unit_mesh, pad_x
    from repro_torch.pmvc.plan_device import OverlapPlan

    where = card["smi"]
    n = main["ref"].matrix.shape[0]
    rng = np.random.default_rng(5)
    xs = {b: rng.standard_normal((b, n)).astype(np.float32) for b in SPMV_BATCHES}
    y_ref = {b: main["ref"].spmv(x) for b, x in xs.items()}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(d, 'store')}",
                                world_size=1, rank=0)
        try:
            bell_spmm.launches = 0
            bell_spmm.variant_launches = dict.fromkeys(bell_spmm.variant_launches, 0)
            for ex, sess in main["sessions"].items():
                shard = sess._derive(executor="shard_map")  # its own closure cache
                dp = sess.device_plan
                for b, x in xs.items():
                    y = shard.spmv(x)
                    err = rel_err(y, y_ref[b])
                    check(y.shape == y_ref[b].shape and err < TOL_F32,
                          f"[dist] {ex}: shard_map B={b} off the oracle by {err:.2e}")
                    y_sim = sess.spmv(x)
                    cols = sum(np.array_equal(y[j], shard.spmv(x[j:j + 1])[0]) for j in range(b))
                    log(f"[dist] {ex}: shard_map B={b}: {err:.3e} off the float64 oracle; max "
                        f"|shard_map - simulate| {np.abs(y - y_sim).max():.3e} "
                        f"({'bitwise' if np.array_equal(y, y_sim) else 'not bitwise'}); "
                        f"{cols} of {b} columns bitwise the B=1 spmv")
                log_ = []
                step = make_pmvc_step(dp, make_unit_mesh(dp.num_units, comm=Communicator(log=log_)),
                                      selective=sess.selective, device=device)
                mv = sess.device_spmm()
                comm = Communicator()
                sp = sess.selective
                lanes = []  # the [U, U, L] schedule of each all_to_all
                if isinstance(sp, OverlapPlan):
                    lanes = [sp.wave_send_idx.shape[-1]] * sp.waves
                elif sp is not None:
                    lanes = [sp.send_idx.shape[-1]]
                u_n = dp.num_units
                times = []
                for b, x in xs.items():
                    xt = torch.as_tensor(x, device=device)
                    xb = pad_x(xt, dp.num_col_blocks, dp.bn)
                    log_.clear()
                    step(xb)
                    sig = schedule_signature(log_)
                    golden = golden_signature(ex, getattr(sp, "waves", 1))
                    check(sig == golden, f"[dist] {ex}: schedule {sig!r} is not {golden!r}")
                    # The collectives alone, at the step's message sizes.
                    y_like = torch.zeros((dp.num_row_blocks, dp.bm, b), device=device)
                    sends = [torch.zeros((1, u_n, u_n, ln, dp.bn, b), device=device)
                             for ln in lanes]
                    coll_ms = cuda_ms(lambda: comm.psum(y_like), 10) + sum(
                        cuda_ms(lambda t=t: comm.all_to_all(t)[1].wait(), 10) for t in sends)
                    times.append((b, cuda_ms(lambda: step(xb), 10), cuda_ms(lambda: mv(xt), 10),
                                  coll_ms))
                log(f"[dist] {ex}: recorded schedule {sig!r}, the golden one; device ms "
                    "(shard_map step on padded x / simulate spmv; the step's collectives "
                    "alone): "
                    + ", ".join(f"B={b} {s_ms:.4f} / {m_ms:.4f}; {c_ms:.4f} ({c_ms / s_ms:.0%})"
                                for b, s_ms, m_ms, c_ms in times)
                    + f" [{where}]")
                rep = audit_session(sess)  # on the session's device, the card
                check(rep.ok, f"[dist] {ex}: {rep}")
                del step, shard
            torch.cuda.synchronize()
            launches = bell_spmm.launches
            by_variant = dict(bell_spmm.variant_launches)
        finally:
            dist.destroy_process_group()
    check_main_variants(by_variant, launches, "[dist]")
    log("[dist] NCCL takes one rank per card: this run's group has one rank, all 16 units "
        "stacked on it; the cross-card traffic of 4 ranks is unverified until a machine has 4 "
        "cards")
    log(f"[dist] phase {time.perf_counter() - t_phase:.1f} s; bell_spmm launches {launches} "
        f"{by_variant}")
    return {"launches": launches, "variant_launches": by_variant}


# -- phase 8: lm kernels -----------------------------------------------------


def moe_routing(rng, tokens: int, experts: int, top_k: int):
    """Seeded top-k routing over skewed logits — expert e's logit is shifted
    by a bias falling from +1.5 to -1.5, so the groups are uneven — and the
    softmax weights of each token's chosen experts."""
    logits = rng.standard_normal((tokens, experts)).astype(np.float32)
    logits += np.linspace(1.5, -1.5, experts, dtype=np.float32)
    top = np.argpartition(-logits, top_k - 1, axis=1)[:, :top_k]
    top_logits = np.take_along_axis(logits, top, axis=1)
    weights = np.exp(top_logits - top_logits.max(axis=1, keepdims=True))
    return top.astype(np.int64), (weights / weights.sum(axis=1, keepdims=True)).astype(np.float32)


def moe_ffn(x_tok, w_gate, w_up, w_down, plan, route_w, top_k):
    """A dropless MoE expert FFN through ``grouped_matmul``: the routed rows
    gathered by expert (``plan_groups``' order, padding rows zero), the gate
    and up products, SiLU(gate)·up in the input type, the down product and
    the router-weighted sum back to the tokens. Returns the token outputs
    and, for each product, its (x, w, out)."""
    from repro_torch.kernels.gmm import grouped_matmul

    order, gid = plan
    dtype = x_tok.dtype
    valid = torch.as_tensor(order >= 0, device=x_tok.device)
    rows = torch.as_tensor(order[order >= 0], device=x_tok.device)  # routed rows
    xs = torch.zeros((len(order), x_tok.shape[1]), dtype=dtype, device=x_tok.device)
    xs[valid] = x_tok[rows // top_k]
    kw = {"bm": GMM_BM, "bk": GMM_BM, "bn": GMM_BM, "out_dtype": torch.float32}
    g = grouped_matmul(xs, w_gate, gid, **kw)
    u = grouped_matmul(xs, w_up, gid, **kw)
    h = (torch.nn.functional.silu(g) * u).to(dtype)
    y = grouped_matmul(h, w_down, gid, **kw)
    out = torch.zeros((x_tok.shape[0], w_down.shape[2]), dtype=torch.float32,
                      device=x_tok.device)
    out.index_add_(0, rows // top_k, y[valid] * route_w.reshape(-1)[rows][:, None])
    return out, {"gate": (xs, w_gate, g), "up": (xs, w_up, u), "down": (h, w_down, y)}


def moe_per_token(x_tok, w_gate, w_up, w_down, top, route_w, sample):
    """The sampled tokens' FFN outputs and gate products, token by token:
    ``x[tok] @ w[expert]`` for each of its experts, in float32 from the same
    inputs (the check of tests/test_kernels_gmm.py::test_gmm_end_to_end_dispatch)."""
    dtype = x_tok.dtype
    out = torch.zeros((len(sample), w_down.shape[2]), dtype=torch.float32, device=x_tok.device)
    gates = {}
    for i, tok in enumerate(sample):
        xt = x_tok[tok].float()
        for slot, e in enumerate(top[tok]):
            g = xt @ w_gate[e].float()
            h = (torch.nn.functional.silu(g) * (xt @ w_up[e].float())).to(dtype).float()
            out[i] += route_w[tok, slot] * (h @ w_down[e].float())
            gates[(int(tok), slot)] = g
    return out, gates


def phase_lm_moe(device) -> dict:
    from repro_torch.kernels.gmm import gmm_plain, grouped_matmul, plan_groups

    cfg = GRANITE
    rng = np.random.default_rng(2)
    tokens, d, f, e, top_k = (cfg["batch"] * cfg["seq"], cfg["d_model"], cfg["moe_d_ff"],
                              cfg["experts"], cfg["top_k"])
    top, route_w = moe_routing(rng, tokens, e, top_k)
    t0 = time.perf_counter()
    order, gid_np, padded = plan_groups(top.reshape(-1), e, GMM_BM)
    t_plan = time.perf_counter() - t0
    counts = np.bincount(top.reshape(-1), minlength=e)
    log(f"[lm moe] granite-moe-1b-a400m experts: {tokens} tokens x top-{top_k} = "
        f"{top.size} routed rows over {e} experts (group sizes {counts.min()} .. "
        f"{counts.max()}), plan_groups bm={GMM_BM}: {len(order)} rows, "
        f"{len(gid_np)} row tiles, {t_plan:.2f} s")
    check(len(order) == padded.sum() and (order >= 0).sum() == top.size,
          "plan_groups lost or duplicated a routed row")
    x32 = torch.as_tensor(rng.standard_normal((tokens, d)).astype(np.float32), device=device)
    # Weights at a realistic init scale, 1/sqrt(fan_in), so activations stay O(1).
    w32 = {name: torch.as_tensor((rng.standard_normal(shape) / np.sqrt(shape[1])).astype(
        np.float32), device=device)
        for name, shape in (("gate", (e, d, f)), ("up", (e, d, f)), ("down", (e, f, d)))}
    gid = torch.as_tensor(gid_np, device=device)
    route_w_t = torch.as_tensor(route_w, device=device)
    sample = np.sort(rng.choice(tokens, size=256, replace=False))
    pos_of = {int(r): p for p, r in enumerate(order) if r >= 0}

    out = {"launches": 0, "variant_launches": dict.fromkeys(grouped_matmul.variant_launches, 0),
           "gid": gid, "padded": padded, "products": {}}
    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        w = {k: v.to(dtype) for k, v in w32.items()}
        tol = GMM_TOL[dtype]
        grouped_matmul.launches = 0
        grouped_matmul.variant_launches = dict.fromkeys(grouped_matmul.variant_launches, 0)
        y_tok, products = moe_ffn(x, w["gate"], w["up"], w["down"], (order, gid), route_w_t,
                                  top_k)
        torch.cuda.synchronize()
        launches = grouped_matmul.launches
        check(launches > 0, f"gmm was never launched on the MoE path ({dtype})")
        by_variant = dict(grouped_matmul.variant_launches)
        new = "wgmma" if dtype == torch.bfloat16 else "regblock"
        check(by_variant[new] == launches and by_variant["simt"] == 0,
              f"the MoE path ({dtype}) did not run on the {new} variant alone: {by_variant}")
        out["launches"] += launches
        for v, c in by_variant.items():
            out["variant_launches"][v] += c
        check(bool(torch.isfinite(y_tok).all()) and y_tok.shape == (tokens, d),
              f"MoE output non-finite or misshapen ({dtype})")
        for name, (xi, wi, yi) in products.items():
            err, ok = allclose_err(yi, gmm_plain(xi, wi, gid, bm=GMM_BM), tol)
            check(ok, f"gmm {name} {dtype} vs plain on the full tensors: max abs err {err:.2e}")
            log(f"[lm moe] {dtype} {name}: x {list(xi.shape)} @ w {list(wi.shape)}, "
                f"max |kernel - plain| {err:.3e}")
            out["products"][(name, dtype)] = (xi, wi, err)
        ref_out, ref_gates = moe_per_token(x, w["gate"], w["up"], w["down"], top, route_w_t,
                                           sample)
        err_tok, ok = allclose_err(y_tok[torch.as_tensor(sample, device=device)], ref_out, tol)
        check(ok, f"MoE output vs per-token experts ({dtype}): max abs err {err_tok:.2e}")
        g_rows = torch.stack([products["gate"][2][pos_of[int(tok) * top_k + slot]]
                              for tok, slot in ref_gates])
        err_g, ok = allclose_err(g_rows, torch.stack(list(ref_gates.values())), tol)
        check(ok, f"gate rows vs x[tok] @ w[expert] ({dtype}): max abs err {err_g:.2e}")
        log(f"[lm moe] {dtype}: {launches} gmm launches {by_variant}; 256 sampled tokens vs "
            f"per-token experts: output max abs err {err_tok:.3e}, gate rows {err_g:.3e}")
    return out


def lm_qkv(rng, cfg, device):
    """float32 q, k, v as ``mha`` takes them: ``[batch·heads, S, D]``, the kv
    heads repeated to the query heads by the caller."""
    b, h, kvh, s, d = cfg["batch"], cfg["heads"], cfg["kv_heads"], cfg["seq"], cfg["head_dim"]
    q = torch.as_tensor(rng.standard_normal((b, h, s, d)).astype(np.float32), device=device)
    k, v = (torch.as_tensor(rng.standard_normal((b, kvh, s, d)).astype(np.float32),
                            device=device).repeat_interleave(h // kvh, dim=1)
            for _ in range(2))
    return tuple(a.reshape(b * h, s, d) for a in (q, k, v))


def phase_lm_attention(device) -> dict:
    from repro_torch.kernels.attn import attention_plain, flash_attention, mha, visited_tiles

    rng = np.random.default_rng(3)
    runs = []
    granite = lm_qkv(rng, GRANITE, device)
    h2o = lm_qkv(rng, H2O, device)
    for name, cfg, qkv, window, dtype in (
        ("granite-moe-1b-a400m causal", GRANITE, granite, 0, torch.bfloat16),
        ("granite-moe-1b-a400m causal", GRANITE, granite, 0, torch.float32),
        ("h2o-danube-1.8b window 4096", H2O, h2o, H2O["window"], torch.bfloat16),
        # float32 too: at these shapes |o| is about 0.03, so only the float32
        # tolerance would see a mis-masked tile at the window's edge.
        ("h2o-danube-1.8b window 4096", H2O, h2o, H2O["window"], torch.float32),
    ):
        q, k, v = (a.to(dtype) for a in qkv)
        bh, s, d = q.shape
        kw = {"causal": True, "window": window, "bq": ATTN_TILE, "bkv": ATTN_TILE}
        flash_attention.launches = 0
        flash_attention.variant_launches = dict.fromkeys(flash_attention.variant_launches, 0)
        o = mha(q, k, v, **kw)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        by_variant = dict(flash_attention.variant_launches)
        check(launches > 0, f"flash_attention was never launched on {name} ({dtype})")
        new = "wgmma" if dtype == torch.bfloat16 else "regblock"
        check(by_variant[new] == launches and by_variant["simt"] == 0,
              f"{name} ({dtype}) did not run on the {new} variant alone: {by_variant}")
        check(bool(torch.isfinite(o).all()) and o.shape == q.shape and o.dtype == dtype,
              f"{name} ({dtype}): output non-finite or misshapen")
        rows = torch.linspace(0, bh - 1, 4, device=device).long()  # 4 of the BH rows, full S
        o_plain = attention_plain(q[rows], k[rows], v[rows], causal=True, window=window,
                                  bq=ATTN_TILE, bkv=ATTN_TILE)
        err, ok = allclose_err(o[rows], o_plain, ATTN_TOL[dtype])
        check(ok, f"{name} ({dtype}) vs plain on rows {rows.tolist()}: max abs err {err:.2e}")
        tight = ""
        if dtype == torch.bfloat16:
            diff = (o[rows].float() - o_plain.float()).abs()
            excess = float((diff - ATTN_BF16_REL * o_plain.float().abs()).max())
            check(excess <= ATTN_BF16_ABS,
                  f"{name} (bf16) vs plain: |d| exceeds 2^-6 |ref| by {excess:.2e} > "
                  f"{ATTN_BF16_ABS}")
            tight = f", max(|d| - 2^-6 |ref|) = {excess:.3e} (<= {ATTN_BF16_ABS})"
        tiles = visited_tiles(s, s, causal=True, window=window, bq=ATTN_TILE, bkv=ATTN_TILE)
        triangle = visited_tiles(s, s, causal=True, window=0, bq=ATTN_TILE, bkv=ATTN_TILE)
        log(f"[lm attn] {name} {dtype}: [BH={bh}, S={s}, D={d}], {launches} launch(es) "
            f"{by_variant}, tiles visited per BH row {tiles} of the causal triangle's "
            f"{triangle}; max |kernel - plain| on 4 rows {err:.3e}{tight}")
        runs.append({"name": name, "heads": cfg["heads"], "qkv": (q, k, v), "kw": kw,
                     "launches": launches, "variant_launches": by_variant, "err": err})
    variant_launches = {v: sum(r["variant_launches"][v] for r in runs)
                        for v in flash_attention.variant_launches}
    return {"launches": sum(r["launches"] for r in runs), "variant_launches": variant_launches,
            "runs": runs}


# -- phase 9: lm serve -------------------------------------------------------


def lm_weight_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def lm_card_vs_cpu(seed: int, device) -> None:
    """Each family at reduced size: the same float32 weights on the CPU and,
    through lm_to_numpy -> lm_from_numpy, on the card; forward and every
    decode step within LM_TOL_CARD of the CPU's."""
    from repro_torch.config import get_arch
    from repro_torch.models import build, lm_from_numpy, lm_to_numpy

    for arch, s in LM_FAMILIES:
        cfg = get_arch(arch).reduced()
        model = build(cfg)
        cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
        card = lm_from_numpy(cfg, lm_to_numpy(cpu), device=device)
        rng = np.random.default_rng(seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
        if cfg.frontend:
            batch["frontend_embeds"] = rng.standard_normal((2, 8, cfg.d_model)).astype(
                np.float32)
        with torch.no_grad():
            fwd = scaled_err(model.forward(card, batch)[0].cpu(), model.forward(cpu, batch)[0])
        check(fwd <= LM_TOL_CARD, f"[lm serve] {arch} forward card vs CPU {fwd:.2e}")
        states = [model.init_state(p, batch, max_len=s) for p in (card, cpu)]
        dec = 0.0
        for t in range(s):
            tok = batch["tokens"][:, t : t + 1]
            (lg_card, states[0]), (lg_cpu, states[1]) = (
                model.decode_step(p, tok, st) for p, st in zip((card, cpu), states))
            check(lg_card.device.type == "cuda", f"[lm serve] {arch} decoded off the card")
            dec = max(dec, scaled_err(lg_card.cpu(), lg_cpu))
        check(dec <= LM_TOL_CARD, f"[lm serve] {arch} decode card vs CPU {dec:.2e}")
        log(f"[lm serve] {arch} ({cfg.family}, reduced, float32): card vs CPU, forward "
            f"{fwd:.3e}, {s} decode steps {dec:.3e} (<= {LM_TOL_CARD})")


def lm_forward_vs_decode(model, params, tokens) -> tuple:
    """(teacher-forced logits, step-by-step logits, ms a decode step)."""
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": tokens})
    state = model.init_state(params, {"tokens": tokens}, max_len=tokens.shape[1])
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(tokens.shape[1]):
        lg, state = model.decode_step(params, tokens[:, t : t + 1], state)
        outs.append(lg)
    step = torch.stack(outs, dim=1)
    torch.cuda.synchronize()
    return full, step, (time.perf_counter() - t0) / tokens.shape[1] * 1e3


def lm_requests(cfg, seed: int) -> list:
    """LM_REQUESTS prompts of LM_PROMPT_RANGE tokens from SyntheticStream."""
    from repro_torch.data import DataConfig, SyntheticStream

    lo, hi = LM_PROMPT_RANGE
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, LM_REQUESTS)
    toks = SyntheticStream(DataConfig(cfg.vocab_size, hi, LM_REQUESTS, seed=seed)).batch_at(0)
    return [toks[i, :n] for i, n in enumerate(lengths)]


def lm_encdec_full_width(seed: int, device, where: str) -> None:
    """seamless-m4t-medium uncut, weights from ``seed`` on the card: float32
    forward against step-by-step decode (checked), then bf16
    ``greedy_generate`` on frames (timed), then the LM ``ServeEngine``,
    which must fail on the family with the reference's ``KeyError``."""
    from repro_torch.config import get_arch
    from repro_torch.data import DataConfig, SyntheticStream, frontend_stub
    from repro_torch.models import build
    from repro_torch.models.common import count_params
    from repro_torch.serve import Request, ServeEngine, greedy_generate

    cfg16 = get_arch(ENCDEC_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    tokens = torch.as_tensor(SyntheticStream(
        DataConfig(cfg16.vocab_size, LM_PROMPT_LEN, LM_PROMPTS, seed=seed)).batch_at(0),
        device=device)
    frames = torch.as_tensor(frontend_stub(cfg16, LM_PROMPTS, ENCDEC_FRAMES, seed=seed),
                             device=device)
    batch = {"tokens": tokens, "frontend_embeds": frames}
    model32 = build(cfg32)
    t0 = time.perf_counter()
    params32 = model32.init(torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_enc = sum(p.numel() for n, p in params32.named_parameters()
                if n.startswith(("enc_layers.", "enc_norm")))
    log(f"[lm serve] {ENCDEC_ARCH} full width: {cfg16.encoder_layers} encoder and "
        f"{cfg16.num_layers} decoder layers, d_model {cfg16.d_model}, {cfg16.num_heads} heads "
        f"(kv {cfg16.num_kv_heads}), head_dim {cfg16.hd}, d_ff {cfg16.d_ff}, vocab "
        f"{cfg16.vocab_size}; {count_params(params32) / 1e9:.4f} G parameters ({n_enc / 1e9:.4f} G"
        f" in the encoder), float32 {lm_weight_bytes(params32) / 1e9:.3f} GB drawn from --seed "
        f"on the card in {init_s:.2f} s")
    with torch.no_grad():
        full, _ = model32.forward(params32, batch)
    state = model32.init_state(params32, batch, max_len=LM_PROMPT_LEN)
    outs = []
    for t in range(LM_PROMPT_LEN):
        lg, state = model32.decode_step(params32, tokens[:, t : t + 1], state)
        outs.append(lg)
    step = torch.stack(outs, dim=1)
    check(bool(torch.isfinite(full).all()) and full.shape == (
        LM_PROMPTS, LM_PROMPT_LEN, cfg16.vocab_size), "[lm serve] enc-dec logits misshapen")
    err32 = scaled_err(step, full)
    check(err32 <= LM_TOL_F32, f"[lm serve] {ENCDEC_ARCH} float32 forward vs decode {err32:.2e}")
    log(f"[lm serve] {ENCDEC_ARCH} {LM_PROMPTS} prompts x {LM_PROMPT_LEN} tokens over "
        f"{ENCDEC_FRAMES} frames: forward vs decode float32 {err32:.3e} (<= {LM_TOL_F32})")
    del params32, full, step, outs, state
    torch.cuda.empty_cache()

    # bf16 greedy_generate, its init_state (the encoder) and every decode
    # step timed by the host clock with a synchronize on either side.
    model16 = build(cfg16)
    params16 = model16.init(torch.Generator(device=device).manual_seed(seed))
    times = {"encode": [], "step": []}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t1)
            return out
        return call

    clocked = dataclasses.replace(model16, init_state=timed("encode", model16.init_state),
                                  decode_step=timed("step", model16.decode_step))
    prompts = SyntheticStream(DataConfig(cfg16.vocab_size, LM_CHECK_LEN, ENCDEC_PROMPTS,
                                         seed=seed + 1)).batch_at(0)
    fr = frontend_stub(cfg16, ENCDEC_PROMPTS, ENCDEC_FRAMES, seed=seed + 1)
    greedy_generate(clocked, params16, prompts[:, :4], 2, frontend_embeds=fr)  # warm-up
    times = {"encode": [], "step": []}
    t0 = time.perf_counter()
    out = greedy_generate(clocked, params16, prompts, LM_NEW, frontend_embeds=fr)
    wall = time.perf_counter() - t0
    check(out.shape == (ENCDEC_PROMPTS, LM_NEW) and bool((out >= 0).all())
          and bool((out < cfg16.vocab_size).all()), "[lm serve] enc-dec greedy tokens misshapen")
    steps_ms = np.asarray(times["step"]) * 1e3
    log(f"[lm serve] {ENCDEC_ARCH} bf16 greedy_generate: {ENCDEC_PROMPTS} prompts of "
        f"{LM_CHECK_LEN} tokens over {ENCDEC_FRAMES} frames, {LM_NEW} new tokens each, "
        f"{wall:.3f} s; encode (init_state) {times['encode'][0] * 1e3:.2f} ms; "
        f"{len(steps_ms)} decode steps, wall p50 {np.percentile(steps_ms, 50):.3f} ms (p99 "
        f"{np.percentile(steps_ms, 99):.3f}); {ENCDEC_PROMPTS * LM_NEW / wall:.1f} generated "
        f"tokens/s [{where}]")

    eng = ServeEngine(model16, params16, batch_slots=2, max_len=LM_CHECK_LEN + LM_NEW)
    eng.submit(Request(rid=0, prompt=prompts[0], max_new=LM_NEW))
    try:
        eng.run_until_drained()
    except KeyError as e:
        check(e.args == ("frontend_embeds",), f"[lm serve] enc-dec engine raised {e!r}")
    else:
        raise RuntimeError("check failed: the LM ServeEngine served the enc-dec family "
                           "without frames; the reference raises KeyError")
    log(f"[lm serve] {ENCDEC_ARCH}: the LM ServeEngine's tokens-only wave raises "
        f"KeyError('frontend_embeds'), as the reference's does")
    del params16, eng
    torch.cuda.empty_cache()


def phase_lm_serve(card: dict, seed: int, device) -> None:
    from repro_torch.config import get_arch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels.attn import flash_attention
    from repro_torch.kernels.gmm import grouped_matmul
    from repro_torch.kernels.spmv import bell_spmm
    from repro_torch.models import build
    from repro_torch.models.common import count_params
    from repro_torch.serve import Request, ServeEngine, greedy_generate

    where = card["smi"]
    t_phase = time.perf_counter()
    counters = (bell_spmm, grouped_matmul, flash_attention)
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # 1. Card against CPU, every family of the slice, at reduced size.
    lm_card_vs_cpu(seed, device)
    parts = {"card vs CPU": time.perf_counter() - t_phase}

    # 2. Full width: float32 forward vs decode (checked), bf16 (printed).
    cfg16 = get_arch(LM_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    model32, model16 = build(cfg32), build(cfg16)
    tokens = torch.as_tensor(SyntheticStream(
        DataConfig(cfg16.vocab_size, LM_PROMPT_LEN, LM_PROMPTS, seed=seed)).batch_at(0),
        device=device)
    t0 = time.perf_counter()
    params32 = model32.init(torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[lm serve] {LM_ARCH} full width: {cfg16.num_layers} layers, d_model "
        f"{cfg16.d_model}, {cfg16.num_heads} heads (kv {cfg16.num_kv_heads}), head_dim "
        f"{cfg16.hd}, d_ff {cfg16.d_ff}, vocab {cfg16.vocab_size}; "
        f"{count_params(params32) / 1e9:.4f} G parameters, float32 "
        f"{lm_weight_bytes(params32) / 1e9:.3f} GB drawn from --seed on the card in "
        f"{init_s:.2f} s")
    full32, step32, ms32 = lm_forward_vs_decode(model32, params32, tokens)
    err32 = scaled_err(step32, full32)
    check(bool(torch.isfinite(full32).all()) and full32.shape == (
        LM_PROMPTS, LM_PROMPT_LEN, cfg16.vocab_size), "[lm serve] float32 logits misshapen")
    check(err32 <= LM_TOL_F32, f"[lm serve] float32 forward vs decode {err32:.2e}")
    del params32
    torch.cuda.empty_cache()
    params16 = model16.init(torch.Generator(device=device).manual_seed(seed))
    full16, step16, ms16 = lm_forward_vs_decode(model16, params16, tokens)
    err16 = scaled_err(step16.float(), full16.float())
    top1 = float((step16.argmax(-1) == step32.argmax(-1)).float().mean())
    log(f"[lm serve] {LM_ARCH} {LM_PROMPTS} prompts x {LM_PROMPT_LEN} tokens: forward vs "
        f"decode float32 {err32:.3e} (<= {LM_TOL_F32}), bf16 {err16:.3e} (not checked); bf16 "
        f"decode's top-1 equal to float32's at {top1:.1%} of {step16.shape[0] * step16.shape[1]}"
        f" positions; a decode step at B={LM_PROMPTS}: float32 {ms32:.2f} ms, bf16 {ms16:.2f} "
        f"ms (host clock) [{where}]")
    del full32, step32, full16, step16
    parts["full width"] = time.perf_counter() - t_phase - sum(parts.values())

    # 3. The engine at full width, bf16.
    prompts = lm_requests(cfg16, seed)
    ticks, generated, ttft, wave_of = [], [], {}, {}
    eng = ServeEngine(model16, params16, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    resident = torch.cuda.memory_allocated()
    full_width_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = [Request(rid=i, prompt=p, max_new=LM_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    waves = 0
    while len(eng.completed) < LM_REQUESTS:
        check(len(ticks) < 10_000, "[lm serve] the engine did not drain")
        out_before = sum(len(r.out) for r in reqs)
        t1 = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        ticks.append(now - t1)
        generated.append(sum(len(r.out) for r in reqs) - out_before)
        waves += eng.state.pos == 1  # this tick opened a wave
        for r in eng.active:
            if r is not None:
                wave_of.setdefault(r.rid, waves)
                if r.out and r.rid not in ttft:
                    ttft[r.rid] = now - t0
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    parts["engine"] = time.perf_counter() - t_phase - sum(parts.values())
    check(all(r.done and len(r.out) == LM_NEW for r in reqs),
          "[lm serve] not every request finished with its tokens")
    check(all(0 <= t < cfg16.vocab_size for r in reqs for t in r.out),
          "[lm serve] a generated token is outside the vocabulary")

    # The device's busy time per tick: torch.profiler (device activity only)
    # over LM_PROFILED_TICKS generating ticks of a fresh wave, the device
    # events' durations summed (one stream: they do not overlap).
    from torch.profiler import ProfilerActivity, profile

    prof_eng = ServeEngine(model16, params16, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    for i in range(LM_SLOTS):
        prof_eng.submit(Request(rid=i, prompt=prompts[i][:4], max_new=LM_NEW))
    for _ in range(5):
        prof_eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LM_PROFILED_TICKS):
            prof_eng.step()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3 / LM_PROFILED_TICKS
    kernels = len(on_device) / LM_PROFILED_TICKS
    parts["profiler"] = time.perf_counter() - t_phase - sum(parts.values())
    del prof_eng

    tick_ms = np.asarray(ticks) * 1e3
    gen_ms = tick_ms[np.asarray(generated) > 0]
    pre_ms = tick_ms[np.asarray(generated) == 0]
    tokens_out = sum(len(r.out) for r in reqs)
    first = np.asarray([ttft[r.rid] for r in reqs]) * 1e3
    by_wave = {w: first[[wave_of[r.rid] == w for r in reqs]] for w in sorted(set(wave_of.values()))}
    weight_bytes = lm_weight_bytes(params16)
    kv_bytes = (cfg16.num_layers * LM_SLOTS * LM_MAX_LEN * cfg16.num_kv_heads * cfg16.hd
                * 2 * 2)
    bound_ms = (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
    busy = (f"{busy_ms:.3f} ms by torch.profiler ({LM_PROFILED_TICKS} ticks, {kernels:.0f} "
            f"kernels a tick), idle share {1.0 - busy_ms / np.median(gen_ms):.1%} of the "
            f"generating p50" if busy_ms > 0 else "not measured (no device time in the trace)")
    log(f"[lm serve] engine bf16, batch_slots {LM_SLOTS}, max_len {LM_MAX_LEN}: "
        f"{LM_REQUESTS} requests (prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens, {LM_NEW} new each) in {waves} waves, "
        f"{len(ticks)} ticks ({len(pre_ms)} prompt-only, {len(gen_ms)} generating), "
        f"{wall:.2f} s; {tokens_out / wall:.1f} generated tokens/s, "
        f"{LM_REQUESTS / wall:.2f} requests/s [{where}]")
    log(f"[lm serve] tick wall mean {tick_ms.mean():.3f} ms, p50 "
        f"{np.percentile(tick_ms, 50):.3f}, p99 {np.percentile(tick_ms, 99):.3f}; prompt-only "
        f"ticks p50 {np.percentile(pre_ms, 50) if len(pre_ms) else float('nan'):.3f} ms, "
        f"generating p50 {np.percentile(gen_ms, 50):.3f} ms; time to first token p50 "
        + ", ".join(f"wave {w} {np.percentile(v, 50):.1f} ms (max {v.max():.1f})"
                    for w, v in by_wave.items()) + f" [{where}]")
    log(f"[lm serve] device busy per generating tick {busy}; the decode step's byte bound "
        f"{bound_ms:.3f} ms "
        f"(weights {weight_bytes / 1e9:.3f} GB + KV {kv_bytes / 1e9:.3f} GB over "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s) [{where}]")
    log(f"[lm serve] device memory: {base / 2**20:.0f} MiB allocated before the phase; peak "
        f"{(full_width_peak - base) / 2**20:.0f} MiB above it through the full-width checks; "
        f"{(resident - base) / 2**20:.0f} MiB of bf16 weights resident for the engine, whose "
        f"peak is {(peak - resident) / 2**20:.0f} MiB above them [{where}]")

    # 4. The check wave: 8 equal prompts, bitwise greedy_generate on the
    # same batch; batch-1 agreement as a measurement.
    check_len = LM_CHECK_LEN
    same = SyntheticStream(DataConfig(cfg16.vocab_size, check_len, LM_SLOTS,
                                      seed=seed + 1)).batch_at(0)
    wave = [Request(rid=100 + i, prompt=same[i], max_new=LM_NEW) for i in range(LM_SLOTS)]
    eng = ServeEngine(model16, params16, batch_slots=LM_SLOTS, max_len=check_len + LM_NEW)
    for r in wave:
        eng.submit(r)
    eng.run_until_drained()
    check(eng.ticks == check_len + LM_NEW - 1, f"[lm serve] the check wave took {eng.ticks} ticks")
    want = greedy_generate(model16, params16, same, LM_NEW)
    parts["check wave"] = time.perf_counter() - t_phase - sum(parts.values())
    for i, r in enumerate(wave):
        check(np.array_equal(np.asarray(r.out), want[i]),
              f"[lm serve] request {r.rid} is not bitwise greedy_generate on its batch")
    singles = [greedy_generate(model16, params16, same[i:i + 1], LM_NEW)[0]
               for i in range(LM_SLOTS)]
    tok_eq = float(np.mean([np.mean(np.asarray(r.out) == s) for r, s in zip(wave, singles)]))
    req_eq = sum(np.array_equal(np.asarray(r.out), s) for r, s in zip(wave, singles))
    log(f"[lm serve] check wave: {LM_SLOTS} prompts of {check_len} tokens, every request "
        f"bitwise greedy_generate on the same batch; against batch-1 greedy_generate "
        f"(a measurement): {req_eq} of {LM_SLOTS} requests and {tok_eq:.1%} of tokens equal")

    parts["batch-1 decodes"] = time.perf_counter() - t_phase - sum(parts.values())
    del eng, params16
    torch.cuda.empty_cache()

    # 5. The encoder-decoder family at full width.
    lm_encdec_full_width(seed, device, where)
    parts["enc-dec full width"] = time.perf_counter() - t_phase - sum(parts.values())
    launched = {k.__name__: k.launches for k in counters}
    check(not any(launched.values()), f"[lm serve] a kernel of the port ran: {launched}")
    log(f"[lm serve] phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + f"); kernel launches {launched}: "
        f"the LM path calls no kernel of the port, as the reference's calls no Pallas kernel")


# -- phase 10: lm train ------------------------------------------------------


def grad_errors(grads: dict, ref: dict) -> dict:
    """max |g - g_ref| / max |g_ref| per weight, on the CPU."""
    return {n: float((grads[n].cpu() - ref[n]).abs().max() / ref[n].abs().max().clamp(min=1e-30))
            for n in ref}


def lm_train_card_vs_cpu(seed: int, device) -> None:
    """Each family at reduced size in float32: one step's loss and gradients
    on the card against the CPU's on the same weights; then on qwen3 and
    granite-moe, remat "full" and "dots" bitwise "none" on the card, and
    two microbatches against one."""
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.models import build, lm_from_numpy, lm_to_numpy
    from repro_torch.optim import init_opt
    from repro_torch.train import make_train_step
    from repro_torch.train.step import value_and_grad

    for arch, s in LM_TRAIN_FAMILIES:
        cfg = get_arch(arch).reduced()
        model = build(cfg)
        cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
        card = lm_from_numpy(cfg, lm_to_numpy(cpu), device=device)
        rng = np.random.default_rng(seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
        if cfg.frontend:
            batch["frontend_embeds"] = rng.standard_normal((2, 8, cfg.d_model)).astype(
                np.float32)
        tc = TrainConfig()
        loss_c, met_c, g_c = value_and_grad(model, card, batch, None, tc)
        loss, met, g = value_and_grad(model, cpu, batch, None, tc)
        check(all(v.device.type == "cuda" for v in g_c.values()), f"[lm train] {arch} off the card")
        loss_err = abs(float(loss_c) - float(loss)) / abs(float(loss))
        errs = grad_errors(g_c, g)
        worst = max(errs, key=errs.get)
        check(loss_err <= TRAIN_LOSS_TOL, f"[lm train] {arch} loss card vs CPU {loss_err:.2e}")
        check(errs[worst] <= TRAIN_GRAD_TOL,
              f"[lm train] {arch} gradient {worst} card vs CPU {errs[worst]:.2e}")
        log(f"[lm train] {arch} ({cfg.family}, reduced, float32): one step card vs CPU, loss "
            f"{loss_err:.3e} (<= {TRAIN_LOSS_TOL}, aux {float(met_c['aux']):.4f}), worst "
            f"gradient leaf {worst} {errs[worst]:.3e} of its max |g| (<= {TRAIN_GRAD_TOL})")
        if arch not in TRAIN_ARCHS:
            continue
        for remat in ("full", "dots"):
            loss_r, _, g_r = value_and_grad(model, card, batch, None, TrainConfig(remat=remat))
            check(torch.equal(loss_r, loss_c) and all(torch.equal(g_r[n], g_c[n]) for n in g_c),
                  f"[lm train] {arch} remat={remat} is not bitwise remat='none' on the card")
        # Two microbatches against one, at tests/test_train_loop.py's
        # tolerance. The MoE load-balance loss is not a sum over tokens (each
        # microbatch has its own), so for MoE that check runs with its weight
        # at 0 and the difference with the weight as configured is printed.
        batch4 = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)}
        diffs = {}
        for aux_w in ((0.0, TrainConfig().moe_aux_weight) if cfg.is_moe else (0.01,)):
            outs = []
            for m in (1, 2):
                tc_m = TrainConfig(total_steps=10, warmup_steps=0, microbatches=m,
                                   learning_rate=1e-3, moe_aux_weight=aux_w)
                p = card.map(lambda _, w: w.clone())
                p, _, metrics = make_train_step(model, tc_m)(p, init_opt(p), batch4)
                outs.append((p, float(metrics["loss"])))
            (p1, l1), (p2, l2) = outs
            diffs[aux_w] = (abs(l1 - l2), max(float(((a - b).abs() - 2e-2 * b.abs()).max())
                                              for a, b in zip(p1.parameters(), p2.parameters())))
        loss_d, w_d = next(iter(diffs.values()))
        check(loss_d < 1e-3 and w_d <= 2e-4,
              f"[lm train] {arch} microbatches 2 vs 1: loss {loss_d:.2e}, weights {w_d:.2e}")
        log(f"[lm train] {arch} on the card: remat full and dots bitwise none; microbatches 2 "
            f"vs 1, checked to < 1e-3 on the loss and <= 2e-4 on max(|d| - 2e-2 |w|) of the "
            f"weights: " + "; ".join(
                f"aux weight {w}: loss {d[0]:.3e}, weights {d[1]:.3e}"
                + (" (printed only)" if i else "") for i, (w, d) in enumerate(diffs.items())))


def moe_drop_share(model, params, batch) -> tuple:
    """(share of token copies dropped at capacity, MoE layers seen) in one
    forward: the router's expert ids captured per layer and ranked in their
    experts' queues as the dispatch ranks them."""
    from repro_torch.models import moe as moe_mod

    seen = []
    router = moe_mod.router_topk

    def spy(p, x, cfg):
        out = router(p, x, cfg)
        seen.append((out[1].detach(), x.shape[0] * x.shape[1]))
        return out

    moe_mod.router_topk = spy
    try:
        with torch.no_grad():
            model.forward(params, batch)
    finally:
        moe_mod.router_topk = router
    cfg = model.cfg
    dropped = 0
    for ids, t in seen:
        pos = moe_mod._rank_within(ids.reshape(-1), cfg.num_experts, cfg.moe_sort_dispatch)
        dropped += int((pos >= moe_mod._capacity(t, cfg, False)).sum())
    return dropped / sum(ids.numel() for ids, _ in seen), len(seen)


def split_step_ms(model, params, state, batch, tc) -> tuple:
    """(forward, backward, optimizer) ms of one step by CUDA events: the
    calls the train step makes (loss_fn, autograd, opt_update), under the
    same deterministic mode, with their boundaries marked."""
    from repro_torch.optim import opt_update
    from repro_torch.train import loss_fn
    from repro_torch.train.step import deterministic

    names = [n for n, _ in params.named_parameters()]
    weights = list(params.parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with deterministic():
        for w in weights:
            w.requires_grad_(True)
        ev[0].record()
        loss, metrics = loss_fn(model, params, batch, None, tc)
        ev[1].record()
        grads = torch.autograd.grad(loss, weights)
        ev[2].record()
        for w in weights:
            w.requires_grad_(False)
        params, state, opt_metrics = opt_update(params, dict(zip(names, grads)), state, tc)
        ev[3].record()
    torch.cuda.synchronize()
    metrics = {k: float(v.detach()) for k, v in {**metrics, **opt_metrics}.items()}
    return tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3)), state, metrics["loss"], metrics


def lm_train_full_width(arch: str, seed: int, device, where: str,
                        remats=("none", "full", "dots"), trained=("none",)) -> dict:
    """``arch`` uncut in bf16, weights from ``seed``: ``make_batch``'s
    batches of TRAIN_BATCH x TRAIN_SEQ tokens (SyntheticStream's, and
    frames for a frontend) under each remat mode; the step time split,
    tokens/s, MFU, peak memory; under each mode of ``trained`` (the first
    of ``remats`` among them) TRAIN_STEPS steps must lower the loss.
    Returns the step's ms (CUDA events) by remat mode."""
    from repro_torch.config import ShapeConfig, TrainConfig, get_arch
    from repro_torch.data import make_batch
    from repro_torch.models import build
    from repro_torch.models.common import count_params
    from repro_torch.optim import init_opt
    from repro_torch.train import loss_fn, make_train_step

    cfg = get_arch(arch)
    model = build(cfg)
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")

    def batch_at(step):
        return {k: torch.as_tensor(v, device=device)
                for k, v in make_batch(cfg, shape, seed=seed, step=step).items()}

    tokens = TRAIN_BATCH * TRAIN_SEQ
    frames = batch_at(0).get("frontend_embeds")
    frame_rows = 0 if frames is None else frames.shape[0] * frames.shape[1]
    n_active = cfg.active_param_count()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    rows = {}
    for remat in remats:
        tc = TrainConfig(remat=remat, learning_rate=TRAIN_LR, warmup_steps=2,
                         total_steps=100)
        params = model.init(torch.Generator(device=device).manual_seed(seed))
        n_params = count_params(params)
        if cfg.family == "encdec":
            # 6 x (encoder parameters x frames + decoder-and-head parameters x
            # tokens); the tied embedding counts once, as the head.
            n_enc = sum(p.numel() for n, p in params.named_parameters()
                        if n.startswith(("enc_layers.", "enc_norm")))
            flops = 6 * (n_enc * frame_rows + (n_params - n_enc) * tokens)
            flop_text = (f"6 * ({n_enc} * {frame_rows} frames + {n_params - n_enc} * {tokens} "
                         f"tokens)")
        else:
            flops = 6 * n_active * tokens
            flop_text = f"6 * {n_active} * {tokens}"
        if cfg.is_moe and remat == "none":
            drops0 = moe_drop_share(model, params, batch_at(TRAIN_STEPS + 1))
        state = init_opt(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() - base
        # Step 0 warms up, steps 1 to TRAIN_TIMED are timed by parts, the
        # rest as whole steps; under "none" TRAIN_STEPS updates, then a step.
        steps = TRAIN_STEPS + 1 if remat in trained else TRAIN_TIMED + 2
        losses, auxes, splits, walls, metrics = [], [], [], [], {}
        step_fn = make_train_step(model, tc)
        for i in range(steps):
            batch = batch_at(i)
            if 1 <= i <= TRAIN_TIMED:
                split, state, loss, metrics = split_step_ms(model, params, state, batch, tc)
                splits.append(split)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step_fn(params, state, batch)
                loss = float(m["loss"])  # waits for the step
                walls.append(time.perf_counter() - t0)
                metrics = {k: float(v) for k, v in m.items()}
            check(np.isfinite(loss) and np.isfinite(metrics["grad_norm"]),
                  f"[lm train] {arch} remat={remat} step {i}: loss {loss}, "
                  f"grad_norm {metrics['grad_norm']}")
            losses.append(loss)
            auxes.append(metrics["aux"])
        peak = torch.cuda.max_memory_allocated() - base
        fwd, bwd, opt = np.median(np.asarray(splits), axis=0)
        step_ms = fwd + bwd + opt
        rows[remat] = step_ms
        log(f"[lm train] {arch} bf16 remat={remat}: step {step_ms:.1f} ms (forward {fwd:.1f}, "
            f"backward {bwd:.1f}, optimizer {opt:.1f}; CUDA events, median of {len(splits)}), "
            f"whole step by host clock {np.median(walls[1:]) * 1e3:.1f} ms; "
            f"{tokens / step_ms * 1e3:.0f} tokens/s; MFU {flops / (step_ms / 1e3) / PEAK_BF16_FLOPS:.1%}"
            f"; peak {peak / 2**30:.2f} GiB above the phase's start ({resident / 2**30:.2f} GiB "
            f"weights and moments) [{where}]")
        if remat in trained:
            # The loss on step 0's batch again, after the updates: the
            # stream's batches differ from step to step.
            with torch.no_grad():
                again = float(loss_fn(model, params, batch_at(0), None, tc)[0])
            check(again < losses[0], f"[lm train] {arch} remat={remat}: loss on step 0's batch "
                  f"{losses[0]:.4f} -> {again:.4f} after {TRAIN_STEPS} updates did not fall")
        if remat != remats[0] and remat in trained:
            log(f"[lm train] {arch} remat={remat}: loss on step 0's batch {losses[0]:.4f} before "
                f"and {again:.4f} after {TRAIN_STEPS} updates (each step's: "
                + " ".join(f"{v:.3f}" for v in losses) + ")")
        if remat == remats[0]:
            depth = (f"{cfg.encoder_layers} encoder and {cfg.num_layers} decoder layers"
                     if cfg.family == "encdec" else f"{cfg.num_layers} layers")
            log(f"[lm train] {arch} full width: {depth}, d_model {cfg.d_model}, "
                f"vocab {cfg.vocab_size}, {n_params / 1e9:.4f} G parameters "
                f"({n_active / 1e9:.4f} G active by ArchConfig.active_param_count); bf16 weights "
                f"and gradients with float32 mu and nu reckon "
                f"{n_params * (2 + 2 + 4 + 4) / 1e9:.2f} GB before activations; loss on step "
                f"0's batch {losses[0]:.4f} before and {again:.4f} after {TRAIN_STEPS} updates "
                f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens at lr {TRAIN_LR} (each step's: "
                + " ".join(f"{v:.3f}" for v in losses) + "); "
                f"MFU = {flop_text} / step_s / {PEAK_BF16_FLOPS:.3g} "
                f"(recomputation not counted)")
            if cfg.is_moe:
                share, layers = moe_drop_share(model, params, batch_at(TRAIN_STEPS + 1))
                log(f"[lm train] {arch}: aux (summed over {layers} layers; loss = ce + "
                    f"{tc.moe_aux_weight} * aux) {auxes[0]:.4f} at step 0, {auxes[-1]:.4f} at step "
                    f"{TRAIN_STEPS}; token copies dropped at capacity factor "
                    f"{cfg.moe_capacity_factor} in one forward of a fresh batch: {drops0[0]:.2%} "
                    f"before training, {share:.2%} after {TRAIN_STEPS} updates")
        del params, state, step_fn
        torch.cuda.empty_cache()
    log(f"[lm train] {arch} step ms by remat: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rows.items()) + f" [{where}]")
    return rows


def lm_train_loops(seed: int, device) -> None:
    """TrainLoop with a CheckpointManager in a temporary directory, reduced
    float32, on the card: two uninterrupted runs bitwise equal, and a run
    with a failure at step 5 bitwise them with one restart."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.models import build
    from repro_torch.runtime import FaultInjector
    from repro_torch.train import TrainLoop, make_train_step

    for arch in TRAIN_ARCHS:
        cfg = get_arch(arch).reduced()
        model = build(cfg)
        p0 = model.init(torch.Generator(device=device).manual_seed(seed))
        tc = TrainConfig(total_steps=8, warmup_steps=2, checkpoint_every=2, learning_rate=1e-2)
        stream = DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=seed)

        def batch_fn(s):
            return {"tokens": SyntheticStream(stream, start_step=s).batch_at(s)}

        step = make_train_step(model, tc)
        runs = []
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            for name, faults in (("a", None), ("b", None), ("c", FaultInjector({5: 0}))):
                loop = TrainLoop(step, batch_fn, tc, fault_injector=faults,
                                 ckpt=CheckpointManager(os.path.join(d, name), keep=10))
                runs.append(loop.run(p0, num_steps=8))
        a, b, c = runs
        check(c.restarts == 1 and c.final_step == 8, f"[lm train] {arch} loop restarts {c.restarts}")
        for name, res in (("a second uninterrupted run", b), ("the resumed run", c)):
            same = all(torch.equal(x, y) for x, y in zip(
                list(a.params.parameters()) + list(a.opt_state.nu.parameters()),
                list(res.params.parameters()) + list(res.opt_state.nu.parameters())))
            check(same, f"[lm train] {arch}: {name} is not bitwise the uninterrupted run")
        check(next(a.params.parameters()).device.type == "cuda", "[lm train] loop off the card")
        log(f"[lm train] {arch} (reduced, float32) TrainLoop on the card, checkpoints every 2 "
            f"steps: two uninterrupted runs bitwise equal; a failure at step 5 restored and "
            f"replayed (restarts {c.restarts}) bitwise them; loss {a.metrics_history[0]['loss']:.4f}"
            f" -> {a.metrics_history[-1]['loss']:.4f}; 3 runs in {time.perf_counter() - t0:.1f} s")


def lm_train_checkpoint_cost(seed: int, device, where: str) -> None:
    """qwen3-1.7b at full width cut to CKPT_LAYERS layers, bf16, after one
    step: a blocking save, a restore (bitwise), an async save and the
    stall it puts on the next step."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.models import build
    from repro_torch.optim import init_opt
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_arch(LM_ARCH), num_layers=CKPT_LAYERS)
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    state = init_opt(params)
    step = make_train_step(model, TrainConfig(warmup_steps=0))
    batch = {"tokens": torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), device=device)}

    def timed_step():
        nonlocal params, state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        return time.perf_counter() - t0

    timed_step()  # moments non-zero, kernels warm
    base_s = timed_step()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        t0 = time.perf_counter()
        mgr.save(1, (params, state), blocking=True)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "step_000000001", "arrays.npz"))
        t0 = time.perf_counter()
        (rp, rs), _ = mgr.restore((params, state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(x, y) for x, y in zip(
            list(params.parameters()) + list(state.mu.parameters()) + list(state.nu.parameters()),
            list(rp.parameters()) + list(rs.mu.parameters()) + list(rs.nu.parameters())))
        check(same and rs.step == state.step, "[lm train] checkpoint round trip is not bitwise")
        check(next(rp.parameters()).device.type == "cuda", "[lm train] restored off the card")
        del rp, rs
        t0 = time.perf_counter()
        mgr.save(2, (params, state), blocking=False)
        call_s = time.perf_counter() - t0
        next_s = timed_step()
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
    log(f"[lm train] checkpoint of {LM_ARCH} at full width cut to {CKPT_LAYERS} layers (bf16 "
        f"weights stored as float32, float32 mu and nu): {nbytes / 1e9:.3f} GB of npz; blocking "
        f"save {save_s:.2f} s ({nbytes / save_s / 1e9:.2f} GB/s), restore to the card "
        f"{restore_s:.2f} s, bitwise; async save returns in {call_s:.2f} s (host copies), the "
        f"next step takes {next_s * 1e3:.1f} ms against {base_s * 1e3:.1f} ms without a write in "
        f"flight, the write ends {wait_s:.2f} s after that step [{where}]")


def phase_lm_train(card: dict, seed: int, device) -> None:
    from repro_torch.kernels.attn import flash_attention
    from repro_torch.kernels.gmm import grouped_matmul
    from repro_torch.kernels.spmv import bell_spmm

    where = card["smi"]
    t_phase = time.perf_counter()
    counters = (bell_spmm, grouped_matmul, flash_attention)
    for k in counters:
        k.launches = 0
    parts, step_ms = {}, {}
    lm_train_card_vs_cpu(seed, device)
    parts["card vs CPU"] = time.perf_counter() - t_phase
    for arch in TRAIN_ARCHS:
        step_ms[arch] = lm_train_full_width(arch, seed, device, where)
        parts[arch] = time.perf_counter() - t_phase - sum(parts.values())
    lm_train_full_width(ENCDEC_ARCH, seed, device, where, TRAIN_ENCDEC_REMATS,
                        trained=TRAIN_ENCDEC_REMATS)
    parts[ENCDEC_ARCH] = time.perf_counter() - t_phase - sum(parts.values())
    lm_train_loops(seed, device)
    parts["loops"] = time.perf_counter() - t_phase - sum(parts.values())
    lm_train_checkpoint_cost(seed, device, where)
    parts["checkpoint"] = time.perf_counter() - t_phase - sum(parts.values())
    launched = {k.__name__: k.launches for k in counters}
    check(not any(launched.values()), f"[lm train] a kernel of the port ran: {launched}")
    log(f"[lm train] phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + f"); kernel launches "
        f"{launched}: the train path calls no kernel of the port, as the reference's calls no "
        f"Pallas kernel")
    torch.cuda.empty_cache()
    return step_ms


# -- phase 11: launch --------------------------------------------------------


def launch_train(arch: str, opts: dict, lr: float, mesh, seed: int, device, where: str) -> dict:
    """``arch`` uncut in float32 with ``opts``, weights from ``seed``:
    step one's loss and gradients on the mesh against the meshless step
    within the train gates (bitwise or not printed) and its updated leaves
    (LAUNCH_UPDATE_SHARE), then LAUNCH_STEPS
    steps of the meshless ``make_train_step`` and of the driver's
    ``train`` (TrainLoop, no checkpoints at this size) on the same
    weights and batches, each step's wall p50 printed; the driver's losses
    must be the meshless steps' within LAUNCH_LOSS_TOL, and its loss on
    step 0's batch must fall."""
    import tempfile

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch.mesh import batch_axes_of
    from repro_torch.launch.shardings import batch_shardings, param_shardings, place
    from repro_torch.launch.train import train
    from repro_torch.models import MeshCtx, build
    from repro_torch.models.moe import mesh_scope
    from repro_torch.optim import init_opt
    from repro_torch.train import loss_fn, make_train_step
    from repro_torch.train.step import value_and_grad

    cfg = dataclasses.replace(get_arch(arch), dtype="float32", **opts)
    model = build(cfg)
    ctx = MeshCtx(mesh, batch_axes_of(mesh))
    # The driver's TrainConfig (src/repro/launch/train.py), at ``lr``.
    tc = TrainConfig(total_steps=LAUNCH_STEPS, warmup_steps=max(LAUNCH_STEPS // 10, 1),
                     learning_rate=lr, checkpoint_every=max(LAUNCH_STEPS // 2, 1))
    dc = DataConfig(cfg.vocab_size, seq_len=LAUNCH_SEQ, global_batch=LAUNCH_BATCH, seed=0)
    batches = [{"tokens": torch.as_tensor(SyntheticStream(dc, start_step=s).batch_at(s),
                                          device=device)} for s in range(LAUNCH_STEPS)]
    params = model.init(torch.Generator(device=device).manual_seed(seed), device=device)

    def clone(p):
        return p.map(lambda _, w: w.detach().clone())

    # Step one's loss and gradients, meshless and on the mesh.
    t0 = time.perf_counter()
    loss_ref, _, grads_ref = value_and_grad(model, params, batches[0], None, tc)
    placed = place(clone(params), param_shardings(params, cfg, mesh))
    batch0 = place(batches[0], batch_shardings(batches[0], mesh))
    with mesh_scope(ctx):
        loss_mesh, _, grads_mesh = value_and_grad(model, placed, batch0, ctx, tc)
        loss_mesh = loss_mesh.full_tensor()
        grads_mesh = {n: g.full_tensor() for n, g in grads_mesh.items()}
    first_s = time.perf_counter() - t0
    loss_err = abs(float(loss_mesh) - float(loss_ref)) / abs(float(loss_ref))
    errs = {n: float((grads_mesh[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
            for n, g in grads_ref.items()}
    worst = max(errs, key=errs.get)
    bitwise = torch.equal(loss_mesh, loss_ref) and all(
        torch.equal(grads_mesh[n], grads_ref[n]) for n in grads_ref)
    check(loss_err <= TRAIN_LOSS_TOL and errs[worst] <= TRAIN_GRAD_TOL,
          f"[launch] {arch}: step one on the mesh off the meshless step: loss {loss_err:.2e}, "
          f"gradient {worst} {errs[worst]:.2e}")
    del grads_mesh, grads_ref
    # Step one's update on the mesh: the clip and AdamW over DTensors.
    placed, _, _ = make_train_step(model, tc, ctx)(placed, init_opt(placed), batch0)
    torch.cuda.empty_cache()

    # LAUNCH_STEPS meshless steps, then the driver on the mesh.
    ref, state = clone(params), None
    state = init_opt(ref)
    step = make_train_step(model, tc)
    walls, losses_ref = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, state, m = step(ref, state, b)
        losses_ref.append(float(m["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
        if placed is not None:  # step one's updated leaves, mesh against meshless
            lr_1 = float(m["lr"])
            mesh_w = dict(placed.named_parameters())
            moved = total = 0
            for n, w in ref.named_parameters():
                off = (mesh_w[n].full_tensor() - w).abs()
                moved += int((off > LAUNCH_UPDATE_ATOL * lr_1).sum())
                total += off.numel()
            update_share = moved / total
            placed = mesh_w = off = None
            check(update_share <= LAUNCH_UPDATE_SHARE,
                  f"[launch] {arch}: step one's update on the mesh off the meshless one in "
                  f"{update_share:.2e} of the entries (limit {LAUNCH_UPDATE_SHARE:.0e})")
    del ref, state, step
    torch.cuda.empty_cache()
    log(f"[launch] {arch}: step one mesh against meshless {first_s:.1f} s, {LAUNCH_STEPS} "
        f"meshless steps {sum(walls):.1f} s")
    t0 = time.perf_counter()
    res = train(cfg, mesh, steps=LAUNCH_STEPS, seq=LAUNCH_SEQ, batch=LAUNCH_BATCH,
                ckpt_dir=None, device=device, params=clone(params), learning_rate=lr)
    driver_s = time.perf_counter() - t0
    hist = res.metrics_history
    losses = [h["loss"] for h in hist]
    with torch.no_grad():
        before = float(loss_fn(model, params, batches[0], None, tc)[0])
        trained = res.params.map(lambda _, w: w.full_tensor())
        after = float(loss_fn(model, trained, batches[0], None, tc)[0])
    drift = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_ref))
    p50_mesh = float(np.median([h["sec"] for h in hist[1:]])) * 1e3
    p50_ref = float(np.median(walls[1:])) * 1e3
    log(f"[launch] {arch} uncut float32 {opts or ''} on the (1, 1) NCCL mesh: step one loss "
        f"{float(loss_ref):.6f}, mesh off meshless by {loss_err:.2e} (loss) and {errs[worst]:.2e} "
        f"(worst gradient leaf, {worst}); {'bitwise' if bitwise else 'not bitwise'}; its update "
        f"off by more than {LAUNCH_UPDATE_ATOL:.0e} x lr in {update_share:.2e} of the entries "
        f"(limit {LAUNCH_UPDATE_SHARE:.0e}); lr {lr}; "
        f"{first_s:.1f} s for both (DTensor's first dispatch of each op included)")
    log(f"[launch] {arch}: driver {LAUNCH_STEPS} steps of {LAUNCH_BATCH} x {LAUNCH_SEQ} tokens "
        f"in {driver_s:.1f} s (first step {hist[0]['sec']:.2f} s); loss "
        + " ".join(f"{v:.4f}" for v in losses) + f"; meshless steps' losses off by "
        f"{drift:.2e} at most (limit {LAUNCH_LOSS_TOL:.0e}); loss on "
        f"step 0's batch {before:.4f} -> {after:.4f}; step wall p50 {p50_mesh:.1f} ms on the mesh "
        f"(DTensor dispatch) against {p50_ref:.1f} ms meshless, steps 2 to {LAUNCH_STEPS}, "
        f"host clock [{where}]")
    check(len(hist) == LAUNCH_STEPS and all(np.isfinite(losses)),
          f"[launch] {arch}: the driver ran {len(hist)} steps, losses {losses}")
    check(drift <= LAUNCH_LOSS_TOL, f"[launch] {arch}: the driver's losses off the meshless "
          f"steps' by {drift:.2e} (limit {LAUNCH_LOSS_TOL:.0e})")
    check(after < before, f"[launch] {arch}: loss on step 0's batch {before:.4f} -> {after:.4f} "
          f"after {LAUNCH_STEPS} driver steps did not fall")
    del params, trained, res
    torch.cuda.empty_cache()
    return {"p50_mesh_ms": p50_mesh, "p50_ms": p50_ref, "driver_s": driver_s, "drift": drift,
            "update_share": update_share}


def launch_checkpoints(mesh, device, where: str) -> None:
    """The driver with its checkpoints, at LAUNCH_CKPT_ARCH's .reduced()
    size: LAUNCH_STEPS steps, then again on the same directory, which
    restores the last checkpoint and runs no step, as the reference's
    loop does."""
    import tempfile

    from repro_torch.config import get_arch
    from repro_torch.launch.train import train

    cfg = get_arch(LAUNCH_CKPT_ARCH).reduced()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res = train(cfg, mesh, steps=LAUNCH_STEPS, seq=LAUNCH_SEQ, batch=LAUNCH_BATCH,
                    ckpt_dir=d, device=device)
        run_s = time.perf_counter() - t0
        saved = sorted(os.listdir(d))
        again = train(cfg, mesh, steps=LAUNCH_STEPS, seq=LAUNCH_SEQ, batch=LAUNCH_BATCH,
                      ckpt_dir=d, device=device)
    same = all(torch.equal(a.full_tensor(), b.full_tensor())
               for a, b in zip(res.params.parameters(), again.params.parameters()))
    check(len(res.metrics_history) == LAUNCH_STEPS and not again.metrics_history and same
          and again.final_step == LAUNCH_STEPS,
          f"[launch] the driver's checkpoints: {saved}, a second run restored step "
          f"{again.final_step} with {len(again.metrics_history)} steps")
    log(f"[launch] the driver with checkpoints ({LAUNCH_CKPT_ARCH} reduced): {LAUNCH_STEPS} "
        f"steps in {run_s:.1f} s, checkpoints {saved}; a second run on the directory restored "
        f"step {again.final_step} bitwise and ran no step [{where}]")


def launch_placement(mesh, seed: int) -> None:
    """``reshard_tree`` with ``P("model")`` on the one-rank mesh, a
    checkpoint, then ``elastic_restart`` onto the mesh: ``np.asarray``
    bitwise the tree, the leaves DTensors of the spec's placements."""
    import tempfile

    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import elastic_restart, reshard_tree
    from repro_torch.runtime.elastic import P

    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((4096, 4096)).astype(np.float32),
            "b": rng.standard_normal(4096).astype(np.float32)}

    def spec(key, leaf):
        return P("model") if np.ndim(leaf) == 2 else P()

    placed = reshard_tree(tree, mesh, spec)
    check(isinstance(placed["w"], DTensor) and placed["w"].placements[1] == Shard(0)
          and placed["w"].to_local().is_cuda,
          f"[launch] reshard_tree placed {type(placed['w']).__name__}")
    check(np.array_equal(np.asarray(placed["w"]), tree["w"]), "[launch] reshard_tree not bitwise")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, placed)
        restored, step = elastic_restart(mgr, tree, mesh, spec)
    check(step == 3 and all(np.array_equal(np.asarray(restored[k]), tree[k]) for k in tree),
          "[launch] elastic_restart is not bitwise the tree")
    log(f"[launch] placement: reshard_tree with P('model') on the one-rank mesh, a checkpoint, "
        f"elastic_restart: bitwise, {restored['w'].placements} on {restored['w'].device}")


def launch_dryrun(where: str) -> None:
    """The dry-run's DRYRUN_CELLS on the production (16, 16) mesh, in a
    process of their own (a fake group of 256 ranks, meta tensors) with
    its own time limit; their terms on the card's constants."""
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            f"for arch, shape in {DRYRUN_CELLS!r}:\n"
            "    cell = dryrun.run_cell(arch, shape)\n"
            "    print(json.dumps({k: v for k, v in cell.items() if k != 'trace'}), flush=True)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"[launch] the dry-run failed: {out.stdout[-1500:]} "
          f"{out.stderr[-1500:]}")
    cells = [json.loads(line) for line in out.stdout.strip().splitlines()
             if line.startswith("{")]
    check(len(cells) == len(DRYRUN_CELLS), f"[launch] the dry-run wrote {len(cells)} cells")
    for cell in cells:
        check(cell["status"] == "ok", f"[launch] dry-run of {cell['arch']} {cell['shape']}: "
              f"{cell['status']} {cell.get('error', '')}")
        log(f"[launch] dry-run {cell['arch']} {cell['shape']} {cell['mesh']} ({cell['chips']} "
            f"fake ranks, meta tensors, full depth): the counted step {cell['compile_s']} s; per "
            f"device {cell['flops_per_device']:.4g} FLOPs, {cell['bytes_per_device']:.4g} bytes, "
            f"{cell['collective_bytes_per_device']:.4g} collective wire bytes "
            f"{cell['collective_counts']}; terms compute {cell['compute_term_s']:.4g} s, memory "
            f"{cell['memory_term_s']:.4g} s, collective {cell['collective_term_s']:.4g} s at "
            f"{PEAK_BF16_FLOPS:.3g} FLOP/s, {PEAK_BYTES_PER_S:.3g} B/s HBM, "
            f"{LINK_BW:.3g} B/s NVLink; dominant {cell['dominant']}, mfu {cell['mfu']:.4f}, "
            f"useful FLOP ratio {cell['useful_flop_ratio']:.4f}; argument bytes per device "
            f"{cell['memory']['argument_bytes_per_device']:.4g} [the card's constants; run on "
            f"{where}'s host]")
    log(f"[launch] dry-run: {len(cells)} cells in {wall:.1f} s in all")


def launch_roofline(step_ms: float, seed: int, device, where: str) -> None:
    """``step_costs`` of qwen3-1.7b's bf16 train step (remat "none") at
    [lm train]'s TRAIN_BATCH x TRAIN_SEQ tokens on the card: its compute
    and memory terms beside the step time [lm train] measured."""
    from repro_torch.config import ShapeConfig, TrainConfig, get_arch
    from repro_torch.data import make_batch
    from repro_torch.models import build
    from repro_torch.optim import init_opt
    from repro_torch.roofline import roofline_terms, step_costs
    from repro_torch.train import make_train_step

    cfg = get_arch("qwen3-1.7b")
    model = build(cfg)
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in make_batch(cfg, shape, seed=seed, step=0).items()}
    params = model.init(torch.Generator(device=device).manual_seed(seed), device=device)
    tc = TrainConfig(remat="none", learning_rate=TRAIN_LR, warmup_steps=2, total_steps=100)
    costs, coll, _ = step_costs(make_train_step(model, tc), params, init_opt(params), batch)
    torch.cuda.synchronize()
    terms = roofline_terms(hlo_flops=costs["flops"], hlo_bytes=costs["bytes accessed"],
                           collective_bytes=coll.wire_bytes, chips=1, cfg=cfg, shape=shape)
    bound_ms = max(terms.compute_s, terms.memory_s) * 1e3
    log(f"[launch] roofline of qwen3-1.7b's bf16 train step (remat none, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens) by step_costs: {costs['flops']:.4g} FLOPs, "
        f"{costs['bytes accessed']:.4g} bytes (every op's inputs and outputs: no fusion), "
        f"{coll.total_count} collectives; compute term {terms.compute_s * 1e3:.2f} ms at "
        f"{PEAK_BF16_FLOPS:.3g} FLOP/s, memory term {terms.memory_s * 1e3:.2f} ms at "
        f"{PEAK_BYTES_PER_S:.3g} B/s, bound by {terms.dominant}; the step [lm train] measured "
        f"{step_ms:.1f} ms (CUDA events) is {bound_ms / step_ms:.1%} of bound; model FLOPs "
        f"{terms.model_flops:.4g} ({terms.useful_flop_ratio:.1%} of counted) [{where}]")
    del params
    torch.cuda.empty_cache()


def phase_launch(card: dict, seed: int, device, train_step_ms: dict) -> None:
    from repro_torch.kernels.attn import flash_attention
    from repro_torch.kernels.gmm import grouped_matmul
    from repro_torch.kernels.spmv import bell_spmm
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import process_group

    where = card["smi"]
    t_phase = time.perf_counter()
    counters = (bell_spmm, grouped_matmul, flash_attention)
    for k in counters:
        k.launches = 0
    parts = {}
    with process_group(device):  # one NCCL rank on a file store: NCCL takes a card a rank
        mesh = make_test_mesh(1, 1, device_type="cuda")
        for arch, opts, lr in LAUNCH_ARCHS:
            launch_train(arch, opts, lr, mesh, seed, device, where)
            parts[arch] = time.perf_counter() - t_phase - sum(parts.values())
        launch_checkpoints(mesh, device, where)
        parts["checkpoints"] = time.perf_counter() - t_phase - sum(parts.values())
        launch_placement(mesh, seed)
        parts["placement"] = time.perf_counter() - t_phase - sum(parts.values())
    launch_dryrun(where)
    parts["dry-run"] = time.perf_counter() - t_phase - sum(parts.values())
    launch_roofline(train_step_ms["qwen3-1.7b"]["none"], seed, device, where)
    parts["roofline"] = time.perf_counter() - t_phase - sum(parts.values())
    launched = {k.__name__: k.launches for k in counters}
    check(not any(launched.values()), f"[launch] a kernel of the port ran: {launched}")
    log(f"[launch] phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + f"); kernel launches "
        f"{launched}: the launch layer calls no kernel of the port, as the reference's calls no "
        f"Pallas kernel; multi-rank meshes are verified on gloo CPU ranks only (NCCL takes one "
        f"rank per card)")
    torch.cuda.empty_cache()


# -- phase 12: times ---------------------------------------------------------


def bsr_library_ms(bt, xb, reps):
    """Time of one PyTorch call computing the same stacked product — the
    replicated tile set as one BSR matrix of U·NRB block-rows times the
    blocked x — and the name of the call used."""
    u_n, _, bm, bn = bt.tiles.shape
    counts = torch.as_tensor(bt.counts, device=bt.tiles.device)
    real = torch.arange(bt.tiles.shape[1], device=bt.tiles.device)[None, :] < counts[:, None]
    values = bt.tiles[real]  # [nnzb, bm, bn], unit-major, row-sorted
    cols = bt.tile_src[real].long()
    per_row = bt.row_ptr[:, 1:] - bt.row_ptr[:, :-1]  # [U, NRB]
    crow = torch.zeros(u_n * bt.nrb + 1, dtype=torch.long, device=values.device)
    crow[1:] = torch.cumsum(per_row.reshape(-1).long(), 0)
    ncb = xb.shape[0]
    shape = (u_n * bt.nrb * bm, ncb * bn)
    dense_x = xb.reshape(ncb * bn, -1)
    mat = torch.sparse_bsr_tensor(crow, cols, values, size=shape)
    try:
        ms = cuda_ms(lambda: torch.sparse.mm(mat, dense_x), reps)
        return ms, "torch.sparse.mm(BSR float32)"
    except (RuntimeError, NotImplementedError) as e:
        log(f"[times] torch.sparse.mm refused BSR float32 on the card ({e}); using CSR")
        csr = mat.to_sparse_csr()
        ms = cuda_ms(lambda: torch.sparse.mm(csr, dense_x), reps)
        return ms, "torch.sparse.mm(CSR float32)"


def ring_stream_times(label: str, bt, ncb: int, batches, where: str) -> None:
    """``ring`` beside ``stream`` on one plan's tiles, each by its C entry
    point with its arguments built once (``ring`` at the B it is built
    for), with the variant the wrapper chooses, each time's share of the
    bound, and the two bitwise equal."""
    from repro_torch.kernels.spmv import spmm_variant
    from repro_torch.kernels.spmv.ops import RING_MAX_BATCH

    u_n, _, bm, bn = bt.tiles.shape
    dtype, esize, real = bt.tiles.dtype, bt.tiles.element_size(), bt.real_tiles
    rng = np.random.default_rng(2)
    for b in batches:
        xsrc = torch.as_tensor(rng.standard_normal((1, ncb, bn, b)).astype(np.float32),
                               device=bt.tiles.device).to(dtype)
        ran = ("ring", "stream") if b <= RING_MAX_BATCH else ("stream",)
        ms = {v: cuda_ms(spmm_launcher(v, bt, xsrc)[0], 20) for v in ran}
        if "ring" in ms:
            check(torch.equal(spmm_entry("ring", bt, xsrc), spmm_entry("stream", bt, xsrc)),
                  f"[times] ring and stream differ on {label} {dtype} B={b}")
        bytes_moved = (real * bm * bn * esize + real * 4 + u_n * (bt.nrb + 1) * 4
                       + xsrc.numel() * esize + u_n * bt.nrb * bm * b * 4)
        bound_ms, bound_by = bound(bytes_moved, 2.0 * real * bm * bn * b, torch.float32)
        log(f"[times] bell_spmm {label} ({bm}x{bn} {dtype}, real {real}) B={b}: "
            + ", ".join(f"{v} {t:.4f} ms ({bound_ms / t:.1%} of bound)" for v, t in ms.items())
            + (f", ring / stream {ms['ring'] / ms['stream']:.3f}" if "ring" in ms else "")
            + f"; chosen {spmm_variant(dtype, bm, bn, b)}; bound {bound_ms:.4f} ms "
            f"({bound_by}, {bytes_moved / 1e6:.1f} MB) [{where}]")


def phase_times(main: dict, card: dict, device) -> list:
    from repro_torch.kernels.spmv import bell_spmm, bell_spmm_plain, bell_tiles, spmm_variant
    import repro_torch.pmvc.dist as dist_mod
    from repro_torch.pmvc.dist import hoist_tiles, pad_x, unit_sum
    from repro_torch.train.step import deterministic

    sess = main["sessions"]["replicated"]
    dp = sess.device_plan
    nrb = dp.num_row_blocks
    bt = bell_tiles(hoist_tiles(dp.tiles, device=device), dp.tile_row, dp.tile_col,
                    dp.real_tiles, nrb)
    u_n, _, bm, bn = bt.tiles.shape
    real = bt.real_tiles
    where = f"{card['smi']}"
    rows = []
    rng = np.random.default_rng(1)
    for b in SPMV_BATCHES:
        x = torch.as_tensor(rng.standard_normal((b, dp.shape[1])).astype(np.float32),
                            device=device)
        xb = pad_x(x, dp.num_col_blocks, bn)  # [NCB, bn, B]
        xsrc = xb[None]
        reps = 20
        ms = cuda_ms(lambda: bell_spmm(bt, xsrc), reps)
        old_ms = cuda_ms(spmm_launcher("simt", bt, xsrc)[0], reps)
        stream_ms = cuda_ms(spmm_launcher("stream", bt, xsrc)[0], reps)
        partials = bell_spmm(bt, xsrc)
        sum_ms = cuda_ms(lambda: unit_sum(partials), reps)  # the executor's unit sum
        # The unit sum it replaced, a cumsum over the units (refused under
        # deterministic mode on CUDA): its time, and whether the two agree.
        cumsum_ms = cuda_ms(lambda: partials.cumsum(dim=0)[-1].clone(), reps)
        sum_same = bool(torch.equal(unit_sum(partials), partials.cumsum(dim=0)[-1]))
        del partials
        plain_ms = cuda_ms(lambda: bell_spmm_plain(bt.tiles, bt.tile_row, bt.tile_src,
                                                   bt.counts, xsrc, nrb), 5, warmup=1)
        lib_ms, lib_name = bsr_library_ms(bt, xb, reps)
        y = bell_spmm(bt, xsrc)
        y_plain = bell_spmm_plain(bt.tiles, bt.tile_row, bt.tile_src, bt.counts, xsrc, nrb)
        err = float((y - y_plain).abs().max())
        check(scaled_err(y, y_plain) <= TOL_F32,
              f"bell_spmm vs plain at the main path's shapes B={b}: {err:.2e}")
        bytes_moved = (real * bm * bn * 4  # real tiles, read once
                       + real * 4 + u_n * (nrb + 1) * 4  # tile_src, row_ptr
                       + xsrc.numel() * 4  # x source
                       + u_n * nrb * bm * b * 4)  # partials written
        flops = 2.0 * real * bm * bn * b
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_flops)
        variant = spmm_variant(bt.tiles.dtype, bm, bn, b)
        rows.append({"B": b, "variant": variant, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                     "library_ms": lib_ms, "library_call": lib_name,
                     "max_abs_err": err, "bytes": bytes_moved, "flops": flops,
                     "simt_ms": old_ms, "stream_ms": stream_ms, "sum_ms": sum_ms,
                     "cumsum_ms": cumsum_ms,
                     "sum_same": sum_same})
        log(f"[times] bell_spmm U={u_n} T={bt.tiles.shape[1]} real={real} ({bm}x{bn}) "
            f"B={b}: kernel ({variant}) {ms:.4f} ms, stream variant {stream_ms:.4f} ms, "
            f"simt variant {old_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms "
            f"({rows[-1]['bound_by']}; {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{bound_ms / ms:.1%} of bound, plain {plain_ms:.4f} ms, "
            f"{lib_name} {lib_ms:.4f} ms, max |kernel - plain| {err:.3e} [{where}]")

    def cumsum_unit_sum(partials):
        return partials.cumsum(dim=0)[-1].clone()

    by_b = {r["B"]: r for r in rows}
    for ex, s in main["sessions"].items():
        mv = s.device_spmm()
        for b in SPMV_BATCHES:
            x_np = rng.standard_normal((b, dp.shape[1])).astype(np.float32)
            x = torch.as_tensor(x_np, device=device)
            dev_ms = cuda_ms(lambda: mv(x), 10)
            with deterministic():
                y_det = mv(x)
            check(torch.equal(y_det, mv(x)), f"[times] spmv {ex} B={b} under deterministic "
                  f"mode is not bitwise the spmv outside it")
            if ex == "replicated":
                # The spmv's device time with the unit sum the loop of adds
                # replaced (a cumsum over the units, put back in the
                # executor's module for the measurement), in turns with the
                # loop: after, before, before, after.
                dist_mod.unit_sum = cumsum_unit_sum
                try:
                    before_ms = [cuda_ms(lambda: mv(x), 10) for _ in range(2)]
                finally:
                    dist_mod.unit_sum = unit_sum
                after_ms = [dev_ms, cuda_ms(lambda: mv(x), 10)]
                log(f"[times] spmv replicated B={b}: device ms with the unit sum as a loop of "
                    f"adds {after_ms[0]:.4f}, {after_ms[1]:.4f} (mean {np.mean(after_ms):.4f}); "
                    f"with the cumsum it replaced {before_ms[0]:.4f}, {before_ms[1]:.4f} (mean "
                    f"{np.mean(before_ms):.4f}), in turns after, before, before, after "
                    f"[{where}]")
                r = by_b[b]
                log(f"[times] spmv replicated B={b}: of its device time {dev_ms:.4f} ms the "
                    f"kernel takes {r['ms'] / dev_ms:.1%} ({r['ms']:.4f} ms), the unit sum "
                    f"unit_sum {r['sum_ms'] / dev_ms:.1%} ({r['sum_ms']:.4f} ms; the cumsum it "
                    f"replaced {r['cumsum_ms']:.4f} ms, bitwise equal to it: "
                    f"{'yes' if r['sum_same'] else 'no'}), the rest (padding x, unblocking y) "
                    f"{(dev_ms - r['ms'] - r['sum_ms']) / dev_ms:.1%}; the spmv inside "
                    f"deterministic() bitwise the spmv outside it [{where}]")
            else:
                r = by_b[b]
                log(f"[times] spmv {ex} B={b}: device {dev_ms:.4f} ms less the replicated "
                    f"kernel and unit sum ({r['ms'] + r['sum_ms']:.4f} ms) leaves "
                    f"{dev_ms - r['ms'] - r['sum_ms']:.4f} ms "
                    f"({(dev_ms - r['ms'] - r['sum_ms']) / dev_ms:.1%}) for the exchange's "
                    f"gathers [{where}]")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                s.spmv(x_np)
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**20
            log(f"[times] spmv {ex} B={b}: device {dev_ms:.4f} ms, wall {wall_ms:.3f} ms "
                f"(numpy in and out), peak device memory {peak:.0f} MiB [{where}]")
    # ring beside stream on the banded plan, float32 above and float16 here.
    ring_stream_times("banded", bt, dp.num_col_blocks, RING_TIME_BATCHES, where)
    bt16 = bell_tiles(hoist_tiles(dp.tiles, device=device).to(torch.float16), dp.tile_row,
                      dp.tile_col, dp.real_tiles, nrb)
    ring_stream_times("banded", bt16, dp.num_col_blocks, (1, 8), where)
    del bt16
    # A measurement for the serving path, not a check: is the whole spmv,
    # unit sum included, column-stable in B on CUDA?
    mv = main["sessions"]["replicated"].device_spmm()
    x = torch.as_tensor(rng.standard_normal((64, dp.shape[1])).astype(np.float32), device=device)
    y = mv(x)
    same = sum(bool(torch.equal(y[j:j + 1], mv(x[j:j + 1]))) for j in range(64))
    log(f"[times] spmv replicated: column j of B=64 bitwise the B=1 spmv for {same} of 64 "
        f"columns (unit_sum, a loop of adds over the units, on CUDA) [{where}]")
    return rows


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    """(bound ms, what sets it): the larger of the bytes over the HBM rate
    and the operations over the peak for the input type."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / peak * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def grouped_mm_ms(x, w, offs, y_ref):
    """Time of ``torch._grouped_mm`` on the same rows, groups and weights
    (output in the input type: this torch refuses a float32 output for bf16
    inputs), where this torch has it; else (None, the reason)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm absent"
    try:
        err = float((fn(x, w, offs=offs).float() - y_ref).abs().max())
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:160]
    if err > 1e-1:
        return None, f"disagrees with the kernel by {err:.2e}"
    return cuda_ms(lambda: fn(x, w, offs=offs), 10), f"{x.dtype} in, {x.dtype} out"


def variant_ms(lib_name: str, fn_name: str, *args, reps: int = 3) -> float:
    """Time of one variant on the same arguments, by its C entry point (the
    wrapper would choose a newer variant at these shapes): an earlier
    slice's kernel, compared within this run."""
    if lib_name == "gmm":
        from repro_torch.kernels.gmm.ops import _library
    else:
        from repro_torch.kernels.attn.ops import _library
    fn = getattr(_library(), fn_name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def run():
        check(fn(*ptrs, torch.cuda.current_stream().cuda_stream) == 0, f"{fn_name} launch failed")

    return cuda_ms(run, reps, warmup=1)


def phase_times_gmm(moe: dict, card: dict) -> list:
    from repro_torch.kernels.gmm import gmm_plain, gmm_variant, grouped_matmul

    gid = moe["gid"]
    offs = torch.as_tensor(np.cumsum(moe["padded"]), dtype=torch.int32, device=gid.device)
    rows = []
    for (name, dtype), (x, w, err) in moe["products"].items():
        m, k = x.shape
        n = w.shape[2]

        def kernel(x=x, w=w):
            return grouped_matmul(x, w, gid, bm=GMM_BM, bk=GMM_BM, bn=GMM_BM,
                                  out_dtype=torch.float32)

        ms = cuda_ms(kernel, 10)
        # The kernel with the library call's output type, for a like-for-like
        # comparison where that call cannot write float32.
        ms_same_out = cuda_ms(lambda x=x, w=w: grouped_matmul(
            x, w, gid, bm=GMM_BM, bk=GMM_BM, bn=GMM_BM, out_dtype=x.dtype), 10)
        plain_ms = cuda_ms(lambda x=x, w=w: gmm_plain(x, w, gid, bm=GMM_BM), 3, warmup=1)
        variant = gmm_variant(dtype, GMM_BM, k, n)
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        old_ms = variant_ms("gmm", f"gmm_simt_{'bf16' if dtype == torch.bfloat16 else 'f32'}_f32",
                            x, w, gid, out, m, k, n, w.shape[0], GMM_BM)
        del out
        w_sel = w[gid.long()]  # the gather stays outside the timed call
        x3 = x.view(-1, GMM_BM, k)
        bmm_ms = cuda_ms(lambda: torch.bmm(x3, w_sel), 10)
        del w_sel
        gmm_ms, gmm_how = grouped_mm_ms(x, w, offs, kernel()) if dtype == torch.bfloat16 \
            else (None, "bf16 only")
        bytes_moved = (x.numel() * x.element_size() + w.numel() * w.element_size()
                       + gid.numel() * 4 + m * n * 4)
        flops = 2.0 * m * k * n
        bound_ms, bound_by = bound(bytes_moved, flops, dtype)
        lib_ms, lib_name = ((gmm_ms, f"torch._grouped_mm ({gmm_how})") if gmm_ms is not None
                            else (bmm_ms, f"torch.bmm over the gathered weights "
                                          f"({dtype} in, {dtype} out)"))
        rows.append({"name": name, "dtype": dtype, "variant": variant, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "library_call": lib_name, "max_abs_err": err,
                     "simt_ms": old_ms})
        log(f"[times] gmm {name} {dtype} -> float32 x [{m}, {k}] w {list(w.shape)}: "
            f"kernel ({variant}) {ms:.4f} ms ({ms_same_out:.4f} ms with {dtype} out), "
            f"simt variant {old_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; "
            f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), {bound_ms / ms:.1%} of bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s, plain {plain_ms:.4f} ms, torch.bmm {bmm_ms:.4f} ms, "
            f"torch._grouped_mm "
            f"{'%.4f ms' % gmm_ms if gmm_ms is not None else 'not run'} ({gmm_how}); "
            f"library_ms = {lib_name} [{card['smi']}]")
    return rows


def visible_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one [S, T] score matrix that the mask keeps."""
    q = np.arange(s, dtype=np.int64)
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(q - window, 0) if window > 0 else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def sdpa_ms(q, k, v, s, window, heads):
    """Time of ``scaled_dot_product_attention`` on the same q, k, v (as
    [B, H, S, D]) and the backend that ran: ``is_causal`` for the causal
    mask, a boolean ``attn_mask`` with a window."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.attn import attention_mask

    q4, k4, v4 = (a.view(-1, heads, s, a.shape[-1]) for a in (q, k, v))
    kw = {"is_causal": True}
    if window > 0:
        kw = {"attn_mask": attention_mask(s, s, causal=True, window=window, device=q.device)}
    failed = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # each refusal warns
                torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, **kw)
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, **kw), 5)
            return ms, backend.name, failed
        except RuntimeError:
            failed.append(backend.name)
    return None, "none", failed


def phase_times_attn(attn: dict, card: dict) -> list:
    from repro_torch.kernels.attn import attention_plain, attention_variant, mha

    rows = []
    for run in attn["runs"]:
        q, k, v = run["qkv"]
        kw = run["kw"]
        bh, s, d = q.shape
        variant = attention_variant(q.dtype, d, kw["bq"], kw["bkv"])
        ms = cuda_ms(lambda: mha(q, k, v, **kw), 10, warmup=1)

        def plain():  # four BH rows at a time: the [4, S, S] float32 scores fit
            for i in range(0, bh, 4):
                attention_plain(q[i:i + 4], k[i:i + 4], v[i:i + 4], **kw)

        plain_ms = cuda_ms(plain, 1, warmup=1)
        # The earlier variants on the same arguments, then the kernel again:
        # kernel, earlier ones, kernel, all within this run on this card.
        tname = "bf16" if q.dtype == torch.bfloat16 else "f32"
        o = torch.empty_like(q)
        others = {other: variant_ms("attn", f"flash_attention_{other}_{tname}", q, k, v, o, bh,
                                    s, s, d, kw["bq"], kw["bkv"], 1, kw["window"],
                                    ctypes.c_float(d**-0.5), reps=10 if other == "mma" else 3)
                  for other in (("mma", "simt") if q.dtype == torch.bfloat16 else ("simt",))}
        del o
        ms_again = cuda_ms(lambda: mha(q, k, v, **kw), 10, warmup=1)
        lib_ms, backend, failed = sdpa_ms(q, k, v, s, kw["window"], run["heads"])
        pairs = visible_pairs(s, s, True, kw["window"]) * bh
        flops = 4.0 * d * pairs
        bytes_moved = 4 * q.numel() * q.element_size()  # q, k, v read, o written
        bound_ms, bound_by = bound(bytes_moved, flops, q.dtype)
        rows.append({"name": run["name"], "dtype": q.dtype, "variant": variant, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms,
                     "library_call": f"scaled_dot_product_attention ({backend}, {q.dtype})",
                     "max_abs_err": run["err"], "simt_ms": others["simt"],
                     "mma_ms": others.get("mma")})

        def rate(t, bound_ms=bound_ms, flops=flops) -> str:
            return f"{t:.4f} ms ({bound_ms / t:.1%} of bound, {flops / t / 1e9:.1f} TFLOP/s)"

        log(f"[times] flash_attention {run['name']} {q.dtype} [BH={bh}, S={s}, D={d}]: "
            f"kernel ({variant}) {rate(ms)} (again after the others: {ms_again:.4f} ms), "
            + "".join(f"{other} variant {rate(t)}, " for other, t in others.items())
            + f"bound {bound_ms:.4f} ms ({bound_by}; {pairs} visible pairs, "
            f"{flops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.1f} MB), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention "
            f"{rate(lib_ms) if lib_ms is not None else 'not run'} "
            f"(backend {backend}; refused: {failed or 'none'}) [{card['smi']}]")
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the [serve] phase's requests (default 0)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present; this script runs on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    main_path = phase_main_path(device)
    serve = phase_serve(main_path, card, args.seed)
    plans = phase_plans(main_path, card, args.seed, device)
    faults = phase_faults(main_path, plans, card, args.seed)
    dist_run = phase_dist(main_path, card, device)
    moe = phase_lm_moe(device)
    attn = phase_lm_attention(device)
    phase_lm_serve(card, args.seed, device)
    train_step_ms = phase_lm_train(card, args.seed, device)
    phase_launch(card, args.seed, device, train_step_ms)
    rows = phase_times(main_path, card, device)
    gmm_rows = phase_times_gmm(moe, card)
    attn_rows = phase_times_attn(attn, card)
    head = next(r for r in rows if r["B"] == 8)
    # The head rows: the granite gate product in bf16 -> float32, and the
    # granite causal prefill in bf16.
    gmm_head = next(r for r in gmm_rows if r["name"] == "gate" and r["dtype"] == torch.bfloat16)
    attn_head = attn_rows[0]
    kernels = [{
        "name": "bell_spmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bell_spmm.cu",
        "replaces": "src/repro/kernels/spmv/kernel.py:74",
        "launches": sum(p["launches"] for p in (main_path, serve, plans, faults, dist_run)),
        "variant": head["variant"],
        "variant_launches": {v: sum(p["variant_launches"][v]
                                    for p in (main_path, serve, plans, faults, dist_run))
                             for v in main_path["variant_launches"]},
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": head["library_call"],
        "simt_ms": head["simt_ms"],
    }]
    for name, source, replaces, path, r in (
        ("gmm", "src/repro_torch/kernels/csrc/gmm.cu", "src/repro/kernels/gmm/kernel.py:53",
         moe, gmm_head),
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/attn/kernel.py:110", attn, attn_head),
    ):
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": path["launches"], "variant": r["variant"],
                        "variant_launches": path["variant_launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "library_call": r["library_call"], "simt_ms": r["simt_ms"],
                        **({"mma_ms": r["mma_ms"]} if "mma_ms" in r else {})})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
