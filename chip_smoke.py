#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which stops the run with a non-zero exit when it fails:

1. **card** — the device's name and count, and ``nvidia-smi``'s name and
   power limit;
2. **build** — the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``bell_spmm``, ``gmm``, ``flash_attention``), all ``nvcc`` processes
   started together, with ``-Xptxas -v``'s registers and spills;
3. **kernel** — every kernel against its plain PyTorch version on the
   card over a sweep of shapes and types, two launches bitwise equal:
   ``bell_spmm`` over tile shapes (up to 32 × 32 on its ``stream``
   variant, larger on ``simt``, and shapes off that grid — 24 × 16 on
   ``stream``, 16 × 24 and 12 × 12 on ``simt``) and batch widths (each
   launch on the variant ``spmm_variant`` names, column j of every B
   bitwise the B = 1 launch on column j, and a ``stream`` result bitwise
   the ``simt`` kernel's on the same inputs), ``gmm`` over the
   reference tests' shapes and shapes that reach its ``wgmma`` and
   ``regblock`` variants × {f32, bf16} in × {f32, bf16} out,
   ``flash_attention`` over the reference tests' masks and tiles × D in
   {16, 80} × {f32, bf16}, D in {64, 128} at 128 × 128 tiles, T ≠ S
   cases (rows that see no key, on every variant) and a shape of the
   ``simt`` variant in each type, held against the plain version with
   the kernel's tiles; every variant of each kernel must have run;
4. **main path** — ``distribute`` → ``spmv`` → ``solve`` at the repo's
   headline scale config (banded 60,000 × 60,000 with 1.2 M non-zeros,
   ``Topology(4, 4)``, ``NL-HC``, block 16, seed 0) for the replicated,
   selective and ``overlap:2`` exchanges, held against the float64 CSR
   ``reference`` executor; each kernel's launch counter, set to 0 just
   before a path runs, must have risen on it, on ``stream`` alone;
5. **serve** — the serving path on the main path's sessions (nothing
   re-planned), for each exchange: one ``SparseServeEngine``
   (``batch_slots`` 8, 20 iterations, ``A`` as ``a`` and the SPD matrix
   as ``spd``) serves 64 requests from 4 tenants, made from ``--seed``
   (pagerank with sparse seeds and spmv on ``a``, jacobi and cg on
   ``spd``), ticked until drained; every result must be bitwise its
   direct batched-of-1 solve on the same session, the B = 8 spmv's
   columns bitwise the B = 1 spmv, one request per solver within 1e-4 of
   the float64 CSR oracle's direct solve, every ``bell_spmm`` launch
   ``stream``, and the same requests through a ``ServeDriver`` thread
   bitwise the same; it prints the tick wall time and its split between
   the spmv calls and the steppers' host arithmetic, one lane step's
   time by solver, the device time (CUDA events around each lane step's
   spmv), the device's idle share, requests per second against the 64
   direct solves in sequence, latency, and peak device memory;
6. **lm kernels** — the other two kernels on their own entry points at
   the full width of the repo's language-model configs: the MoE expert
   FFN of granite-moe-1b-a400m (``plan_groups`` → gather → three
   ``grouped_matmul`` calls, bf16 and f32), its causal prefill
   attention, and h2o-danube-1.8b's sliding-window prefill (``mha``),
   the attention in bf16 and f32, each held against its plain version
   (bf16 attention also to 2⁻⁶·|ref| + 2e-3 elementwise); each launch
   counter, set to 0 just before its path, must have risen on it, and
   so must the per-variant counts of the tensor-core variants (bf16) and
   of the register-blocked ones (f32), never those of ``simt``;
7. **times** — each kernel's time per launch at its path's shapes
   (CUDA events), its bound, its plain version's time, one PyTorch
   library call computing the same function, the ``simt`` variant's time
   at the same shapes (the kernels of the previous slices, compared within
   the run), the spmv wall time and peak device memory per exchange, the
   shares of the replicated spmv's device time taken by the kernel and by
   the unit sum, and — a measurement, not a check — whether column j of
   the replicated spmv at B = 64 is bitwise the B = 1 spmv.

Then one JSON line with the kernels' numbers, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. With no CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
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
# Tolerances are relative to the result's scale: max |y - y_ref| / max |y_ref|.
TOL_F32 = 1e-5  # kernel vs plain, and spmv vs the float64 CSR oracle
TOL_F16 = 2e-2  # float16 tiles and x, float32 accumulation
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and dense bf16 FLOP/s on the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# Tile shapes of the stream variant (bm, bn <= 32), then of simt, from
# kernels/spmv/ops.py's BLOCK_SIZES; then shapes off that grid, at fewer
# batch widths: (24, 16) on stream, the others on simt.
KERNEL_SWEEP = ((8, 8), (8, 16), (16, 16), (32, 32), (8, 128), (128, 128))
SWEEP_BATCHES = (1, 3, 8, 64)
OFF_GRID_SWEEP = ((24, 16), (16, 24), (12, 12))
OFF_GRID_BATCHES = (1, 8)
# The reference tests' tolerances, as rtol and atol: tests/test_kernels_gmm.py
# and tests/test_kernels_attn.py.
GMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
# (e, k, n, bm, bk, bn) of tests/test_kernels_gmm.py:9-13.
# (e, k, n, bm, bk, bn) of tests/test_kernels_gmm.py:9-13 (the simt variant),
# then shapes of the wgmma and regblock variants: N not a multiple of 256,
# 64-row blocks with a ragged N, the granite widths, K not a multiple of 64.
GMM_SWEEP = ((4, 32, 64, 8, 16, 32), (8, 64, 128, 16, 32, 64), (2, 16, 16, 8, 8, 8),
             (8, 256, 384, 128, 128, 128), (4, 512, 192, 64, 64, 64),
             (32, 1024, 512, 128, 128, 128), (4, 80, 256, 128, 16, 128))
# (causal, window) and (s, bq, bkv) of tests/test_kernels_attn.py:19-22.
ATTN_MASKS = ((True, 0), (False, 0), (True, 8), (True, 16), (True, 32))
ATTN_TILES = ((64, 16, 16), (128, 32, 16), (64, 64, 64))
# Further (causal, window, s, t, bq, bkv, d): D 64 and 128 at 128 × 128
# tiles; T ≠ S; T < S with a window, so rows from T + window on see no key
# (the plain version with the kernel's tiles is what the kernels compute
# there); D 24, which both types run on the simt variant; T < S with rows
# that see no key at 64 × 64 tiles, which float32 runs on regblock.
ATTN_EXTRA = ((True, 0, 256, 256, 128, 128, 64), (True, 32, 256, 256, 128, 128, 128),
              (False, 0, 256, 256, 128, 128, 128), (True, 16, 64, 192, 32, 64, 80),
              (True, 8, 128, 32, 32, 16, 80), (True, 8, 64, 64, 16, 16, 24),
              (True, 8, 256, 64, 64, 64, 80), (True, 4, 256, 64, 128, 64, 64))
# The [serve] phase: BENCH_serve.json's batch_slots and iters, 64 requests
# from 4 tenants.
SERVE_SLOTS = 8
SERVE_ITERS = 20
SERVE_REQUESTS = 64
SERVE_TENANTS = 4
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


def phase_build() -> None:
    from repro_torch.kernels.build import build

    t0 = time.perf_counter()
    libs = build(["bell_spmm", "gmm", "flash_attention"])
    log(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        usage = [ln.strip() for ln in lib.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {lib.name}: nvcc {lib.seconds:.2f} s -> {os.path.basename(lib.path)}")
        for ln in usage:
            log(f"[build]   {ln}")


# -- phase 3: kernel vs plain ------------------------------------------------


def random_tile_set(rng, u_n, nrb, bm, bn, nsrc, t_max):
    """A stacked tile set with ragged real counts, padding, rows in
    ascending order within each unit and random x sources."""
    counts = rng.integers(0, t_max + 1, size=u_n)
    counts[0] = t_max  # at least one full unit
    t = t_max + 2  # padding on every unit
    tiles = np.zeros((u_n, t, bm, bn), np.float32)
    rows = np.zeros((u_n, t), np.int32)
    src = np.zeros((u_n, t), np.int32)
    for u, c in enumerate(counts):
        tiles[u, :c] = rng.standard_normal((c, bm, bn))
        rows[u, :c] = np.sort(rng.integers(0, nrb, size=c))
        src[u, :c] = rng.integers(0, nsrc, size=c)
    return tiles, rows, src, counts


def spmm_simt(bt, xsrc) -> torch.Tensor:
    """The ``simt`` kernel on the same tile set and x, by its C entry
    point (the wrapper would choose ``stream`` at these shapes): the
    previous slice's kernel, for the cross-variant checks and times."""
    from repro_torch.kernels.spmv.ops import _library

    u_n, t_n, bm, bn = bt.tiles.shape
    batch = int(xsrc.shape[3])
    out = torch.empty((u_n, bt.nrb, bm, batch), dtype=torch.float32, device=bt.tiles.device)
    ustride = 0 if xsrc.shape[0] == 1 else int(xsrc.shape[1]) * bn * batch
    name = "f16" if bt.tiles.dtype == torch.float16 else "f32"
    rc = getattr(_library(), f"bell_spmm_simt_{name}")(
        bt.tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(), xsrc.data_ptr(),
        out.data_ptr(), u_n, t_n, bt.nrb, bm, bn, batch, ustride,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"bell_spmm_simt_{name} launch failed ({rc})")
    return out


def phase_kernel(device) -> None:
    from repro_torch.kernels.spmv import (
        VARIANTS,
        bell_spmm,
        bell_spmm_plain,
        bell_tiles,
        spmm_variant,
    )

    rng = np.random.default_rng(0)
    worst = 0.0
    before = dict(bell_spmm.variant_launches)
    sweep = [(bm, bn, SWEEP_BATCHES) for bm, bn in KERNEL_SWEEP]
    sweep += [(bm, bn, OFF_GRID_BATCHES) for bm, bn in OFF_GRID_SWEEP]
    for bm, bn, batches in sweep:
        tiles, rows, src, counts = random_tile_set(rng, 4, 24, bm, bn, 30, 40)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.float16, TOL_F16)):
            bt = bell_tiles(torch.as_tensor(tiles, device=device).to(dtype),
                            rows, src, counts, 24)
            for ux in (4, 1):  # per-unit sources, and one shared source
                xs = {b: torch.as_tensor(rng.standard_normal((ux, 30, bn, b)).astype(
                    np.float32), device=device).to(dtype) for b in batches}
                for b, x in xs.items():
                    variant = spmm_variant(dtype, bm, bn, b)
                    ran = bell_spmm.variant_launches[variant]
                    y = bell_spmm(bt, x)
                    check(bell_spmm.variant_launches[variant] == ran + 1,
                          f"bell_spmm ({bm},{bn}) B={b} {dtype} did not run on {variant}")
                    y_plain = bell_spmm_plain(bt.tiles, bt.tile_row, bt.tile_src,
                                              bt.counts, x, bt.nrb)
                    torch.cuda.synchronize()
                    err = scaled_err(y, y_plain)
                    check(err <= tol, f"bell_spmm vs plain ({bm},{bn}) B={b} {dtype}: "
                                      f"scaled err {err:.2e}")
                    if dtype == torch.float32:
                        worst = max(worst, err)
                    check(torch.equal(y, bell_spmm(bt, x)),
                          f"two launches differ ({bm},{bn}) B={b} {dtype}")
                    # One FMA chain in every variant and patch: column j of
                    # any B is bitwise the B = 1 launch, and stream is simt.
                    for j in range(b):
                        y1 = bell_spmm(bt, x[..., j:j + 1].contiguous())
                        check(torch.equal(y[..., j:j + 1], y1),
                              f"column {j} of B={b} is not the B=1 result ({bm},{bn}) {dtype}")
                    if variant == "stream":
                        check(torch.equal(y, spmm_simt(bt, x)),
                              f"stream and simt differ ({bm},{bn}) B={b} {dtype}")
        log(f"[kernel] bell_spmm ({bm},{bn}) B in {batches}, f32 + f16, "
            f"{spmm_variant(torch.float32, bm, bn, 1)}: ok")
    ran = {v: bell_spmm.variant_launches[v] - before[v] for v in VARIANTS}
    check(all(ran.values()), f"bell_spmm sweep left a variant unlaunched: {ran}")
    log(f"[kernel] bell_spmm worst f32 scaled |kernel - plain| = {worst:.3e}; "
        f"launches by variant {ran}")


def phase_kernel_gmm(device) -> None:
    from repro_torch.kernels.gmm import VARIANTS, gmm_plain, grouped_matmul

    rng = np.random.default_rng(0)
    worst = 0.0
    before = dict(grouped_matmul.variant_launches)
    for e, k, n, bm, bk, bn in GMM_SWEEP:
        m_tiles = 2 * e
        x32 = torch.as_tensor(rng.standard_normal((m_tiles * bm, k)).astype(np.float32),
                              device=device)
        w32 = torch.as_tensor(rng.standard_normal((e, k, n)).astype(np.float32), device=device)
        gid = torch.as_tensor(rng.integers(0, e, size=m_tiles).astype(np.int32), device=device)
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = {"bm": bm, "bk": bk, "bn": bn, "out_dtype": out_dtype}
                y = grouped_matmul(x, w, gid, **kw)
                y_plain = gmm_plain(x, w, gid, bm=bm, out_dtype=out_dtype)
                torch.cuda.synchronize()
                tol = max(GMM_TOL[dtype], GMM_TOL[out_dtype])
                err, ok = allclose_err(y, y_plain, tol)
                check(y.dtype == out_dtype and ok,
                      f"gmm vs plain {(e, k, n, bm, bk, bn)} {dtype} -> {out_dtype}: "
                      f"max abs err {err:.2e} (tol {tol})")
                if dtype == out_dtype == torch.float32:
                    worst = max(worst, err)
                check(torch.equal(y, grouped_matmul(x, w, gid, **kw)),
                      f"gmm: two launches differ {(e, k, n, bm, bk, bn)} {dtype} -> {out_dtype}")
        log(f"[kernel] gmm (e,k,n,bm,bk,bn)={(e, k, n, bm, bk, bn)}, "
            f"{{f32, bf16}} in x {{f32, bf16}} out: ok")
    ran = {v: grouped_matmul.variant_launches[v] - before[v] for v in VARIANTS}
    check(all(ran.values()), f"gmm sweep left a variant unlaunched: {ran}")
    log(f"[kernel] gmm worst f32 max |kernel - plain| = {worst:.3e}; launches by variant {ran}")


def phase_kernel_attn(device) -> None:
    from repro_torch.kernels.attn import VARIANTS, attention_plain, flash_attention

    rng = np.random.default_rng(0)
    worst = 0.0
    before = dict(flash_attention.variant_launches)
    cases = [(causal, window, s, s, bq, bkv, d)
             for causal, window in ATTN_MASKS for s, bq, bkv in ATTN_TILES for d in (16, 80)]
    cases.extend(ATTN_EXTRA)
    for causal, window, s, t, bq, bkv, d in cases:
        q32, k32, v32 = (torch.as_tensor(rng.standard_normal((2, n, d)).astype(np.float32),
                                         device=device) for n in (s, t, t))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kw = {"causal": causal, "window": window, "bq": bq, "bkv": bkv}
            o = flash_attention(q, k, v, **kw)
            o_plain = attention_plain(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv)
            torch.cuda.synchronize()
            err, ok = allclose_err(o, o_plain, ATTN_TOL[dtype])
            check(o.dtype == dtype and ok,
                  f"flash_attention vs plain {kw} S={s} T={t} D={d} {dtype}: "
                  f"max abs err {err:.2e}")
            if dtype == torch.float32:
                worst = max(worst, err)
            check(torch.equal(o, flash_attention(q, k, v, **kw)),
                  f"flash_attention: two launches differ {kw} S={s} T={t} D={d} {dtype}")
    ran = {v: flash_attention.variant_launches[v] - before[v] for v in VARIANTS}
    check(all(ran.values()), f"attention sweep left a variant unlaunched: {ran}")
    log(f"[kernel] flash_attention {len(cases)} (mask, tiles, D) cases x {{f32, bf16}}: ok; "
        f"worst f32 max |kernel - plain| = {worst:.3e}; launches by variant {ran}")


# -- phase 4: main path ------------------------------------------------------


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


def phase_main_path(device) -> dict:
    from repro_torch.api import Topology, distribute
    from repro_torch.kernels.spmv import bell_spmm
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
           "sessions": {}, "spd_sessions": {}, "ref": ref_sess, "spd_ref": spd_ref}
    for ex in EXCHANGES:
        bell_spmm.launches = 0
        bell_spmm.variant_launches = dict.fromkeys(bell_spmm.variant_launches, 0)
        t0 = time.perf_counter()
        sess = distribute(a, exchange=ex, **common)  # on the card by default
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
            res = spd_sess.solve("cg", iters=30, b=b_cg, device_loop=device_loop)
            check(np.isfinite(res.x).all() and res.iters_run == cg_ref.iters_run,
                  f"{ex}: cg device_loop={device_loop} iters or finiteness")
            err = rel_err(res.x, cg_ref.x)
            check(err < 1e-4, f"{ex}: cg device_loop={device_loop} x off by {err:.2e}")
        torch.cuda.synchronize()
        launches = bell_spmm.launches
        by_variant = dict(bell_spmm.variant_launches)
        check(launches > 0, f"{ex}: bell_spmm was never launched on the main path")
        check(by_variant["stream"] == launches and by_variant["simt"] == 0,
              f"{ex}: the main path did not run on the stream variant alone: {by_variant}")
        log(f"[main] {ex}: planning {t_plan:.1f} s, spmv + power_iteration + pagerank + "
            f"cg (host and device loops) ok; bell_spmm launches {launches} {by_variant}")
        out["launches"] += launches
        for v, c in by_variant.items():
            out["variant_launches"][v] += c
        out["sessions"][ex] = sess
        out["spd_sessions"][ex] = spd_sess
    return out


# -- phase 5: serve ----------------------------------------------------------


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


def serve_requests(rng, n: int) -> list:
    """SERVE_REQUESTS requests from SERVE_TENANTS tenants, a quarter each of
    pagerank with sparse seeds and spmv on ``a``, and jacobi and cg with
    random right-hand sides on ``spd``: (graph, solver, payload, tenant)."""
    kinds = (("a", "pagerank"), ("a", "spmv"), ("spd", "jacobi"), ("spd", "cg"))
    out = []
    for i in range(SERVE_REQUESTS):
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
            read just after; every launch must be stream."""
            bell_spmm.launches = 0
            bell_spmm.variant_launches = dict.fromkeys(bell_spmm.variant_launches, 0)
            got = run()
            torch.cuda.synchronize()
            by_variant = dict(bell_spmm.variant_launches)
            check(bell_spmm.launches > 0 and by_variant["stream"] == bell_spmm.launches,
                  f"{ex}: {what} did not run on stream alone: {by_variant}")
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


# -- phase 6: lm kernels -----------------------------------------------------


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
        new = "mma" if dtype == torch.bfloat16 else "regblock"
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


# -- phase 7: times ----------------------------------------------------------


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


def phase_times(main: dict, card: dict, device) -> list:
    from repro_torch.kernels.spmv import bell_spmm, bell_spmm_plain, bell_tiles, spmm_variant
    from repro_torch.pmvc.dist import hoist_tiles, pad_x

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
        old_ms = cuda_ms(lambda: spmm_simt(bt, xsrc), reps)
        partials = bell_spmm(bt, xsrc)
        sum_ms = cuda_ms(lambda: partials.sum(dim=0), reps)  # the executor's unit sum
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
                     "simt_ms": old_ms, "sum_ms": sum_ms})
        log(f"[times] bell_spmm U={u_n} T={bt.tiles.shape[1]} real={real} ({bm}x{bn}) "
            f"B={b}: kernel ({variant}) {ms:.4f} ms, simt variant {old_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms "
            f"({rows[-1]['bound_by']}; {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{bound_ms / ms:.1%} of bound, plain {plain_ms:.4f} ms, "
            f"{lib_name} {lib_ms:.4f} ms, max |kernel - plain| {err:.3e} [{where}]")

    by_b = {r["B"]: r for r in rows}
    for ex, s in main["sessions"].items():
        mv = s.device_spmm()
        for b in SPMV_BATCHES:
            x_np = rng.standard_normal((b, dp.shape[1])).astype(np.float32)
            x = torch.as_tensor(x_np, device=device)
            dev_ms = cuda_ms(lambda: mv(x), 10)
            if ex == "replicated":
                r = by_b[b]
                log(f"[times] spmv replicated B={b}: of its device time {dev_ms:.4f} ms the "
                    f"kernel takes {r['ms'] / dev_ms:.1%} ({r['ms']:.4f} ms), the unit sum "
                    f"partials.sum(dim=0) {r['sum_ms'] / dev_ms:.1%} ({r['sum_ms']:.4f} ms), "
                    f"the rest (padding x, unblocking y) "
                    f"{(dev_ms - r['ms'] - r['sum_ms']) / dev_ms:.1%} [{where}]")
            else:
                r = by_b[b]
                log(f"[times] spmv {ex} B={b}: device {dev_ms:.4f} ms less the replicated "
                    f"kernel and unit sum ({r['ms'] + r['sum_ms']:.4f} ms) leaves "
                    f"{dev_ms - r['ms'] - r['sum_ms']:.4f} ms "
                    f"({(dev_ms - r['ms'] - r['sum_ms']) / dev_ms:.1%}) for the emulated "
                    f"exchange [{where}]")
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
    # A measurement for the serving path, not a check: is the whole spmv,
    # unit sum included, column-stable in B on CUDA?
    mv = main["sessions"]["replicated"].device_spmm()
    x = torch.as_tensor(rng.standard_normal((64, dp.shape[1])).astype(np.float32), device=device)
    y = mv(x)
    same = sum(bool(torch.equal(y[j:j + 1], mv(x[j:j + 1]))) for j in range(64))
    log(f"[times] spmv replicated: column j of B=64 bitwise the B=1 spmv for {same} of 64 "
        f"columns (partials.sum(dim=0) on CUDA) [{where}]")
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


def simt_ms(lib_name: str, fn_name: str, *args) -> float:
    """Time of the ``simt`` variant on the same arguments, by its C entry
    point (the wrapper would choose the new variant at these shapes):
    the previous slice's kernel, compared within this run."""
    if lib_name == "gmm":
        from repro_torch.kernels.gmm.ops import _library
    else:
        from repro_torch.kernels.attn.ops import _library
    fn = getattr(_library(), fn_name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def run():
        check(fn(*ptrs, torch.cuda.current_stream().cuda_stream) == 0, f"{fn_name} launch failed")

    return cuda_ms(run, 3, warmup=1)


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
        old_ms = simt_ms("gmm", f"gmm_simt_{'bf16' if dtype == torch.bfloat16 else 'f32'}_f32",
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
        ms = cuda_ms(lambda: mha(q, k, v, **kw), 3, warmup=1)

        def plain():  # four BH rows at a time: the [4, S, S] float32 scores fit
            for i in range(0, bh, 4):
                attention_plain(q[i:i + 4], k[i:i + 4], v[i:i + 4], **kw)

        plain_ms = cuda_ms(plain, 1, warmup=1)
        variant = attention_variant(q.dtype, d, kw["bq"], kw["bkv"])
        old_ms = ms
        if variant != "simt":
            o = torch.empty_like(q)
            tname = "bf16" if q.dtype == torch.bfloat16 else "f32"
            old_ms = simt_ms("attn", f"flash_attention_simt_{tname}", q, k, v, o, bh, s, s, d,
                             kw["bq"], kw["bkv"], 1, kw["window"], ctypes.c_float(d**-0.5))
            del o
        lib_ms, backend, failed = sdpa_ms(q, k, v, s, kw["window"], run["heads"])
        pairs = visible_pairs(s, s, True, kw["window"]) * bh
        flops = 4.0 * d * pairs
        bytes_moved = 4 * q.numel() * q.element_size()  # q, k, v read, o written
        bound_ms, bound_by = bound(bytes_moved, flops, q.dtype)
        rows.append({"name": run["name"], "dtype": q.dtype, "variant": variant, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms,
                     "library_call": f"scaled_dot_product_attention ({backend}, {q.dtype})",
                     "max_abs_err": run["err"], "simt_ms": old_ms})
        log(f"[times] flash_attention {run['name']} {q.dtype} [BH={bh}, S={s}, D={d}]: "
            f"kernel ({variant}) {ms:.4f} ms, simt variant {old_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {pairs} visible pairs, "
            f"{flops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention "
            f"{'%.4f ms' % lib_ms if lib_ms is not None else 'not run'} "
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
    phase_kernel(device)
    phase_kernel_gmm(device)
    phase_kernel_attn(device)
    main_path = phase_main_path(device)
    serve = phase_serve(main_path, card, args.seed)
    moe = phase_lm_moe(device)
    attn = phase_lm_attention(device)
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
        "launches": main_path["launches"] + serve["launches"],
        "variant": head["variant"],
        "variant_launches": {v: c + serve["variant_launches"][v]
                             for v, c in main_path["variant_launches"].items()},
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
                        "library_call": r["library_call"], "simt_ms": r["simt_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
