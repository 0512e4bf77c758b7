#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. **card** — the device's name and count, and ``nvidia-smi``'s name and
   power limit;
2. **build** — the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   all ``nvcc`` processes started together, with ``-Xptxas -v``'s
   registers and spills;
3. **kernel** — every kernel against its plain PyTorch version on the
   card over a sweep of tile shapes, batch widths and types; two
   launches bitwise equal; column j of a B = 8 result bitwise the B = 1
   result on column j;
4. **main path** — ``distribute`` → ``spmv`` → ``solve`` at the repo's
   headline scale config (banded 60,000 × 60,000 with 1.2 M non-zeros,
   ``Topology(4, 4)``, ``NL-HC``, block 16, seed 0) for the replicated,
   selective and ``overlap:2`` exchanges, held against the float64 CSR
   ``reference`` executor; each kernel's launch counter, set to 0 just
   before a path runs, must have risen on it;
5. **times** — each kernel's time per launch at the main path's shapes
   (CUDA events), its bound, its plain version's time, one PyTorch
   library call computing the same function, and the spmv wall time and
   peak device memory per exchange.

Then one JSON line with the kernels' numbers, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. With no CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KERNEL_SWEEP = ((8, 8), (8, 16), (16, 16), (8, 128), (128, 128))
SWEEP_BATCHES = (1, 3, 8, 64)


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
    libs = build(["bell_spmm"])
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


def phase_kernel(device) -> None:
    from repro_torch.kernels.spmv import bell_spmm, bell_spmm_plain, bell_tiles

    rng = np.random.default_rng(0)
    worst = 0.0
    for bm, bn in KERNEL_SWEEP:
        tiles, rows, src, counts = random_tile_set(rng, 4, 24, bm, bn, 30, 40)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.float16, TOL_F16)):
            bt = bell_tiles(torch.as_tensor(tiles, device=device).to(dtype),
                            rows, src, counts, 24)
            for b in SWEEP_BATCHES:
                for ux in (4, 1):  # per-unit sources, and one shared source
                    x = torch.as_tensor(
                        rng.standard_normal((ux, 30, bn, b)).astype(np.float32),
                        device=device,
                    ).to(dtype)
                    y = bell_spmm(bt, x)
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
                    if b == 8:
                        for j in range(b):
                            y1 = bell_spmm(bt, x[..., j:j + 1].contiguous())
                            check(torch.equal(y[..., j:j + 1], y1),
                                  f"column {j} of B=8 is not the B=1 result "
                                  f"({bm},{bn}) {dtype}")
        log(f"[kernel] bell_spmm ({bm},{bn}) B in {SWEEP_BATCHES}, f32 + f16: ok")
    log(f"[kernel] bell_spmm worst f32 scaled |kernel - plain| = {worst:.3e}")


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

    out = {"launches": 0, "sessions": {}}
    for ex in EXCHANGES:
        bell_spmm.launches = 0
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
        check(launches > 0, f"{ex}: bell_spmm was never launched on the main path")
        log(f"[main] {ex}: planning {t_plan:.1f} s, spmv + power_iteration + pagerank + "
            f"cg (host and device loops) ok; bell_spmm launches {launches}")
        out["launches"] += launches
        out["sessions"][ex] = sess
    return out


# -- phase 5: times ----------------------------------------------------------


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
    from repro_torch.kernels.spmv import bell_spmm, bell_spmm_plain, bell_tiles
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
        rows.append({"B": b, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                     "library_ms": lib_ms, "library_call": lib_name,
                     "max_abs_err": err, "bytes": bytes_moved, "flops": flops})
        log(f"[times] bell_spmm U={u_n} T={bt.tiles.shape[1]} real={real} ({bm}x{bn}) "
            f"B={b}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({rows[-1]['bound_by']}; {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{bound_ms / ms:.1%} of bound, plain {plain_ms:.4f} ms, "
            f"{lib_name} {lib_ms:.4f} ms, max |kernel - plain| {err:.3e} [{where}]")

    for ex, s in main["sessions"].items():
        mv = s.device_spmm()
        for b in SPMV_BATCHES:
            x_np = rng.standard_normal((b, dp.shape[1])).astype(np.float32)
            x = torch.as_tensor(x_np, device=device)
            dev_ms = cuda_ms(lambda: mv(x), 10)
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
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present; this script runs on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    phase_kernel(device)
    main_path = phase_main_path(device)
    rows = phase_times(main_path, card, device)
    head = next(r for r in rows if r["B"] == 8)
    kernels = [{
        "name": "bell_spmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bell_spmm.cu",
        "replaces": "src/repro/kernels/spmv/kernel.py:74",
        "launches": main_path["launches"],
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
