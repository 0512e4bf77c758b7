"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
sets the program up, runs the cell's loop, checks the answers against
the plain reference and prints the result line.

Set-up is everything from the process's start to the window: imports,
the kernel's build (by its first launch, in the warm-up), the matrices
(:mod:`portbench.matrices`), ``distribute`` (timed apart as ``plan_s``),
the hoist of the tiles and the warm-up. After the window the program's
state is freed and the reference checks a sample of the answers.

A ``--trace 1`` run also turns the program's own tracer on
(``repro_torch.trace``) from before ``distribute`` to the loop's end
(the window and, on the card, the profiled slice after it), then
copies its spans into the run's :class:`~portbench.trace.Spans` beside
the benchmark's, and its counters onto ``Run.program_counters``. An
untraced run leaves it off.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import HERE, load, loops, reference
from portbench import trace as tracing
from portbench.loops import Context, Run
from portbench.matrices import make_graphs

ROOT = os.path.dirname(HERE)
# Top-level module names that may not be loaded once the window closes:
# JAX and the JAX package the program was ported from.
BANNED = ("jax", "jaxlib", "flax", "repro")
# The program's tracer's buffer in a traced run: spans for set-up, and
# for every second of the window. The CG cell records about 5,700 a
# second (seven an iteration); the buffer holds eight times that, which
# covers the profiled slice after the window too, so ``trace.dropped``
# stays unset.
PROGRAM_SPANS_SETUP = 1 << 16
PROGRAM_SPANS_PER_S = 50_000


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT  # where the files were found


def resolve(spec: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload``: its configuration's ``file``,
    ``traffic/<traffic>.json``, ``cells/<workload>.json``, and the metrics
    it reports (an end-to-end metric without ``workloads`` is in every
    cell; a per-layer metric without it is in every cell that reports
    its ``moves``)."""
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    here = os.path.join(root, "portbench")
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name=workload, chips=int(w["chips"]),
                config=read_json(os.path.join(root, cfg["file"])),
                traffic=read_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
                cell=read_json(os.path.join(here, "cells", f"{workload}.json")),
                end_to_end=e2e, per_layer=per_layer, root=root)


def reader(name: str, root: str = ROOT):
    """``metrics/<name>.py``'s ``read(run) -> float | None``, from the
    checkout ``root`` (:func:`portbench.load`)."""
    return load("metrics", name, root).read


def plan_facts(sess, nnz: int) -> dict:
    """What the roofline counts need of a graph and its plan."""
    dp = sess.device_plan
    sp = sess.selective
    units, ncb = dp.num_units, dp.num_col_blocks
    if sp is None:
        xsrc = ncb  # replicated: every unit reads the whole x
    elif hasattr(sp, "workspace") and hasattr(sp, "tile_col_local"):
        xsrc = units * sp.workspace  # selective: each unit's workspace
    else:
        xsrc = None  # overlap: 1 + K launches of other sizes
    return {"nnz": nnz, "n": dp.shape[0], "bm": dp.bm, "bn": dp.bn, "units": units,
            "nrb": dp.num_row_blocks, "ncb": ncb,
            "real_tiles": int(np.asarray(dp.real_tiles).sum()), "xsrc_blocks": xsrc}


def plan(config: dict, graphs: dict, device) -> tuple:
    """(sessions, seconds in ``distribute``, plan facts) of every graph."""
    from repro_torch.api import Topology, distribute
    from repro_torch.sparse.formats import COO

    p = config["plan"]
    sessions, facts, seconds = {}, {}, 0.0
    for name, m in graphs.items():
        coo = COO((m.n, m.n), m.row, m.col, m.val)
        t0 = time.perf_counter()
        sessions[name] = distribute(coo, topology=Topology(p["nodes"], p["cores"]),
                                    combo=p["combo"], exchange=p["exchange"],
                                    executor=p["executor"], block=p["block"], seed=p["seed"],
                                    device=device)
        seconds += time.perf_counter() - t0
        facts[name] = plan_facts(sessions[name], m.nnz)
    return sessions, seconds, facts


def compare(answers, graphs: dict, precision: str, device, root: Optional[str] = None) -> float:
    """The widest relative gap of the answers from the reference's at
    ``precision`` (``reference/<solver>.py`` of the checkout ``root``):
    per answer row, max |x − x_ref| / max |x_ref|."""
    worst = 0.0
    groups: Dict[tuple, list] = {}
    for a in answers:
        groups.setdefault((a.graph, a.solver, a.iters), []).append(a)
    for (graph, solver, iters), group in groups.items():
        payload = np.concatenate([a.payload for a in group])
        x = np.concatenate([a.x for a in group]).astype(np.float64)
        ref = reference.solve(solver, graphs[graph], payload, iters, precision, device, root)
        scale = np.maximum(np.abs(ref).max(axis=1), 1e-300)
        gap = np.abs(x - ref).max(axis=1) / scale
        worst = max(worst, float(np.nan_to_num(gap, nan=np.inf).max()))
    return worst


def checks(run: Run, graphs: dict, limits: dict, device, root: str) -> Dict[str, dict]:
    """Each number compared, with its limit (the reference of the checkout
    ``root``)."""
    return {"x_err": {"value": compare(run.answers, graphs, "float64", device, root),
                      "limit": limits["x_err"]},
            "unanswered": {"value": run.failed, "limit": limits["unanswered"]}}


@contextlib.contextmanager
def program_tracing(on: bool, capacity: int):
    """The program's tracer (``repro_torch.trace``), recording into a
    buffer of ``capacity`` spans while in effect, where ``on``; else
    None, and the tracer is left off."""
    if not on:
        yield None
        return
    from repro_torch import trace as tracer

    tracer.enable(capacity)
    try:
        yield tracer
    finally:
        tracer.disable()


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run one cell and return its result line (a dict)."""
    import torch

    on_card = torch.device(device).type == "cuda"
    t_imported = time.perf_counter()
    graphs = make_graphs(cell.config, seed, cell.root)
    t_graphs = time.perf_counter()
    capacity = PROGRAM_SPANS_SETUP + int(seconds * PROGRAM_SPANS_PER_S)
    with program_tracing(trace, capacity) as tracer:
        sessions, plan_s, facts = plan(cell.config, graphs, device)
        t_planned = time.perf_counter()
        spans = tracing.Spans() if trace else None
        ctx = Context(config=cell.config, traffic=cell.traffic, cell=cell.cell, seed=seed,
                      seconds=seconds, device=device, graphs=graphs, sessions=sessions,
                      t_start=t_start, spans=spans, profile=trace and on_card)
        loop = loops.find(cell.traffic["loop"])
        run = loop.run(ctx)
        t_loop = time.perf_counter_ns()
    if tracer is not None:
        spans.extend((name, t0, t1) for name, t0, t1, *_ in tracer.spans())
        run.program_counters = tracer.counters()
    run.plan_s, run.facts, run.traffic, run.spans = plan_s, facts, cell.traffic, spans
    run.device_trace = run.profiler.read() if run.profiler else None
    t_read = time.perf_counter_ns()
    # Set-up by part, for the record (standard error; not a metric).
    print(f"setup_s {run.setup_s:.3f}: imports {t_imported - t_start:.3f}, matrices "
          f"{t_graphs - t_imported:.3f}, distribute {plan_s:.3f}, the rest of planning "
          f"{t_planned - t_graphs - plan_s:.3f}, hoist + build + warm-up "
          f"{run.setup_s - (t_planned - t_start):.3f}", file=sys.stderr)
    device_info = {"platform": "gpu" if on_card else torch.device(device).type,
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips if on_card else 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    # The program's state is freed before the reference runs.
    del ctx, sessions
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_freed = time.perf_counter_ns()
    compared = checks(run, graphs, cell.cell["limits"], device, cell.root)
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    t_checked = time.perf_counter_ns()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if trace and run.device_trace is not None:
        dt = run.device_trace
        device_info["busy_s"] = dt.busy_s
        device_info["window_s"] = dt.window_s
        out["breakdown"] = {"device_ops": dt.device_ops(),
                            "idle_gaps": dt.idle_gaps(loop.SPANS)}
    out["checks"] = compared
    past_window(run, t_loop, t_read, t_freed, t_checked, time.perf_counter_ns())
    return out


def past_window(run: Run, *marks: int) -> None:
    """The run's time from the window's close to its result, by part, on
    standard error (for the record; not a metric): where the loop
    profiled, the profiler's start, the profiled slice and
    ``Profiler.stop``; then the rest of the loop, ``Profiler.read`` with
    the copy of the program's spans, the free of the program's state, the
    reference check, and the metrics' readers with the breakdown. ``marks`` are the
    ``perf_counter_ns`` readings at the end of each of the last five."""
    t, parts = run.window_ns[1], []
    prof = run.profiler
    if prof is not None:
        for name, end in (("profiler start", prof.lo), ("profiled slice", prof.hi),
                          ("Profiler.stop", prof.stopped)):
            parts.append(f"{name} {(end - t) / 1e9:.3f}")
            t = end
    for name, end in zip(("rest of the loop", "Profiler.read + spans", "free",
                          "reference check", "readers + breakdown"), marks):
        parts.append(f"{name} {(end - t) / 1e9:.3f}")
        t = end
    print(f"past the window {(marks[-1] - run.window_ns[1]) / 1e9:.3f} s: " + ", ".join(parts),
          file=sys.stderr)


def banned_modules(modules=None) -> List[str]:
    """The banned top-level names among ``modules`` (``sys.modules`` by
    default), each name's part before the first dot compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({name.split(".")[0] for name in names} & set(BANNED))


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(read_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", t_start=t_start)
    found = banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name in [k for k, m in out["metrics"].items() if not math.isfinite(m["value"])]:
        print(f"portbench: {name} is {out['metrics'].pop(name)['value']}: left out",
              file=sys.stderr)
    for name, c in out["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False))
    return 0
