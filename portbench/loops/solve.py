"""One caller, closed loop: back-to-back ``SparseSession.solve(solver,
iters, tol=0, device_loop=True)`` on ``[batch, n]`` payload blocks, so
the work is fixed and the host never waits inside a solve. The window
ends at the first solve that ends after ``--seconds``. A traced run then
profiles the device over :data:`~portbench.trace.SLICE_S` seconds of
further solves of the same traffic, outside the window: the profiler's
first start takes seconds, and once started it slows the host's
launches for the rest of the process, so the window's host spans are
the untraced program's, bar its own tracer."""
from __future__ import annotations

import time

from portbench import trace as tracing
from portbench.loops import Answer, Context, Run, SpmvSpans, sync
from portbench.traffic import Reservoir, payloads

SPANS = ("solve", "spmv")


def run(ctx: Context) -> Run:
    tr = ctx.traffic
    sess, n = ctx.sessions[tr["graph"]], ctx.graphs[tr["graph"]].n
    pool = payloads(tr, n, tr["pool"], tr["batch"], ctx.seed, salt=0)

    def solve(block):
        return sess.solve(tr["solver"], iters=tr["iters"], tol=0.0, device_loop=True,
                          **{tr["arg"]: block})

    solve(pool[0])  # warm-up: builds the kernel, hoists the tiles
    sync(ctx.device)
    out = Run(loop="solve")
    kept = Reservoir(ctx.cell["sample"], ctx.seed)  # (index, x) of the solves compared
    with SpmvSpans(ctx.spans):
        t0 = time.perf_counter_ns()
        out.setup_s = t0 / 1e9 - ctx.t_start
        while True:
            ts = time.perf_counter_ns()
            res = solve(pool[out.attempted % tr["pool"]])
            te = time.perf_counter_ns()
            kept.offer((out.attempted, res.x))
            out.attempted += 1
            out.rhs_iters += res.x.shape[0] * res.iters_run
            if ctx.spans is not None:
                ctx.spans.add("solve", ts, te)
            if te - t0 >= ctx.seconds * 1e9:
                break
        if ctx.profile:
            prof, k = tracing.Profiler(ctx.spans), out.attempted
            prof.start()
            while True:
                ts = time.perf_counter_ns()
                solve(pool[k % tr["pool"]])
                k, t = k + 1, time.perf_counter_ns()
                ctx.spans.add("solve", ts, t)
                if t - prof.lo >= tracing.SLICE_S * 1e9:
                    break
            out.profiler = prof.stop()
    out.window_s = (te - t0) / 1e9
    out.window_ns = (t0, te)
    for i, x in sorted(kept.items, key=lambda item: item[0]):
        out.answers.append(Answer(tr["graph"], tr["solver"], pool[i % tr["pool"]], x,
                                  tr["iters"]))
    return out
