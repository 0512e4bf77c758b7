"""Multi-tenant sparse-solve serving demo on the port, the counterpart of
``examples/serve_sparse.py``: two tenants' graphs behind one
:class:`repro_torch.serve.SparseServeEngine` driven by a background
:class:`repro_torch.serve.ServeDriver` thread, mixed
personalized-PageRank / Jacobi / SpMV traffic batched continuously onto
shared SpMMs on the card (or the CPU with ``--device cpu``), with
weighted fair queueing, per-tenant quotas, and SLA deadlines on display.

    PYTHONPATH=src python examples/serve_sparse_torch.py --requests 24 --slots 4
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.api import Topology, distribute, set_memo_limit
from repro_torch.serve import (
    QueueFullError,
    ServeDriver,
    SparseServeEngine,
    Status,
    TenantQuotaError,
)
from repro_torch.sparse.formats import COO
from repro_torch.sparse.generate import banded_coo


def tenant_graph(n: int, nnz: int, seed: int) -> COO:
    """Banded matrix with a dominant full diagonal (Jacobi-friendly)."""
    a = banded_coo(n, nnz, seed=seed)
    off = a.row != a.col
    d = np.arange(n, dtype=a.row.dtype)
    row = np.concatenate([a.row[off], d])
    col = np.concatenate([a.col[off], d])
    val = np.concatenate([a.val[off].astype(np.float32),
                          np.full(n, 8.0, np.float32)])
    order = np.argsort(row, kind="stable")
    return COO((n, n), row[order], col[order], val[order])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # Tenant A's session is registered live; tenant B's is registered as
    # a *saved plan path* — it hydrates from the plan store on first
    # request, and set_memo_limit bounds how many graphs stay warm.
    topo = Topology(2, 2)
    sess_a = distribute(tenant_graph(args.n, args.n * 16, 1), topology=topo, device=device)
    sess_b = distribute(tenant_graph(args.n, args.n * 16, 2), topology=topo, device=device)
    set_memo_limit(max_sessions=4)

    with tempfile.TemporaryDirectory() as store:
        path_b = os.path.join(store, "tenant-b.npz")
        sess_b.save(path_b)

        # Tenant "a" pays for a 2x share; both are quota-bounded so one
        # misbehaving client cannot consume the whole admission queue.
        eng = SparseServeEngine(
            batch_slots=args.slots, max_queue=args.max_queue,
            default_iters=15,
            tenant_quota=max(4, args.max_queue // 2),
            tenant_weights={"a": 2.0},
            device=device,
        )
        eng.register_graph("tenant-a/web", sess_a)
        eng.register_graph("tenant-b/road", path_b)

        rng = np.random.default_rng(0)
        tickets, shed = [], 0
        kinds = (
            ("a", "tenant-a/web", "pagerank", lambda: {"seeds": rng.random(args.n).astype(np.float32)}),
            ("b", "tenant-b/road", "jacobi", lambda: {"b": rng.random(args.n).astype(np.float32)}),
            ("a", "tenant-a/web", "spmv", lambda: {"x": rng.random(args.n).astype(np.float32)}),
        )
        t0 = time.perf_counter()
        # The driver thread owns the tick loop; the main thread just
        # submits. On exit the context manager drains, then stops.
        with ServeDriver(eng):
            for i in range(args.requests):
                tenant, graph, solver, make = kinds[i % len(kinds)]
                try:
                    tickets.append(
                        eng.submit(graph, solver, payload=make(),
                                   timeout=30.0, tenant=tenant)
                    )
                except (QueueFullError, TenantQuotaError):
                    shed += 1  # typed load shedding: client backs off
        dt = time.perf_counter() - t0

    done = sum(t.status is Status.DONE for t in tickets)
    snap = eng.metrics.snapshot()
    print(f"served {done}/{args.requests} requests "
          f"({shed} shed at admission) in {dt:.2f}s on {device}")
    print(f"lane steps: {snap['lane_steps']} batched SpMM iterations for "
          f"{snap['slot_iters']} request-iterations "
          f"(occupancy {snap['occupancy']:.2f})")
    print(f"latency p50={snap['total_p50_s'] * 1e3:.1f}ms "
          f"p99={snap['total_p99_s'] * 1e3:.1f}ms")
    for name, tm in sorted(snap.get("tenants", {}).items()):
        print(f"tenant {name!r}: completed={tm['completed']} "
              f"goodput={tm['goodput']} "
              f"wait_p99={tm['wait_p99_s'] * 1e3:.1f}ms")
    sample = next(t for t in tickets if t.status is Status.DONE)
    print(f"sample ticket #{sample.tid}: {sample.solver} on "
          f"{sample.graph!r}, {sample.result.iters_run} iters, "
          f"|x|_1={np.abs(sample.result.x).sum():.4f}")


if __name__ == "__main__":
    main()
