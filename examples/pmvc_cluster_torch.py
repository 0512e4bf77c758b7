"""Distributed PMVC on a simulated (nodes × cores) cluster, end to end
through the port's :mod:`repro_torch.api` façade — the counterpart of
``examples/pmvc_cluster.py``, on the card unless asked for the CPU.

For each of the thesis' four partition combinations (NL-HL, NL-HC,
NC-HL, NC-HC) this driver opens one ``SparseSession`` on a matrix from
the Tim-Davis-matched suite — ``distribute`` partitions A two-level,
packs per-unit Block-ELL shards, and plans the selective x exchange —
then runs an iterative solver (default: the PageRank-style power
iteration of ch.1 §3.1) through the simulated cluster executor (every
unit's SpMM one launch of the Block-ELL kernel on the card) and prints
the paper's measurement columns (LB_nodes/LB_cores, FD, cut, FLOP
efficiency, selective vs naive scatter bytes) plus solver output and
the error against the sequential CSR oracle.

With ``--users B`` it then demos the batch-first serving path:
B personalized-PageRank queries (one one-hot teleport vector per user)
answered by a single multi-source solve — every iteration is one SpMM,
so one exchange carries all B walks — timed against answering the same
B queries one solve at a time.

    PYTHONPATH=src python examples/pmvc_cluster_torch.py --matrix thermal --iters 20
    PYTHONPATH=src python examples/pmvc_cluster_torch.py --solver pagerank --exchange replicated
    PYTHONPATH=src python examples/pmvc_cluster_torch.py --matrix t2dal --users 16 --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.api import EXCHANGES, SOLVERS, Topology, distribute
from repro_torch.configs.paper_pmvc import COMBOS
from repro_torch.sparse import PAPER_SUITE, generate


def serve_multi_user(sess, users: int, iters: int, seed: int = 0) -> None:
    """B personalized-PageRank queries: one batched solve vs B loops."""
    n = sess.matrix.shape[1]
    rng = np.random.default_rng(seed)
    seeds = np.zeros((users, n), np.float32)
    seeds[np.arange(users), rng.integers(0, n, users)] = 1.0

    # Warm both shapes (kernel build and plan placement) outside the timing.
    sess.solve("pagerank", iters=1, seeds=seeds)
    sess.solve("pagerank", iters=1, seeds=seeds[:1])

    t0 = time.perf_counter()
    res = sess.solve("pagerank", iters=iters, seeds=seeds)
    batched_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    singles = [
        sess.solve("pagerank", iters=iters, seeds=seeds[u : u + 1]).x[0]
        for u in range(users)
    ]
    looped_s = time.perf_counter() - t0

    err = max(
        float(np.abs(res.x[u] - singles[u]).max()) for u in range(users)
    )
    top = np.argsort(res.x, axis=1)[:, ::-1][:, :3]
    print(
        f"serve: {users} users x {iters} iters -> batched {batched_s*1e3:.0f}ms "
        f"({batched_s/users*1e3:.1f}ms/user), looped {looped_s*1e3:.0f}ms, "
        f"speedup {looped_s/batched_s:.2f}x, batched-vs-looped err {err:.1e}"
    )
    for u in range(min(users, 4)):
        print(f"  user {u}: top nodes {top[u].tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="thermal", choices=list(PAPER_SUITE))
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--cores", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--solver", default="power_iteration", choices=SOLVERS.names())
    ap.add_argument("--exchange", default="selective", choices=EXCHANGES.names())
    ap.add_argument("--users", type=int, default=0,
                    help="also serve N personalized-PageRank users batched")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    a = generate(PAPER_SUITE[args.matrix])
    print(f"matrix {args.matrix}: N={a.shape[0]} NNZ={a.nnz} "
          f"density={a.density:.4%} (on {device})")
    topo = Topology(args.nodes, args.cores)

    best = None
    for combo in COMBOS:
        sess = distribute(a, topology=topo, combo=combo,
                          exchange=args.exchange, block=args.block, device=device)
        costs = sess.costs()
        res = sess.solve(args.solver, iters=args.iters)
        # Verify against the sequential CSR oracle.
        y = sess.spmv(res.x)
        y_ref = sess.spmv(res.x, executor="reference")
        err = float(np.abs(y - y_ref).max() / (np.abs(y_ref).max() + 1e-12))
        print(
            f"{combo}: LB_nodes={costs['lb_nodes']:.3f} LB_cores={costs['lb_cores']:.3f} "
            f"FD={costs['inter_fd']:.0f} cut={costs['hyper_cut']:.0f} "
            f"flop_eff={costs['flop_efficiency']:.3f} "
            f"scatter={costs['scatter_bytes']:.2e}B "
            f"(naive {costs['scatter_bytes_naive']:.2e}B) "
            f"{res.solver}={res.value:.4f} err={err:.1e}"
        )
        if best is None or costs["scatter_bytes"] < best[1]:
            best = (sess, costs["scatter_bytes"])

    if args.users > 0:
        serve_multi_user(best[0], args.users, args.iters)


if __name__ == "__main__":
    main()
