"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's number (the widest relative gap of its
sampled answers from the float64 reference) over many seeds, each a
short window of the cell's own loop, and the control's (the reference
in TF32 in the program's place, on the same sampled inputs) over a few.
The cell's matrices and plan are made once and reused across seeds
while the seed does not change them.

    python3 portbench/calibrate.py --workload hpcg64-cg-b1 --seeds 12 \
        --control-seeds 3 --seconds 3
"""
import os
import sys

# As in run.py: one OpenMP thread.
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[0:1] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from portbench import loops, reference  # noqa: E402
from portbench.harness import ROOT, compare, plan, read_json, resolve  # noqa: E402
from portbench.loops import Answer, Context  # noqa: E402
from portbench.matrices import make_graphs  # noqa: E402


def control_answers(answers, graphs, device) -> list:
    """The same inputs answered by the TF32 reference."""
    return [Answer(a.graph, a.solver, a.payload,
                   reference.solve(a.solver, graphs[a.graph], a.payload, a.iters, "tf32", device),
                   a.iters) for a in answers]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=1_000_003)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = resolve(read_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    loop = loops.find(cell.traffic["loop"])
    graphs = sessions = None
    out = {"workload": args.workload, "program": [], "control": []}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        fresh = make_graphs(cell.config, seed)
        if graphs is None or any(not np.array_equal(fresh[g].val, graphs[g].val) for g in fresh):
            graphs, sessions = fresh, None
            sessions, _, _ = plan(cell.config, graphs, "cuda")
        ctx = Context(config=cell.config, traffic=cell.traffic, cell=cell.cell, seed=seed,
                      seconds=args.seconds, device="cuda", graphs=graphs, sessions=sessions,
                      t_start=time.perf_counter())
        run = loop.run(ctx)
        prog = compare(run.answers, graphs, "float64", "cuda")
        row = {"seed": seed, "x_err": prog, "answers": len(run.answers),
               "attempted": run.attempted, "failed": run.failed}
        if k < args.control_seeds:
            ctrl = control_answers(run.answers, graphs, "cuda")
            row["control_x_err"] = compare(ctrl, graphs, "float64", "cuda")
            out["control"].append(row["control_x_err"])
        row["seconds"] = time.perf_counter() - t0
        out["program"].append(prog)
        print(json.dumps(row), flush=True)
    out["program_max"] = max(out["program"])
    out["control_min"] = min(out["control"]) if out["control"] else None
    print(json.dumps({k: out[k] for k in ("workload", "program_max", "control_min")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
