"""The benchmark's cells cut to a size the CPU runs in a second, for
the tests: the same files, loops, readers and comparison, on
``device="cpu"``."""
from __future__ import annotations

import os
import time

from portbench.harness import ROOT, read_json, resolve, run_cell

SPEC = read_json(os.path.join(ROOT, "BENCHMARK.json"))
WORKLOADS = tuple(w["name"] for w in SPEC["workloads"])
BIG_SEED = 2**31 + 12345


def tiny(workload: str):
    cell = resolve(SPEC, workload)
    cell.config.update(nx=6, ny=7, nz=5)
    cell.config["plan"].update(nodes=2, cores=2)
    return cell


def run(workload: str, *, seed: int = BIG_SEED, seconds: float = 0.6, trace: bool = False,
        cell=None) -> dict:
    return run_cell(cell or tiny(workload), seed=seed, seconds=seconds, trace=trace,
                    device="cpu", t_start=time.perf_counter())
