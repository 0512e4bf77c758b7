"""The benchmark's cells cut to a size the CPU runs in a second, for
the tests: the same files, loops, readers and comparison, on
``device="cpu"``. A cell is cut by its generator's ``TINY`` overrides
(:mod:`portbench.matrices`) and a plan of 2 × 2 units, so a cell of
another configuration needs no edit here."""
from __future__ import annotations

import os
import time

from portbench.harness import ROOT, read_json, resolve, run_cell
from portbench.matrices import generator

SPEC = read_json(os.path.join(ROOT, "BENCHMARK.json"))
WORKLOADS = tuple(w["name"] for w in SPEC["workloads"])
BIG_SEED = 2**31 + 12345


def tiny(workload: str, spec: dict = SPEC, root: str = ROOT):
    cell = resolve(spec, workload, root)
    cell.config.update(generator(cell.config, root).TINY)
    cell.config["plan"].update(nodes=2, cores=2)
    return cell


def fault_cases(faults, spec: dict = SPEC, root: str = ROOT) -> list:
    """(workload, fault) for each cell and each fault it can have, read
    from its traffic: a batch of one has no half to leave out."""
    return [(w["name"], f) for w in spec["workloads"] for f in faults
            if f != "half_batch" or resolve(spec, w["name"], root).traffic["batch"] > 1]


def run(workload: str, *, seed: int = BIG_SEED, seconds: float = 0.6, trace: bool = False,
        cell=None) -> dict:
    return run_cell(cell or tiny(workload), seed=seed, seconds=seconds, trace=trace,
                    device="cpu", t_start=time.perf_counter())
