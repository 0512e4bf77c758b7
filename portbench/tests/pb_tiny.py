"""The benchmark's cells cut to a size the CPU runs in a second, for
the tests: the same files, loops, readers and comparison, on
``device="cpu"``. A cell is cut by its generator's ``TINY`` overrides
(:mod:`portbench.matrices`) and a plan of 2 × 2 units, so a cell of
another configuration needs no edit here. A test adds a cell to a copy
of the checkout as a later PR adds one (:func:`copy_checkout`,
:func:`add_cell`)."""
from __future__ import annotations

import json
import os
import shutil
import time

from portbench.harness import HERE, ROOT, read_json, resolve, run_cell
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


def copy_checkout(dest) -> dict:
    """``BENCHMARK.json`` and ``portbench/`` copied into ``dest``, with
    ``src/`` linked there: a checkout that a test adds a cell to. Returns
    the copy's spec."""
    dest = str(dest)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(HERE, os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "src"), os.path.join(dest, "src"))
    return read_json(os.path.join(dest, "BENCHMARK.json"))


def add_cell(root, spec: dict, name: str, config: dict, traffic: str, cell: dict, metrics,
             files=None) -> None:
    """A cell added to the checkout ``root`` as a later PR adds one, by
    new files and list entries alone. Files under ``portbench/``: the
    configuration ``config`` (``configs/<its name>.json``),
    ``cells/<name>.json`` and ``files`` (a path under ``portbench/`` to
    its text: a generator, a traffic mix, a reference). Entries in
    ``spec``: the configuration, the workload on ``traffic``, and ``name``
    appended to the ``workloads`` of each metric in ``metrics``. ``spec``
    is then written to ``root``'s ``BENCHMARK.json``."""
    root = str(root)
    new = {f"configs/{config['name']}.json": json.dumps(config),
           f"cells/{name}.json": json.dumps(cell), **(files or {})}
    for rel, text in new.items():
        path = os.path.join(root, "portbench", rel)
        if os.path.exists(path):
            raise FileExistsError(f"{rel} is not a new file")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text)
    spec["configs"].append({"name": config["name"], "reduced": config["reduced"],
                            "file": f"portbench/configs/{config['name']}.json"})
    spec["workloads"].append({"name": name, "config": config["name"], "traffic": traffic,
                              "chips": 1})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh, indent=2)
