"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Everything a cell needs is found by name:
``configs/<config>.json`` (the matrices and the plan),
``matrices/<generator>.py`` (its generator),
``traffic/<traffic>.json`` (the mix that :mod:`portbench.traffic` and
:mod:`portbench.loops` read), ``cells/<cell>.json`` (the limits of the
comparison with :mod:`portbench.reference`), ``reference/<solver>.py``
(the plain reference of the traffic's solver) and ``metrics/<metric>.py``
(one reader a metric). Nothing here imports ``jax`` or the JAX package.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def load(folder: str, name: str, root: Optional[str] = None):
    """``portbench/<folder>/<name>.py`` as a fresh module, loaded from its
    file in the checkout ``root``, or from this package where ``root`` is
    None or has no such file: a cell's generator, reference and readers
    come from the checkout that names them, as its data files do."""
    path = os.path.join(root or "", "portbench", folder, f"{name}.py")
    if root is None or not os.path.exists(path):
        path = os.path.join(HERE, folder, f"{name}.py")
    mod_name = f"portbench_{folder}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
