"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Everything a cell needs is found by name:
``configs/<config>.json`` (the matrices and the plan),
``traffic/<traffic>.json`` (the mix that :mod:`portbench.traffic` and
:mod:`portbench.loops` read), ``cells/<cell>.json`` (the limits of the
comparison with :mod:`portbench.reference`) and ``metrics/<metric>.py``
(one reader a metric). Nothing here imports ``jax`` or the JAX package.
"""
