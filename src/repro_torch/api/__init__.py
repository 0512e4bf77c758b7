"""``repro_torch.api`` — the public entry point for the paper pipeline,
on PyTorch.

The port of the JAX package's ``repro.api``: partition A two-level
across (nodes × cores), pack per-unit Block-ELL tiles, plan the x
exchange, then run the PMVC inside an iterative solver::

    from repro_torch.api import Topology, distribute

    sess = distribute(A, topology=Topology(nodes=4, cores=4),
                      combo="NL-HC", exchange="selective")
    y = sess.spmv(x)                                  # one PMVC
    res = sess.solve("power_iteration", iters=20)     # full solver run
    print(sess.costs())                               # LB / FD / volumes

Sessions compute on the card unless ``distribute(..., device="cpu")``
asks for the CPU. Everything pluggable is a string-keyed registry entry:
partitioners (``NL-HL NL-HC NC-HL NC-HC``, generic ``XX-YY`` combos,
``nezgt``, ``hyper``), exchanges (``replicated``, ``selective``,
``overlap``, ``overlap:K``), executors (``simulate``, ``reference``),
solvers (``power_iteration block_power_iteration jacobi pagerank cg``)
and the serving engine's batch steppers (``pagerank jacobi spmv cg``;
:mod:`repro_torch.serve`).
"""
from repro_torch.api.exchange import EXCHANGES, register_exchange, resolve_exchange
from repro_torch.api.executors import EXECUTORS, register_executor
from repro_torch.api.interop import session_from_numpy
from repro_torch.api.partitioners import (
    PARTITIONERS,
    PartitionResult,
    register_partitioner,
    resolve_partitioner,
)
from repro_torch.api.registry import Registry
from repro_torch.api.session import SparseSession, distribute
from repro_torch.api.solvers import (
    SOLVERS,
    STEPPERS,
    BatchStepper,
    SolveResult,
    register_solver,
    register_stepper,
)
from repro_torch.api.topology import Topology

__all__ = [
    "Topology",
    "distribute",
    "SparseSession",
    "SolveResult",
    "BatchStepper",
    "PartitionResult",
    "Registry",
    "PARTITIONERS",
    "EXCHANGES",
    "EXECUTORS",
    "SOLVERS",
    "STEPPERS",
    "register_partitioner",
    "register_exchange",
    "register_executor",
    "register_solver",
    "register_stepper",
    "resolve_partitioner",
    "resolve_exchange",
    "session_from_numpy",
]
