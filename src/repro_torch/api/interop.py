"""Build a port session from a plan given as plain numpy arrays.

The sparse system has no weights: its state is the plan. A caller that
holds a plan's arrays — read off another planner's session, or loaded
from files — hands them to :func:`session_from_numpy` and gets a
:class:`SparseSession` that computes with exactly that plan, with no
partitioning or packing run. The parity tests use it to hold the port's
executors against the JAX package's on the same plan, apart from the
planning.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.partitioners import PartitionResult
from repro_torch.api.session import SparseSession
from repro_torch.api.topology import Topology
from repro_torch.pmvc.plan_device import DevicePlan, OverlapPlan, SelectivePlan
from repro_torch.sparse.formats import COO

__all__ = ["session_from_numpy"]

_PLAN_FIELDS = ("bm", "bn", "num_units", "tiles", "tile_row", "tile_col", "real_tiles")


def session_from_numpy(
    *,
    shape: Tuple[int, int],
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    topology: Tuple[int, int],
    combo: str,
    elem_unit: np.ndarray,
    device_plan: Mapping[str, object],
    exchange: str,
    selective: Optional[Mapping[str, object]] = None,
    overlap: Optional[Mapping[str, object]] = None,
    executor: str = "simulate",
    device=None,
) -> SparseSession:
    """A session over the given matrix and plan.

    * ``shape``, ``row``, ``col``, ``val`` — the COO matrix;
    * ``topology`` — ``(nodes, cores)``; ``combo`` and ``elem_unit`` —
      the partition's name and its element → unit assignment;
    * ``device_plan`` — the :class:`DevicePlan` fields ``bm``, ``bn``,
      ``num_units``, ``tiles``, ``tile_row``, ``tile_col``,
      ``real_tiles``;
    * ``exchange`` — the exchange's name; ``selective`` — the
      :class:`SelectivePlan` fields, for a selective or overlap
      exchange; ``overlap`` — the :class:`OverlapPlan` fields other than
      ``selective``, for an overlap exchange;
    * ``device`` — as for :func:`repro_torch.api.distribute`.
    """
    dev = resolve_device(device)
    a = COO(
        (int(shape[0]), int(shape[1])),
        np.asarray(row, dtype=np.int32),
        np.asarray(col, dtype=np.int32),
        np.asarray(val),
    )
    a.validate()
    topo = Topology(*topology)
    part = PartitionResult(
        name=combo, topology=topo, elem_unit=np.asarray(elem_unit, dtype=np.int64)
    )
    missing = [f for f in _PLAN_FIELDS if f not in device_plan]
    if missing:
        raise ValueError(f"device_plan lacks {missing}")
    dp = DevicePlan(
        shape=a.shape, **{f: _plain(device_plan[f]) for f in _PLAN_FIELDS}
    )
    if dp.num_units != topo.units:
        raise ValueError(f"plan has {dp.num_units} units, topology {topo.units}")
    sp = None
    if selective is not None:
        sp = SelectivePlan(**{k: _plain(v) for k, v in selective.items()})
    if overlap is not None:
        if sp is None:
            raise ValueError("an overlap plan needs its selective plan")
        sp = OverlapPlan(selective=sp, **{k: _plain(v) for k, v in overlap.items()})
    return SparseSession(
        a, topo, part, dp,
        exchange=exchange, selective=sp, executor=executor, device=dev,
    )


def _plain(v):
    """Arrays as numpy arrays, scalars as Python ints."""
    if isinstance(v, np.ndarray):
        return v
    if np.ndim(v) == 0:
        return int(v)
    return np.asarray(v)
