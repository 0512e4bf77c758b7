"""Sparse streaming deltas: batched edge mutations against a fixed-shape COO.

A :class:`SparseDelta` is the unit of change for dynamic graphs: a batch of
*upserts* (insert a new nonzero, or overwrite the value of an existing one)
plus a batch of *deletes* (remove an existing nonzero).  The shape of the
matrix never changes — only the nonzero set and its values do — which is the
regime where incremental replanning (``SparseSession.update``) can patch the
device plan instead of re-running the partitioner.

Design notes
------------
* ``apply`` returns a **fresh** canonical COO (lexsorted by ``(row, col)``).
  Freshness matters: :mod:`repro_torch.api.plancache` caches a content digest on
  COO instances, so mutated matrices must never alias the original object.
* Element order in a COO is semantically irrelevant downstream (``pack_units``
  scatters by index, ``csr_from_coo`` lexsorts), so canonicalization is safe
  and makes deltas composable and journal-replayable deterministically.
* An upsert with value ``0.0`` stays a *stored* explicit zero, exactly as a
  cold build from a COO containing that entry would keep it.  Use a delete to
  remove structure.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .formats import COO

__all__ = ["SparseDelta"]


def _as_index(x) -> np.ndarray:
    out = np.asarray(x, dtype=np.int32).ravel()
    return out


@dataclasses.dataclass(frozen=True)
class SparseDelta:
    """A batch of COO edge mutations on a matrix of fixed ``shape``.

    ``up_row/up_col/up_val`` upsert entries (insert-or-overwrite);
    ``del_row/del_col`` delete entries that must currently exist.
    Coordinate pairs must be unique within the delta, and the upsert and
    delete sets must be disjoint.
    """

    shape: Tuple[int, int]
    up_row: np.ndarray
    up_col: np.ndarray
    up_val: np.ndarray
    del_row: np.ndarray
    del_col: np.ndarray

    # --------------------------------------------------------- constructors
    @classmethod
    def upserts(cls, shape, row, col, val) -> "SparseDelta":
        row = _as_index(row)
        return cls(
            shape=tuple(shape),
            up_row=row,
            up_col=_as_index(col),
            up_val=np.asarray(val).ravel(),
            del_row=np.empty(0, np.int32),
            del_col=np.empty(0, np.int32),
        )

    @classmethod
    def deletes(cls, shape, row, col) -> "SparseDelta":
        return cls(
            shape=tuple(shape),
            up_row=np.empty(0, np.int32),
            up_col=np.empty(0, np.int32),
            up_val=np.empty(0, np.float64),
            del_row=_as_index(row),
            del_col=_as_index(col),
        )

    @classmethod
    def empty(cls, shape) -> "SparseDelta":
        return cls.upserts(shape, [], [], [])

    @classmethod
    def merge(cls, shape, up_row=(), up_col=(), up_val=(),
              del_row=(), del_col=()) -> "SparseDelta":
        """Build a combined upsert+delete delta, validated eagerly.

        Malformed batches — mismatched array lengths, out-of-bounds
        coordinates, duplicate coordinates within one set, or an
        upsert/delete conflict on the same coordinate — raise
        ``ValueError`` here, at construction, rather than surfacing
        later from ``apply`` deep inside ``SparseSession.update``.
        """
        delta = cls(
            shape=tuple(shape),
            up_row=_as_index(up_row),
            up_col=_as_index(up_col),
            up_val=np.asarray(up_val).ravel(),
            del_row=_as_index(del_row),
            del_col=_as_index(del_col),
        )
        delta.validate()
        return delta

    # ------------------------------------------------------------ accessors
    @property
    def num_upserts(self) -> int:
        return int(self.up_row.shape[0])

    @property
    def num_deletes(self) -> int:
        return int(self.del_row.shape[0])

    @property
    def size(self) -> int:
        """Total number of touched coordinates (upserts + deletes)."""
        return self.num_upserts + self.num_deletes

    def _keys(self) -> Tuple[np.ndarray, np.ndarray]:
        m = np.int64(self.shape[1])
        up = self.up_row.astype(np.int64) * m + self.up_col.astype(np.int64)
        de = self.del_row.astype(np.int64) * m + self.del_col.astype(np.int64)
        return up, de

    # ----------------------------------------------------------- validation
    def validate(self) -> None:
        n, m = self.shape
        if self.up_row.shape != self.up_col.shape or self.up_row.shape != self.up_val.shape:
            raise ValueError("upsert arrays must have matching shapes")
        if self.del_row.shape != self.del_col.shape:
            raise ValueError("delete arrays must have matching shapes")
        for r, c, what in (
            (self.up_row, self.up_col, "upsert"),
            (self.del_row, self.del_col, "delete"),
        ):
            if r.size and (
                r.min() < 0 or r.max() >= n or c.min() < 0 or c.max() >= m
            ):
                raise ValueError(f"{what} coordinates out of bounds for shape {self.shape}")
        up, de = self._keys()
        if np.unique(up).size != up.size:
            raise ValueError("duplicate coordinates in upserts")
        if np.unique(de).size != de.size:
            raise ValueError("duplicate coordinates in deletes")
        if up.size and de.size and np.intersect1d(up, de).size:
            raise ValueError("upsert and delete sets overlap")

    # ----------------------------------------------------------- application
    def apply(self, a: COO) -> COO:
        """Return a fresh canonical COO with this delta applied to ``a``.

        Deletes must name existing nonzeros (raises ``ValueError`` otherwise);
        upserts overwrite existing entries or append new ones.
        """
        self.validate()
        if tuple(a.shape) != tuple(self.shape):
            raise ValueError(f"delta shape {self.shape} != matrix shape {a.shape}")
        m = np.int64(self.shape[1])
        akey = a.row.astype(np.int64) * m + a.col.astype(np.int64)
        up, de = self._keys()
        if de.size:
            missing = np.setdiff1d(de, akey, assume_unique=False)
            if missing.size:
                r, c = int(missing[0] // m), int(missing[0] % m)
                raise ValueError(f"delete of non-existent entry ({r}, {c})")
        # Drop deleted entries and the old copies of overwritten entries.
        drop = np.concatenate([de, up])
        keep = np.ones(akey.shape[0], dtype=bool)
        if drop.size:
            keep = ~np.isin(akey, drop)
        dtype = a.val.dtype
        row = np.concatenate([a.row[keep], self.up_row.astype(a.row.dtype)])
        col = np.concatenate([a.col[keep], self.up_col.astype(a.col.dtype)])
        val = np.concatenate([a.val[keep], self.up_val.astype(dtype)])
        order = np.lexsort((col, row))
        return COO(
            shape=tuple(self.shape),
            row=np.ascontiguousarray(row[order]),
            col=np.ascontiguousarray(col[order]),
            val=np.ascontiguousarray(val[order]),
        )
