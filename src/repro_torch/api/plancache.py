"""Serving-grade plan store: save / load / memoize / GC planned sessions.

The port of the JAX package's ``repro/api/plancache.py``. Archives are
the same bytes in both packages — :func:`plan_key` gives the same name
for the same inputs, and an archive written by either package loads in
the other — and a loaded session computes on the device its caller
names (``device=``, the card by default), like every entry point of
the port.

The thesis' pipeline is *partition once, iterate many* — yet before this
module every process re-ran the whole planning pipeline (partition,
BELL packing, exchange schedule), which even vectorized costs ~10²–10³
steady-state SpMV iterations. A fleet of serving processes should plan
**once** and warm-start everywhere.

Three layers, all keyed on :func:`plan_key` — a content hash over
(matrix bytes + shape, topology, combo, block, exchange strategy, seed,
partitioner kwargs, format version):

* ``SparseSession.save(path)`` / ``SparseSession.load(path)`` — one
  ``.npz`` file holding every planning artifact (matrix, partition incl.
  the two-level plan and its comm stats, device plan, exchange plan)
  plus a JSON meta entry (``meta.json`` inside the archive) describing
  scalars and layout. Arrays round-trip bitwise, so a loaded session's
  ``spmv`` is bit-identical to the saved one's on every executor.
* ``distribute(..., cache_dir=...)`` — looks up ``<cache_dir>/
  plan-<key>.npz``; on miss it plans and writes the file. A fresh
  process pays one (lazy) file read instead of the full planning
  pipeline. ``cache_budget_bytes`` adds LRU pruning (:func:`gc`) so the
  directory cannot grow without bound.
* an in-process memo on the same key — a *second* ``distribute(...,
  cache_dir=...)`` call in the same process returns a re-wrapped
  session (plans and the executor-closure cache shared, exactly
  :meth:`SparseSession.with_executor` semantics) without touching disk.
  The memo bound is configurable, by session count and/or bytes
  (:func:`set_memo_limit`).

**Sparse v2 format** (DESIGN.md §11). Padding the stacked per-unit tile
arrays to the global max realizes load imbalance as wasted FLOPs at
runtime — but on disk it is pure bloat, and it dominated the v1 payload.
v2 persists only the *real* tiles (unit-major ragged concatenation +
the per-unit counts already in ``real_tiles``) and rebuilds the padded
form on load (:func:`repro_torch.sparse.bell.stack_ragged`); the derived
``tile_col_local`` workspace index is likewise dropped and rebuilt
(:func:`repro_torch.pmvc.plan_device.tile_col_local_from`). v1 archives load
transparently; :func:`save_session` can still emit v1 for fleets
mid-migration.

**Lazy, mmap-friendly loading.** ``load_session`` reads and validates
only the meta entry up front; the matrix, partition, and tile payloads
are deferred behind memoized thunks that materialize on first touch —
for a serving process, at its first ``spmv``. ``np.savez`` stores
members uncompressed (plans are mostly f32 payloads where zlib costs
seconds and saves little), so members are ``np.memmap``-ed straight out
of the archive where possible instead of buffered through the zip
reader.

**GC-vs-lazy-load safety.** A lazily loaded session holds only a *path*
until materialization — if :func:`gc` pruned its archive first, the
first ``spmv`` would fail with a missing file. Every lazy load therefore
registers the session in a per-path weak registry, and :func:`gc` skips
any archive a live, still-unmaterialized session was loaded from
(reported as ``files_pinned``). Once materialized, the arrays are
mmap/heap-backed and POSIX keeps a deleted file's pages alive for
existing maps, so materialized sessions no longer pin anything.

**Generations + delta journal.** :func:`save_generation` gives a named
plan a monotonically numbered archive lineage with an atomic
``plan-<name>.lastgood`` marker advanced only after a complete write —
a crash mid-save leaves the previous generation committed, never a torn
one. :func:`journal_delta` persists streaming updates
(:class:`repro_torch.sparse.delta.SparseDelta`) against the committed
generation so :func:`replay_journal` can roll a recovered session
forward to the pre-crash state; :func:`gc` never prunes the last-good
archive or its journal.
"""
from __future__ import annotations

import collections
import hashlib
import itertools
import json
import os
import re
import threading
import time
import weakref
import zipfile
import zlib
from typing import Callable, Dict, List, Optional, Set, Tuple, TYPE_CHECKING, Union

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.topology import Topology
from repro_torch.core.combined import CommStats, LevelSpec, TwoLevelPlan
from repro_torch.pmvc.plan_device import (
    DevicePlan,
    OverlapPlan,
    SelectivePlan,
    build_overlap_plan,
    tile_col_local_from,
)
from repro_torch.sparse.bell import ragged_from_stacked, stack_ragged
from repro_torch.sparse.delta import SparseDelta
from repro_torch.sparse.formats import COO

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.api.session import SparseSession

__all__ = [
    "FORMAT_VERSION",
    "READABLE_VERSIONS",
    "plan_key",
    "archive_members",
    "read_archive_meta",
    "expected_archive_members",
    "verify_archive_payload",
    "save_session",
    "load_session",
    "hydrate_session",
    "cached_distribute",
    "clear_memo",
    "set_memo_limit",
    "gc",
    "save_generation",
    "last_good_generation",
    "load_last_good",
    "journal_delta",
    "load_journal",
    "replay_journal",
]

FORMAT_VERSION = 2
# Formats this build reads: v1 (padded tile payloads) loads
# transparently; writes default to FORMAT_VERSION.
READABLE_VERSIONS = (1, 2)

# CRC-verify members served via the mmap fast path (the buffered
# fallback is always checked by zipfile). Default on: in-place bit rot
# must fail loudly, never compute garbage. A fleet on storage with its
# own end-to-end integrity (checksumming FS, verified object store) can
# flip this off to shave the ~GB/s streaming pass off materialization.
MMAP_CRC_CHECK = True

# Orphaned temp files (a writer killed mid-``np.savez``) older than this
# are swept by :func:`gc`; young ones may still be in-flight writes.
_TMP_MAX_AGE_S = 600.0
_TMP_COUNTER = itertools.count()

# In-process memo: key -> canonical loaded/planned session, LRU-bounded
# (a session pins the matrix plus dense f32 tile payloads — tens of MB
# at serving scale — so a long-lived process planning many distinct
# matrices must not accumulate them forever). Sessions handed out are
# re-wraps sharing plans + executor closures (the with_executor
# contract), so the memo never aliases mutable per-call state. Bounds
# are configurable via :func:`set_memo_limit`: ``_MEMO_MAX`` caps the
# session count (None = unbounded), ``_MEMO_MAX_BYTES`` the summed
# payload estimate (None = unbounded; the newest entry always stays).
_MEMO_MAX: Optional[int] = 8
_MEMO_MAX_BYTES: Optional[int] = None
_MEMO: "collections.OrderedDict[str, SparseSession]" = collections.OrderedDict()
_MEMO_NBYTES: Dict[str, int] = {}

_UNSET = object()


def set_memo_limit(*, max_sessions=_UNSET, max_bytes=_UNSET) -> Dict[str, Optional[int]]:
    """Configure the in-process memo bound; evicts immediately if the new
    bound is exceeded. ``max_sessions`` caps the entry count (default 8,
    ``None`` = unbounded); ``max_bytes`` caps the summed per-session
    payload estimate (``None`` = unbounded — when set, the most recent
    entry is always kept even if it alone exceeds the budget). Returns
    the active limits."""
    global _MEMO_MAX, _MEMO_MAX_BYTES
    if max_sessions is not _UNSET:
        _MEMO_MAX = max_sessions
    if max_bytes is not _UNSET:
        _MEMO_MAX_BYTES = max_bytes
    _evict_memo()
    return {"max_sessions": _MEMO_MAX, "max_bytes": _MEMO_MAX_BYTES}


def clear_memo() -> None:
    """Drop every in-process memoized session (the ``.npz`` files stay).
    Useful in tests and to release plan memory in long-lived processes."""
    _MEMO.clear()
    _MEMO_NBYTES.clear()


def _session_nbytes(sess: "SparseSession") -> int:
    """**Resident** bytes a memoized session pins right now: the summed
    numpy arrays of the planning artifacts that have actually
    materialized. A slot still behind a pending thunk counts zero — a
    lazy session holds only a path and meta until something touches it,
    so charging it the archive's logical payload size (the pre-fix
    behavior) made ``set_memo_limit(max_bytes=...)`` evict warm
    materialized plans to make room for cold ones occupying ~nothing.
    The accounting is refreshed at eviction time (:func:`_evict_memo`),
    so a session that materializes *after* insertion is re-charged its
    real footprint on the next bound check."""
    total = 0
    if not callable(sess._matrix):
        a = sess._matrix
        total += a.row.nbytes + a.col.nbytes + a.val.nbytes
    if not callable(sess._partition):
        part = sess._partition
        total += part.elem_unit.nbytes
        plan = part.plan
        if plan is not None:
            total += plan.elem_node.nbytes + plan.elem_core.nbytes
            for st in (plan.node_stats, plan.core_stats):
                total += (
                    st.nnz.nbytes + st.c_x.nbytes + st.c_y.nbytes + st.fr_x.nbytes
                )
    if not callable(sess._device_plan):
        dp = sess._device_plan
        total += dp.tiles.nbytes + dp.tile_row.nbytes + dp.tile_col.nbytes
    if not callable(sess._selective):
        sp = sess._selective
        op = sp if isinstance(sp, OverlapPlan) else None
        if op is not None:
            for f in ("local_tiles", "local_row", "local_slot",
                      "halo_tiles", "halo_row", "halo_slot",
                      "wave_send_idx", "wave_recv_src", "wave_recv_lane"):
                total += getattr(op, f).nbytes
            sp = op.selective
        if sp is not None:
            for f in ("owned", "send_idx", "recv_src", "recv_lane", "needed",
                      "tile_col_local"):
                total += getattr(sp, f).nbytes
    return total


def _memo_put(key: str, sess: "SparseSession") -> None:
    _MEMO[key] = sess
    _MEMO_NBYTES[key] = _session_nbytes(sess)
    _evict_memo()


def _evict_memo() -> None:
    def pop_oldest():
        k, _ = _MEMO.popitem(last=False)
        _MEMO_NBYTES.pop(k, None)

    if _MEMO_MAX is not None:
        while len(_MEMO) > max(int(_MEMO_MAX), 0):
            pop_oldest()
    if _MEMO_MAX_BYTES is not None:
        # Lazy sessions materialize after insertion; re-measure so the
        # byte bound sees resident reality, not insertion-time estimates.
        for k, s in _MEMO.items():
            _MEMO_NBYTES[k] = _session_nbytes(s)
        while len(_MEMO) > 1 and sum(_MEMO_NBYTES.values()) > _MEMO_MAX_BYTES:
            pop_oldest()


# Lazy sessions loaded from disk, per archive path (weak — sessions the
# caller dropped don't pin anything). gc() skips a plan file while any
# live session loaded from it is still unmaterialized: pruning it would
# turn that session's first materialization into a missing-file error
# (the gc-vs-lazy-load race). Materialized sessions are safe — the
# arrays are heap- or mmap-backed, and POSIX keeps a deleted file's
# pages alive for existing maps.
_LIVE_LAZY: Dict[str, "weakref.WeakSet"] = {}

# Serializes lazy-load registration against gc's check-then-remove: a
# load that completes before gc examines its file is pinned; one that
# starts after the file is gone misses loudly at *load* time (a cache
# miss, replanned) — never at materialization time with a session
# already handed out.
_STORE_LOCK = threading.Lock()


def _register_lazy(path: str, sess: "SparseSession") -> None:
    _LIVE_LAZY.setdefault(os.path.abspath(path), weakref.WeakSet()).add(sess)


def _lazy_pinned_paths() -> Set[str]:
    """Archive paths at least one live, unmaterialized session points at."""
    pinned: Set[str] = set()
    for p, refs in list(_LIVE_LAZY.items()):
        live = list(refs)
        if any(not s.is_materialized for s in live):
            pinned.add(p)
        elif not live:
            _LIVE_LAZY.pop(p, None)  # all sessions gone; drop the slot
    return pinned


def _matrix_digest(a: COO) -> bytes:
    """Digest of the matrix *content* (row/col/val bytes), cached on the
    COO instance: hashing a multi-MB matrix costs ~10 ms, which would
    otherwise dominate every in-process memo hit. :class:`COO` is a
    frozen dataclass treated as immutable throughout the code base — if
    you mutate its arrays in place anyway, build a fresh COO before
    planning or the cache will serve stale plans."""
    cached = getattr(a, "_content_digest", None)
    if cached is None:
        h = hashlib.blake2b(digest_size=16)
        for arr in (a.row, a.col, a.val):
            h.update(np.ascontiguousarray(arr).tobytes())
        cached = h.digest()
        object.__setattr__(a, "_content_digest", cached)
    return cached


def plan_key(
    a: COO,
    topology: Topology,
    combo: str,
    block: Union[int, Tuple[int, int]],
    exchange: str,
    seed: int,
    partitioner_kw: Optional[dict] = None,
) -> str:
    """Content hash identifying one planning run.

    Covers everything the planning pipeline reads: the matrix *content*
    (shape + row/col/val bytes), the (nodes × cores) topology, the
    partitioner combo and its kwargs, the (bm, bn) block (an int is
    normalized to (b, b) exactly as :func:`repro_torch.api.distribute` does,
    so ``plan_key(..., 16, ...)`` names the same file as
    ``distribute(..., block=16, cache_dir=...)`` wrote), the exchange
    strategy, the seed, and the serialization format version (so a
    format bump orphans old files explicitly instead of mis-reading
    them; orphans age out under a GC budget). The executor is
    deliberately excluded — it is runtime state, not plan.
    """
    bm, bn = (block, block) if isinstance(block, int) else block
    h = hashlib.blake2b(digest_size=16)
    kw = sorted((partitioner_kw or {}).items())
    h.update(
        f"v{FORMAT_VERSION}|{a.shape}|{topology.nodes}x{topology.cores}"
        f"|{combo}|{(bm, bn)}|{exchange}|{seed}|{kw!r}".encode()
    )
    h.update(_matrix_digest(a))
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Serialization: shared pieces


def _comm_stats_arrays(prefix: str, st: CommStats, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.nnz"] = st.nnz
    out[f"{prefix}.c_x"] = st.c_x
    out[f"{prefix}.c_y"] = st.c_y
    out[f"{prefix}.fr_x"] = st.fr_x


def _comm_stats_from(prefix: str, get) -> CommStats:
    return CommStats(
        nnz=get(f"{prefix}.nnz"),
        c_x=get(f"{prefix}.c_x"),
        c_y=get(f"{prefix}.c_y"),
        fr_x=get(f"{prefix}.fr_x"),
    )


_SELECTIVE_FIELDS = ("owned", "send_idx", "recv_src", "recv_lane", "needed")
_OVERLAP_RAGGED = (
    ("local_tiles", "local_counts"),
    ("local_row", "local_counts"),
    ("local_slot", "local_counts"),
    ("halo_tiles", "halo_counts"),
    ("halo_row", "halo_counts"),
    ("halo_slot", "halo_counts"),
)


def _selective_meta(sp: SelectivePlan) -> dict:
    return {
        "num_units": sp.num_units,
        "blocks_per_unit": sp.blocks_per_unit,
        "lanes": sp.lanes,
        "wire_blocks": sp.wire_blocks,
        "naive_blocks": sp.naive_blocks,
    }


def _base_meta_and_arrays(sess: "SparseSession", version: int):
    """Matrix + partition + meta scaffolding common to both formats."""
    arrays: Dict[str, np.ndarray] = {}
    a = sess.matrix
    arrays["mat.row"] = a.row
    arrays["mat.col"] = a.col
    arrays["mat.val"] = a.val

    part = sess.partition
    arrays["part.elem_unit"] = part.elem_unit
    meta: dict = {
        "version": version,
        "shape": list(a.shape),
        "topology": {"nodes": sess.topology.nodes, "cores": sess.topology.cores},
        "exchange": sess.exchange,
        "executor": sess.executor,
        "partition": {"name": part.name, "cut": part.cut},
    }

    plan = part.plan
    meta["two_level"] = None
    if plan is not None:
        arrays["plan.elem_node"] = plan.elem_node
        arrays["plan.elem_core"] = plan.elem_core
        _comm_stats_arrays("plan.node_stats", plan.node_stats, arrays)
        _comm_stats_arrays("plan.core_stats", plan.core_stats, arrays)
        meta["two_level"] = {
            "combo": plan.combo,
            "inter": [plan.inter.method, plan.inter.dim],
            "intra": [plan.intra.method, plan.intra.dim],
            "f": plan.f,
            "c": plan.c,
            "nnz": plan.nnz,
            "inter_fd": plan.inter_fd,
            "hyper_cut": plan.hyper_cut,
        }
    return arrays, meta


def _apply_transform(sess: "SparseSession", arr: np.ndarray) -> np.ndarray:
    """Bake a value view's transform into a tile payload at save time —
    the archive always stores final values, never a transform recipe."""
    tt = sess.tile_transform
    if tt is None:
        return arr
    return np.asarray(tt(np.asarray(arr)), dtype=np.float32)


def _pack_v1(sess: "SparseSession"):
    """Legacy layout: padded stacked tile arrays + stored tile_col_local
    (byte-compatible with the first writer, for fleets mid-migration)."""
    arrays, meta = _base_meta_and_arrays(sess, 1)
    dp = sess.device_plan
    arrays["dp.tiles"] = _apply_transform(sess, dp.tiles)
    arrays["dp.tile_row"] = dp.tile_row
    arrays["dp.tile_col"] = dp.tile_col
    arrays["dp.real_tiles"] = dp.real_tiles
    meta["device_plan"] = {"bm": dp.bm, "bn": dp.bn, "num_units": dp.num_units}

    sp = sess.selective
    if sp is None:
        meta["exchange_plan"] = None
    elif isinstance(sp, OverlapPlan):
        if sp.waves != 1:
            raise ValueError(
                "plan format v1 predates multi-wave overlap plans; save "
                f"waves={sp.waves} plans with the default v2 format"
            )
        for field in _SELECTIVE_FIELDS + ("tile_col_local",):
            arrays[f"sp.{field}"] = getattr(sp.selective, field)
        for field, _ in _OVERLAP_RAGGED:
            arr = getattr(sp, field)
            if field.startswith("halo"):
                arr = arr[:, 0]  # squeeze the single wave — legacy layout
            if field.endswith("tiles"):
                arr = _apply_transform(sess, arr)
            arrays[f"op.{field}"] = arr
        arrays["op.local_counts"] = sp.local_counts
        arrays["op.halo_counts"] = sp.halo_counts
        meta["exchange_plan"] = {"kind": "overlap", "selective": _selective_meta(sp.selective)}
    else:
        for field in _SELECTIVE_FIELDS + ("tile_col_local",):
            arrays[f"sp.{field}"] = getattr(sp, field)
        meta["exchange_plan"] = {"kind": "selective", "selective": _selective_meta(sp)}
    return arrays, meta


def _pack_v2(sess: "SparseSession"):
    """Sparse layout: real tiles only (unit-major ragged + counts);
    padding and the derived tile_col_local are rebuilt on load."""
    arrays, meta = _base_meta_and_arrays(sess, 2)
    dp = sess.device_plan
    counts = dp.real_tiles
    arrays["dp.tiles"] = _apply_transform(sess, ragged_from_stacked(dp.tiles, counts))
    arrays["dp.tile_row"] = ragged_from_stacked(dp.tile_row, counts)
    arrays["dp.tile_col"] = ragged_from_stacked(dp.tile_col, counts)
    arrays["dp.real_tiles"] = counts
    meta["device_plan"] = {
        "bm": dp.bm,
        "bn": dp.bn,
        "num_units": dp.num_units,
        "t": dp.t,
    }

    sp = sess.selective
    if sp is None:
        meta["exchange_plan"] = None
        return arrays, meta
    op = sp if isinstance(sp, OverlapPlan) else None
    sel = op.selective if op is not None else sp
    for field in _SELECTIVE_FIELDS:
        arrays[f"sp.{field}"] = getattr(sel, field)
    if op is None:
        meta["exchange_plan"] = {"kind": "selective", "selective": _selective_meta(sel)}
        return arrays, meta
    for field, _ in _OVERLAP_RAGGED:
        arr = getattr(op, field)
        if field.startswith("halo"):
            # Wave-shaped [U, K, TH, ...]: ragged over the U*K rows with
            # the per-(unit, wave) real counts — padding never hits disk.
            u, k = arr.shape[0], arr.shape[1]
            ragged = ragged_from_stacked(
                arr.reshape((u * k,) + arr.shape[2:]),
                op.halo_wave_counts.reshape(-1),
            )
        else:
            ragged = ragged_from_stacked(arr, op.local_counts)
        if field.endswith("tiles"):
            ragged = _apply_transform(sess, ragged)
        arrays[f"op.{field}"] = ragged
    arrays["op.local_counts"] = op.local_counts
    arrays["op.halo_wave_counts"] = op.halo_wave_counts
    # Wave routing schedules are dense (−1 = unused lane) — stored as-is.
    arrays["op.wave_send_idx"] = op.wave_send_idx
    arrays["op.wave_recv_src"] = op.wave_recv_src
    arrays["op.wave_recv_lane"] = op.wave_recv_lane
    meta["exchange_plan"] = {
        "kind": "overlap",
        "selective": _selective_meta(sel),
        "t_local": op.t_local,
        "t_halo": op.t_halo,
        "waves": op.waves,
    }
    return arrays, meta


def save_session(
    sess: "SparseSession", path: str, *, format_version: Optional[int] = None
) -> str:
    """Serialize every planning artifact of ``sess`` into one ``.npz``.

    Returns the path written (``path``, with ``.npz`` appended when
    missing). Not stored: the executor's closures (rebuilt
    lazily on first use) — everything else round-trips bitwise. The
    write is atomic (unique temp file + ``os.replace``), so concurrent
    writers to one path and crash-mid-write both leave either the old
    complete file or the new one under the final name, never a torn
    archive. ``format_version=1`` emits the legacy padded layout.
    """
    version = FORMAT_VERSION if format_version is None else int(format_version)
    if version not in READABLE_VERSIONS:
        raise ValueError(f"unknown plan format v{version}, know {READABLE_VERSIONS}")
    arrays, meta = (_pack_v1 if version == 1 else _pack_v2)(sess)
    meta["version"] = version  # a bumped FORMAT_VERSION stamps through
    meta["nbytes"] = int(sum(int(np.asarray(a).nbytes) for a in arrays.values()))

    # Write-then-rename so concurrent readers (sibling serving processes
    # polling the cache_dir) never see a partially-written archive. The
    # temp name is unique per call (pid + counter): two threads saving
    # the same key race harmlessly — last rename wins with a complete
    # file either way.
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = f"{final}.tmp-{os.getpid()}-{next(_TMP_COUNTER)}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays, **{"meta.json": np.array(json.dumps(meta))})
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return final


# ---------------------------------------------------------------------------
# Loading: meta validation up front, mmap-backed lazy payloads


def _read_meta_and_names(path: str):
    """Parse the archive's central directory + meta entry — the cheap
    integrity gate every load pays before any payload I/O. Raises
    ``ValueError`` on anything unreadable (truncated zip, missing meta),
    which :func:`cached_distribute` treats as a cache miss."""
    try:
        with zipfile.ZipFile(path) as zf:
            names = {n[:-4] for n in zf.namelist() if n.endswith(".npy")}
            if "meta.json" not in names:
                raise ValueError(f"plan file {path!r} has no meta.json entry")
            with zf.open("meta.json.npy") as fh:
                arr = np.lib.format.read_array(fh, allow_pickle=False)
        meta = json.loads(str(arr[()]))
    except ValueError:
        raise
    except Exception as e:  # BadZipFile, OSError, JSONDecodeError, KeyError...
        raise ValueError(f"unreadable plan file {path!r}: {e}") from e
    return meta, names


def read_archive_meta(path: str):
    """Public accessor for an archive's parsed meta entry and member-name
    set (``(meta, names)``) — what the :mod:`repro_torch.analysis` archive
    passes and external tooling build on. Raises ``ValueError`` on an
    unreadable archive."""
    return _read_meta_and_names(path)


def expected_archive_members(meta: dict) -> Set[str]:
    """The member names a complete archive with this meta must carry —
    the presence gate :func:`load_session` enforces, exposed for the
    analysis layer's structure pass."""
    return _expected_members(meta)


def _expected_members(meta: dict) -> Set[str]:
    version = meta["version"]
    members = {
        "mat.row", "mat.col", "mat.val", "part.elem_unit",
        "dp.tiles", "dp.tile_row", "dp.tile_col", "dp.real_tiles",
    }
    if meta["two_level"] is not None:
        members |= {"plan.elem_node", "plan.elem_core"}
        for prefix in ("plan.node_stats", "plan.core_stats"):
            members |= {f"{prefix}.{f}" for f in ("nnz", "c_x", "c_y", "fr_x")}
    ep = meta["exchange_plan"]
    if ep is not None:
        fields = _SELECTIVE_FIELDS + (("tile_col_local",) if version == 1 else ())
        members |= {f"sp.{f}" for f in fields}
        if ep["kind"] == "overlap":
            members |= {f"op.{f}" for f, _ in _OVERLAP_RAGGED}
            members |= {"op.local_counts"}
            if version == 2 and ep.get("waves") is not None:
                members |= {
                    "op.halo_wave_counts",
                    "op.wave_send_idx",
                    "op.wave_recv_src",
                    "op.wave_recv_lane",
                }
            else:  # pre-wave layout (v1, or v2 written before waves)
                members |= {"op.halo_counts"}
    return members


def _member_payload_offset(fh, path: str, info: "zipfile.ZipInfo") -> int:
    """Byte offset of the member's raw payload inside the archive file
    (past the zip local header). Raises ``ValueError`` naming the member
    and its header offset when the local header is damaged."""
    fh.seek(info.header_offset)
    hdr = fh.read(30)
    if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
        raise ValueError(
            f"plan file {path!r}: bad local header for member "
            f"{info.filename!r} at byte offset {info.header_offset}"
        )
    nlen = int.from_bytes(hdr[26:28], "little")
    elen = int.from_bytes(hdr[28:30], "little")
    return info.header_offset + 30 + nlen + elen


def _verify_member_crc(path: str, info: "zipfile.ZipInfo") -> None:
    """Stream the member's raw bytes through CRC-32 against the archive's
    recorded checksum. The mmap fast path bypasses zipfile's read-time
    CRC check, which is the *only* line of defense against in-place
    payload corruption (bit rot, partial overwrite) in a structurally
    valid archive — without this, a flipped byte in a tile member would
    compute silently wrong results instead of failing loudly. One
    sequential pass at materialization time (~GB/s, and it pre-warms the
    page cache the memmap then serves from). Failures name the member
    and the byte offset of the fault, so an operator can localize the
    damage without a hex editor."""
    crc = 0
    with open(path, "rb") as fh:
        data_off = _member_payload_offset(fh, path, info)
        fh.seek(data_off)
        left = info.file_size
        while left:
            chunk = fh.read(min(left, 1 << 22))
            if not chunk:
                raise ValueError(
                    f"plan file {path!r}: member {info.filename!r} truncated "
                    f"at byte offset {data_off + info.file_size - left} "
                    f"({left} of {info.file_size} payload bytes missing)"
                )
            crc = zlib.crc32(chunk, crc)
            left -= len(chunk)
    if crc != info.CRC:
        raise ValueError(
            f"plan file {path!r}: CRC mismatch in member {info.filename!r} "
            f"(payload at byte offset {data_off}, {info.file_size} bytes; "
            f"expected crc32 {info.CRC:#010x}, got {crc:#010x}) "
            "— in-place corruption; evict the file and replan"
        )


def archive_members(path: str) -> Dict[str, dict]:
    """Layout of every ``.npy`` member in a plan archive, keyed by the
    array name (``.npy`` suffix stripped): ``header_offset`` /
    ``payload_offset`` / ``size`` (raw payload bytes) / ``crc`` /
    ``compressed``. The byte offsets are what load-failure messages and
    the :mod:`repro_torch.analysis` archive passes report, so faults localize
    to a file range. Raises ``ValueError`` on an unreadable archive."""
    out: Dict[str, dict] = {}
    try:
        with zipfile.ZipFile(path) as zf:
            infos = [i for i in zf.infolist() if i.filename.endswith(".npy")]
        with open(path, "rb") as fh:
            for info in infos:
                out[info.filename[: -len(".npy")]] = {
                    "header_offset": info.header_offset,
                    "payload_offset": _member_payload_offset(fh, path, info),
                    "size": info.file_size,
                    "crc": info.CRC,
                    "compressed": info.compress_type != zipfile.ZIP_STORED,
                }
    except ValueError:
        raise
    except Exception as e:  # BadZipFile, OSError...
        raise ValueError(f"unreadable plan file {path!r}: {e}") from e
    return out


def verify_archive_payload(path: str, members=None) -> None:
    """CRC-check the raw payload bytes of ``members`` (default: every
    ``.npy`` member) against the archive's recorded checksums. Raises
    ``ValueError`` naming the failing member and the byte offset of the
    fault — the archive-integrity primitive behind
    ``python -m repro_torch.analysis``."""
    with zipfile.ZipFile(path) as zf:
        infos = {
            i.filename[: -len(".npy")]: i
            for i in zf.infolist()
            if i.filename.endswith(".npy")
        }
    names = list(infos) if members is None else list(members)
    for name in names:
        info = infos.get(name)
        if info is None:
            raise ValueError(f"plan file {path!r} has no member {name + '.npy'!r}")
        if info.compress_type != zipfile.ZIP_STORED:
            # The recorded CRC covers *uncompressed* data — stream the
            # member through zipfile, which checks it on the way out.
            try:
                with zipfile.ZipFile(path) as zf, zf.open(info) as fh:
                    while fh.read(1 << 20):
                        pass
            except Exception as e:
                raise ValueError(
                    f"plan file {path!r}: member {info.filename!r} failed "
                    f"integrity check (local header at byte offset "
                    f"{info.header_offset}): {e}"
                ) from e
        else:
            _verify_member_crc(path, info)


def _mmap_member(path: str, name: str) -> Optional[np.ndarray]:
    """Memory-map one uncompressed ``.npy`` member straight out of the
    archive (np.savez = ZIP_STORED, so the raw array bytes sit
    contiguously at a fixed offset), after a CRC-32 pass over its bytes.
    Returns ``None`` when the member cannot be mapped — caller falls
    back to a buffered read (which CRC-checks internally). Raises
    ``ValueError`` on a checksum mismatch."""
    try:
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo(name + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                return None
        with open(path, "rb") as fh:
            fh.seek(info.header_offset)
            hdr = fh.read(30)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                return None
            nlen = int.from_bytes(hdr[26:28], "little")
            elen = int.from_bytes(hdr[28:30], "little")
            fh.seek(info.header_offset + 30 + nlen + elen)
            version = np.lib.format.read_magic(fh)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(fh)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(fh)
            else:
                return None
            if dtype.hasobject:
                return None
            if int(np.prod(shape)) == 0:
                return np.zeros(shape, dtype=dtype)
            offset = fh.tell()
    except ValueError:
        raise
    except Exception:
        return None
    if MMAP_CRC_CHECK:
        _verify_member_crc(path, info)
    return np.memmap(
        path, dtype=dtype, mode="r", shape=shape, offset=offset,
        order="F" if fortran else "C",
    )


class _ArchiveReader:
    """Per-member access into one saved plan, opened on demand so a lazy
    session holds no file descriptor between load and materialization.
    Every byte handed out is CRC-checked (by :func:`_verify_member_crc`
    on the mmap path, by zipfile on the buffered fallback), so in-place
    corruption surfaces as ``ValueError``/``BadZipFile`` at
    materialization — never as silently wrong numerics."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, name: str) -> np.ndarray:
        m = _mmap_member(self.path, name)
        if m is not None:
            return m
        try:
            with np.load(self.path, allow_pickle=False) as z:
                return z[name]
        except ValueError:
            raise  # already localized (CRC / header faults name the member)
        except Exception as e:  # BadZipFile, zlib.error, OSError, KeyError...
            where = ""
            try:
                with zipfile.ZipFile(self.path) as zf:
                    info = zf.getinfo(name + ".npy")
                where = (
                    f" (local header at byte offset {info.header_offset}, "
                    f"{info.file_size} payload bytes)"
                )
            except Exception:
                pass  # archive too damaged to localize further
            raise ValueError(
                f"plan file {self.path!r}: failed reading member "
                f"{name + '.npy'!r}{where}: {e}"
            ) from e


def _memoized(fn: Callable):
    """Wrap a loader so it runs once and every sharer sees one object —
    the thunk contract :class:`SparseSession` lazy slots rely on."""
    box: list = []

    def thunk():
        if not box:
            box.append(fn())
        return box[0]

    return thunk


def load_session(
    path: str,
    *,
    executor: Optional[str] = None,
    lazy: bool = True,
    device=None,
) -> "SparseSession":
    """Rebuild a :class:`SparseSession` from :func:`save_session` output
    (v1 or v2 archives).

    Validates the archive structure (readable zip, known format version,
    every expected member present) and reads the meta entry eagerly;
    matrix / partition / device plan / exchange plan materialize behind
    memoized thunks on first touch, mmap-backed where possible
    (``lazy=False`` forces them now). ``executor`` overrides the saved
    default executor (the plans are executor-agnostic); compiled
    closures are rebuilt lazily either way. The meta keeps the executor
    name it was saved with, ``shard_map`` included: without an
    ``executor`` override, such a session raises the executor
    registry's ``KeyError`` at its first ``spmv``. ``device`` is where
    the session computes — the card when omitted (``RuntimeError`` when
    there is none), or any ``torch.device`` the caller names. Raises
    ``ValueError`` on a corrupt or unknown-format archive.
    """
    from repro_torch.api.partitioners import PartitionResult
    from repro_torch.api.session import SparseSession

    dev = resolve_device(device)
    meta, names = _read_meta_and_names(path)
    version = meta.get("version")
    if version not in READABLE_VERSIONS:
        raise ValueError(
            f"plan cache {path!r} has format v{version}, this build reads "
            f"v{READABLE_VERSIONS[0]}..v{READABLE_VERSIONS[-1]}"
        )
    missing = _expected_members(meta) - names
    if missing:
        raise ValueError(f"plan file {path!r} is missing arrays {sorted(missing)}")

    shape = tuple(meta["shape"])
    topology = Topology(**meta["topology"])
    read = _ArchiveReader(path)

    def make_matrix() -> COO:
        return COO(shape, read("mat.row"), read("mat.col"), read("mat.val"))

    def make_partition() -> PartitionResult:
        two_level = None
        if meta["two_level"] is not None:
            tl = meta["two_level"]
            two_level = TwoLevelPlan(
                combo=tl["combo"],
                inter=LevelSpec(*tl["inter"]),
                intra=LevelSpec(*tl["intra"]),
                f=tl["f"],
                c=tl["c"],
                shape=shape,
                nnz=tl["nnz"],
                elem_node=read("plan.elem_node"),
                elem_core=read("plan.elem_core"),
                node_stats=_comm_stats_from("plan.node_stats", read),
                core_stats=_comm_stats_from("plan.core_stats", read),
                inter_fd=tl["inter_fd"],
                hyper_cut=tl["hyper_cut"],
            )
        return PartitionResult(
            name=meta["partition"]["name"],
            topology=topology,
            elem_unit=read("part.elem_unit"),
            plan=two_level,
            cut=meta["partition"]["cut"],
        )

    dpm = meta["device_plan"]

    def make_device_plan() -> DevicePlan:
        if version == 1:
            tiles = read("dp.tiles")
            tile_row = read("dp.tile_row")
            tile_col = read("dp.tile_col")
            counts = read("dp.real_tiles")
        else:
            counts = np.asarray(read("dp.real_tiles"))
            t = dpm["t"]
            tiles = stack_ragged(np.asarray(read("dp.tiles")), counts, t)
            tile_row = stack_ragged(np.asarray(read("dp.tile_row")), counts, t)
            tile_col = stack_ragged(np.asarray(read("dp.tile_col")), counts, t)
        return DevicePlan(
            shape=shape,
            bm=dpm["bm"],
            bn=dpm["bn"],
            num_units=dpm["num_units"],
            tiles=tiles,
            tile_row=tile_row,
            tile_col=tile_col,
            real_tiles=counts,
        )

    dp_thunk = _memoized(make_device_plan)
    epm = meta["exchange_plan"]

    def make_selective():
        sel_meta = epm["selective"]
        needed = read("sp.needed")
        if version == 1:
            tile_col_local = read("sp.tile_col_local")
        else:
            dp = dp_thunk()
            tile_col_local = tile_col_local_from(
                np.asarray(needed), dp.tile_col, dp.num_col_blocks
            ).astype(dp.tile_col.dtype)
        sel = SelectivePlan(
            num_units=sel_meta["num_units"],
            blocks_per_unit=sel_meta["blocks_per_unit"],
            lanes=sel_meta["lanes"],
            owned=read("sp.owned"),
            send_idx=read("sp.send_idx"),
            recv_src=read("sp.recv_src"),
            recv_lane=read("sp.recv_lane"),
            needed=needed,
            tile_col_local=tile_col_local,
            wire_blocks=sel_meta["wire_blocks"],
            naive_blocks=sel_meta["naive_blocks"],
        )
        if epm["kind"] != "overlap":
            return sel
        if version == 1 or epm.get("waves") is None:
            # Pre-wave archive (v1, or a v2 written before the wave
            # layout): the local/halo split and the wave-0 routing are a
            # pure function of (device plan, selective schedule), so the
            # single-wave plan is rebuilt rather than translated — the
            # stored op.* arrays only served the old reader.
            return build_overlap_plan(dp_thunk(), sel, waves=1)
        local_counts = np.asarray(read("op.local_counts"))
        hwc = np.asarray(read("op.halo_wave_counts"))
        u, k = hwc.shape
        fields = {"local_counts": local_counts, "halo_wave_counts": hwc}
        for field, _ in _OVERLAP_RAGGED:
            raw = np.asarray(read(f"op.{field}"))
            if field.startswith("halo"):
                stacked = stack_ragged(raw, hwc.reshape(-1), epm["t_halo"])
                fields[field] = stacked.reshape((u, k) + stacked.shape[1:])
            else:
                fields[field] = stack_ragged(raw, local_counts, epm["t_local"])
        for field in ("wave_send_idx", "wave_recv_src", "wave_recv_lane"):
            fields[field] = read(f"op.{field}")
        return OverlapPlan(selective=sel, **fields)

    sess = SparseSession(
        _memoized(make_matrix),
        topology,
        _memoized(make_partition),
        dp_thunk,
        exchange=meta["exchange"],
        selective=None if epm is None else _memoized(make_selective),
        executor=executor or meta["executor"],
        device=dev,
    )
    sess._payload_nbytes = meta.get("nbytes")
    if not lazy:
        sess.materialize()
    else:
        # Pin the archive against gc() until the session materializes
        # (or is dropped) — see _LIVE_LAZY. Register-then-verify under
        # the store lock: gc's check-then-remove holds the same lock, so
        # either it sees this pin, or it already removed the file and
        # the load fails *here* (a clean miss), never later at
        # materialization with the session in a caller's hands.
        with _STORE_LOCK:
            _register_lazy(path, sess)
            if not os.path.exists(path):
                raise ValueError(
                    f"plan file {path!r} was garbage-collected mid-load"
                )
    return sess


# ---------------------------------------------------------------------------
# Disk-cache GC


def _touch(path: str) -> None:
    """Mark a plan file as recently used (explicit atime bump — relatime
    and noatime mounts would otherwise starve the LRU order)."""
    try:
        st = os.stat(path)
        os.utime(path, times=(time.time(), st.st_mtime))
    except OSError:
        pass


def gc(cache_dir: str, budget_bytes: int, *, keep=()) -> Dict[str, int]:
    """Prune ``plan-*.npz`` files least-recently-used-first (access time
    order — cache hits :func:`_touch` their file, so LRU is explicit,
    not mount-option-dependent) until the directory total is within
    ``budget_bytes``. ``keep`` paths are never removed, whatever the
    budget — :func:`cached_distribute` protects the plan it just wrote.

    Two more classes of files are *pinned* (skipped, counted in
    ``files_pinned``): archives a live lazy session was loaded from and
    has not yet materialized (removing one would break that session's
    first ``spmv`` — the gc-vs-lazy-load race), and each lineage's
    last-good generation archive plus its journal deltas (the recovery
    contract of :func:`save_generation`). Orphaned ``.tmp-*`` files from
    crashed writers older than ~10 min are swept as well. Returns
    ``{"files_removed", "bytes_freed", "bytes_in_use", "tmp_removed",
    "files_pinned"}``.
    """
    keep_paths = {os.path.abspath(p) for p in keep}
    # Under the store lock: a lazy load registering its session while the
    # registry is read would change the set mid-iteration (RuntimeError).
    with _STORE_LOCK:
        pinned_paths = _lazy_pinned_paths()
    now = time.time()
    entries = []
    tmp_removed = 0
    try:
        listing = os.listdir(cache_dir)
    except OSError:
        return {"files_removed": 0, "bytes_freed": 0, "bytes_in_use": 0,
                "tmp_removed": 0, "files_pinned": 0}
    # Last-good generation archives (and their journals) are the crash
    # recovery story — never LRU them out, whatever the budget.
    for name in listing:
        if not name.endswith(".lastgood"):
            continue
        try:
            with open(os.path.join(cache_dir, name)) as fh:
                gen = int(fh.read().strip())
        except (OSError, ValueError):
            continue
        stem = name[: -len(".lastgood")]
        pinned_paths.add(
            os.path.abspath(os.path.join(cache_dir, f"{stem}.gen{gen:06d}.npz"))
        )
        prefix = f"{stem}.gen{gen:06d}.delta"
        for other in listing:
            if other.startswith(prefix) and other.endswith(".npz"):
                pinned_paths.add(os.path.abspath(os.path.join(cache_dir, other)))
    for name in listing:
        p = os.path.join(cache_dir, name)
        try:
            st = os.stat(p)
        except OSError:
            continue  # raced with a concurrent gc/writer
        if ".tmp-" in name:
            if now - st.st_mtime > _TMP_MAX_AGE_S:
                try:
                    os.remove(p)
                    tmp_removed += 1
                except OSError:
                    pass
            continue
        if name.startswith("plan-") and name.endswith(".npz"):
            entries.append((st.st_atime, st.st_size, p))
    total = sum(size for _, size, _ in entries)
    removed = freed = pinned = 0
    for _, size, p in sorted(entries):
        if total <= budget_bytes:
            break
        ap = os.path.abspath(p)
        if ap in keep_paths:
            continue
        # Check-then-remove is atomic w.r.t. lazy loads (see
        # _STORE_LOCK): the lazy pin set is re-read here so a load that
        # completed during this gc pass is honored, not just the ones
        # alive when the pass started.
        with _STORE_LOCK:
            if ap in pinned_paths or ap in _lazy_pinned_paths():
                pinned += 1
                continue
            try:
                os.remove(p)
            except OSError:
                continue
        total -= size
        removed += 1
        freed += size
    return {"files_removed": removed, "bytes_freed": freed,
            "bytes_in_use": total, "tmp_removed": tmp_removed,
            "files_pinned": pinned}


# ---------------------------------------------------------------------------
# Generations + delta journal: the recovery substrate for elastic serving.
#
# A *lineage* is a named sequence of checkpointed plans for one evolving
# graph. save_generation() writes ``plan-{name}.gen000007.npz`` then
# atomically advances the ``plan-{name}.lastgood`` marker — readers that
# follow the marker never observe a half-written generation. Between
# checkpoints, journal_delta() appends the SparseDeltas applied since the
# last good generation; load_last_good() + replay_journal() reconstructs
# the exact live session (updates are deterministic, so the replayed
# chain is bitwise-identical to the uninterrupted one).


def _lineage_stem(name: str) -> str:
    if not name or "/" in name or os.sep in name:
        raise ValueError(f"bad lineage name {name!r}")
    return f"plan-{name}"


def _gen_archive(cache_dir: str, name: str, gen: int) -> str:
    return os.path.join(cache_dir, f"{_lineage_stem(name)}.gen{gen:06d}.npz")


def _marker_path(cache_dir: str, name: str) -> str:
    return os.path.join(cache_dir, f"{_lineage_stem(name)}.lastgood")


def _list_generations(cache_dir: str, name: str) -> List[int]:
    """Generation numbers with an archive on disk, ascending."""
    pat = re.compile(rf"^{re.escape(_lineage_stem(name))}\.gen(\d+)\.npz$")
    gens = []
    try:
        listing = os.listdir(cache_dir)
    except OSError:
        return []
    for fname in listing:
        m = pat.match(fname)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens)


def last_good_generation(cache_dir: str, name: str) -> Optional[int]:
    """The marker's committed generation, or None (no marker / garbage)."""
    try:
        with open(_marker_path(cache_dir, name)) as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None


def save_generation(
    sess: "SparseSession", cache_dir: str, name: str, *, before_commit=None
) -> tuple:
    """Checkpoint ``sess`` as the next generation of lineage ``name``.

    Three ordered, individually-atomic steps: (1) write the generation
    archive (:func:`save_session`'s temp+rename), (2) atomically advance
    the ``.lastgood`` marker, (3) prune journal deltas of *older*
    generations (superseded by the new checkpoint). A crash between any
    two steps leaves the previous generation fully recoverable — the
    marker only ever points at a complete archive. ``before_commit``
    (test/chaos hook) runs between (1) and (2); if it raises, the marker
    still names the old generation. Returns ``(path, gen)``.
    """
    os.makedirs(cache_dir, exist_ok=True)
    gens = _list_generations(cache_dir, name)
    gen = (gens[-1] + 1) if gens else 0
    path = save_session(sess, _gen_archive(cache_dir, name, gen))
    if before_commit is not None:
        before_commit()
    marker = _marker_path(cache_dir, name)
    tmp = f"{marker}.tmp-{os.getpid()}-{next(_TMP_COUNTER)}"
    try:
        with open(tmp, "w") as fh:
            fh.write(f"{gen}\n")
        os.replace(tmp, marker)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    # Journals of older generations are now superseded; the new lineage
    # starts an empty journal against `gen`.
    pat = re.compile(
        rf"^{re.escape(_lineage_stem(name))}\.gen(\d+)\.delta\d+\.npz$"
    )
    try:
        for fname in os.listdir(cache_dir):
            m = pat.match(fname)
            if m and int(m.group(1)) < gen:
                try:
                    os.remove(os.path.join(cache_dir, fname))
                except OSError:
                    pass
    except OSError:
        pass
    return path, gen


def load_last_good(
    cache_dir: str,
    name: str,
    *,
    executor: Optional[str] = None,
    lazy: bool = True,
    device=None,
):
    """Load the newest recoverable generation of lineage ``name``.

    Follows the ``.lastgood`` marker first; if that archive is missing or
    unreadable (partial disk loss), falls back to older on-disk
    generations in descending order — never to one *newer* than the
    marker, which may be a torn write-in-progress. Returns
    ``(session, gen)`` or ``None`` when nothing is recoverable.
    """
    marked = last_good_generation(cache_dir, name)
    candidates = [g for g in reversed(_list_generations(cache_dir, name))
                  if marked is None or g <= marked]
    if marked is not None and marked not in candidates:
        pass  # marker's archive vanished; older gens below still count
    for gen in candidates:
        path = _gen_archive(cache_dir, name, gen)
        try:
            sess = load_session(path, executor=executor, lazy=lazy, device=device)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            continue
        return sess, gen
    return None


def journal_delta(cache_dir: str, name: str, gen: int, delta: SparseDelta) -> str:
    """Append ``delta`` to generation ``gen``'s journal (atomic write).

    Journal entries are numbered ``.gen{gen}.delta{seq}.npz`` in apply
    order; :func:`replay_journal` folds them back over the loaded
    checkpoint. Returns the path written.
    """
    os.makedirs(cache_dir, exist_ok=True)
    stem = _lineage_stem(name)
    pat = re.compile(rf"^{re.escape(stem)}\.gen{gen:06d}\.delta(\d+)\.npz$")
    seqs = [int(m.group(1)) for m in map(pat.match, os.listdir(cache_dir)) if m]
    seq = (max(seqs) + 1) if seqs else 0
    final = os.path.join(cache_dir, f"{stem}.gen{gen:06d}.delta{seq:06d}.npz")
    meta = {"shape": list(delta.shape), "gen": int(gen), "seq": int(seq)}
    tmp = f"{final}.tmp-{os.getpid()}-{next(_TMP_COUNTER)}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                up_row=delta.up_row, up_col=delta.up_col, up_val=delta.up_val,
                del_row=delta.del_row, del_col=delta.del_col,
                **{"meta.json": np.array(json.dumps(meta))},
            )
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return final


def load_journal(cache_dir: str, name: str, gen: int) -> List[SparseDelta]:
    """Generation ``gen``'s journaled deltas, in apply (seq) order."""
    stem = _lineage_stem(name)
    pat = re.compile(rf"^{re.escape(stem)}\.gen{gen:06d}\.delta(\d+)\.npz$")
    try:
        listing = os.listdir(cache_dir)
    except OSError:
        return []
    found = sorted(
        (int(m.group(1)), fname)
        for m, fname in ((pat.match(f), f) for f in listing) if m
    )
    out = []
    for _, fname in found:
        with np.load(os.path.join(cache_dir, fname)) as z:
            meta = json.loads(str(z["meta.json"]))
            out.append(SparseDelta(
                shape=tuple(meta["shape"]),
                up_row=z["up_row"], up_col=z["up_col"], up_val=z["up_val"],
                del_row=z["del_row"], del_col=z["del_col"],
            ))
    return out


def replay_journal(
    sess: "SparseSession", cache_dir: str, name: str, gen: int, *, count=None
):
    """Fold generation ``gen``'s journal over ``sess`` via ``update()``.

    Updates are deterministic, so the result is bitwise-identical to the
    live session that produced the journal. ``count`` replays only the
    first ``count`` deltas (all when ``None``): the session the live
    chain was at after that many updates. Returns the final session
    (``sess`` itself when nothing is replayed).
    """
    for delta in load_journal(cache_dir, name, gen)[:count]:
        sess = sess.update(delta)
    return sess


def cached_distribute(
    a: COO,
    *,
    topology: Topology,
    combo: str,
    exchange: str,
    executor: str,
    block: Tuple[int, int],
    seed: int,
    cache_dir: str,
    cache_budget_bytes: Optional[int] = None,
    partitioner_kw: Optional[dict] = None,
    device=None,
) -> "SparseSession":
    """``distribute`` with the two cache layers in front of planning.

    Lookup order: in-process memo (same key planned/loaded before in
    this process), then ``<cache_dir>/plan-<key>.npz`` (cross-process
    warm start, loaded lazily — tile payloads materialize at first use),
    then a real planning run. The ``cache_dir`` file is (re)written
    whenever it is missing — including on a memo hit whose key was first
    planned against a *different* cache_dir, or after an external
    eviction — so sibling processes pointed at this directory always
    find the plan. An unreadable/corrupt cache file (e.g. a torn write
    from a crashed process) is treated as a miss and overwritten, not an
    error. Memo hits return a re-wrap via
    :meth:`SparseSession.with_executor`, sharing plan objects and the
    executor-closure cache. With ``cache_budget_bytes`` set, the
    directory is LRU-pruned (:func:`gc`) after each write, the current
    key's file always kept; hits never pay the directory scan.

    ``device`` is where the session computes (the card when omitted).
    The file name is device-free, but the memo key is not: a session
    hydrated for one device is never handed to a caller on another.
    """
    from repro_torch.api.session import distribute

    dev = resolve_device(device)
    key = plan_key(a, topology, combo, block, exchange, seed, partitioner_kw)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"plan-{key}.npz")
    memo_key = f"{key}|{dev}"
    rewrite = not os.path.exists(path)
    sess = _MEMO.get(memo_key)
    if sess is not None:
        _MEMO.move_to_end(memo_key)  # LRU touch
        if not rewrite:
            _touch(path)  # keep the file's LRU recency in step with the memo's
    else:
        if not rewrite:
            try:
                sess = load_session(path, executor=executor, device=dev)
                _touch(path)
            except Exception:
                # Corrupt / stale-format file: re-plan below and replace
                # it, so later processes don't re-pay this miss.
                sess = None
                rewrite = True
        if sess is None:
            sess = distribute(
                a,
                topology=topology,
                combo=combo,
                exchange=exchange,
                executor=executor,
                block=block,
                seed=seed,
                device=dev,
                **(partitioner_kw or {}),
            )
        _memo_put(memo_key, sess)
    if rewrite:
        save_session(sess, path)
        # Prune only when we added bytes — memo/disk hits must stay a
        # lookup, not a directory scan.
        if cache_budget_bytes is not None:
            gc(cache_dir, cache_budget_bytes, keep=(path,))
    return sess if sess.executor == executor else sess.with_executor(executor)


def hydrate_session(
    path: str,
    *,
    executor: Optional[str] = None,
    lazy: bool = True,
    device=None,
) -> "SparseSession":
    """:func:`load_session` fronted by the in-process memo — the serving
    engine's warm-pool hook.

    The memo key is ``"file:" + abspath + "|" + device`` (a *file*
    identity on one device, distinct from the plan-key namespace of
    :func:`cached_distribute`), so
    repeated hydrations of one saved plan — every request for a
    registered graph — share a single canonical session: tile payloads
    materialize once, executor closures are reused via the
    :meth:`SparseSession.with_executor` re-wrap contract, and
    :func:`set_memo_limit` bounds how many graphs stay warm (a cold
    graph is evicted LRU and transparently re-hydrated from disk on its
    next request)."""
    dev = resolve_device(device)
    key = f"file:{os.path.abspath(path)}|{dev}"
    sess = _MEMO.get(key)
    if sess is None:
        sess = load_session(path, executor=executor, lazy=lazy, device=dev)
        _memo_put(key, sess)
    else:
        _MEMO.move_to_end(key)
    if executor is not None and sess.executor != executor:
        return sess.with_executor(executor)
    return sess
