"""Plan-store hardening in the port, on the CPU: crash/corruption
recovery and cache GC bounds.

The case-for-case port of ``tests/test_plancache_gc.py`` against
:mod:`repro_torch.api.plancache`: every failure mode must degrade to
*cache miss and replan* — never a crash on the warm-start path and never
wrong results — and the disk/memo budgets must actually bound what a
serving fleet accumulates (DESIGN.md §11). The memo keys the port uses
carry the device (``<plan key>|cpu``, ``file:<path>|cpu``), so a session
hydrated for one device is never handed to another; the asserts on memo
keys name them so.
"""
import os
import sys
import threading
import zipfile

import numpy as np
import pytest

import repro_torch.api.plancache as plancache
from repro_torch.api import SparseSession, Topology, distribute
from repro_torch.sparse.generate import random_coo

TOPO = Topology(2, 2)
CPU = "cpu"


@pytest.fixture()
def problem():
    a = random_coo(220, 2600, seed=21)
    x = np.random.default_rng(2).standard_normal(a.shape[1]).astype(np.float32)
    return a, x


@pytest.fixture(autouse=True)
def _fresh_memo():
    plancache.clear_memo()
    yield
    plancache.clear_memo()
    plancache.set_memo_limit(max_sessions=8, max_bytes=None)


def _plan_file(cache):
    names = [n for n in os.listdir(cache)
             if n.startswith("plan-") and n.endswith(".npz") and ".tmp-" not in n]
    assert len(names) == 1, names
    return os.path.join(cache, names[0])


# ---------------------------------------------------------------------------
# Corruption / crash recovery


def _assert_recovers(a, x, cache, y_ref):
    """After whatever damage the test did, a warm start must replan (not
    crash), produce bitwise-identical results, and leave a loadable file."""
    plancache.clear_memo()
    sess = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    assert np.array_equal(y_ref, np.asarray(sess.spmv(x)))
    loaded = SparseSession.load(_plan_file(cache), lazy=False, device=CPU)
    assert np.array_equal(y_ref, np.asarray(loaded.spmv(x)))


def test_truncated_archive_is_a_miss(problem, tmp_path):
    a, x = problem
    cache = str(tmp_path / "plans")
    s1 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    y_ref = np.asarray(s1.spmv(x))
    path = _plan_file(cache)
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(blob[: len(blob) // 2])  # kill -9 mid-write equivalent
    with pytest.raises(ValueError):
        SparseSession.load(path, device=CPU)
    _assert_recovers(a, x, cache, y_ref)


def test_inplace_payload_corruption_fails_loudly(problem, tmp_path):
    """Bit rot *inside* a member of a structurally valid archive (central
    directory and meta intact) cannot be caught at load time without
    reading everything — but it must surface as a loud integrity error
    at materialization, never as silently wrong numerics, on both the
    mmap fast path and the buffered fallback."""
    a, x = problem
    sess = distribute(a, topology=TOPO, combo="NL-HL", device=CPU)
    y_ref = np.asarray(sess.spmv(x))
    path = str(tmp_path / "plan.npz")
    sess.save(path)
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("dp.tiles.npy")
    with open(path, "r+b") as fh:  # flip bytes mid-payload, sizes intact
        fh.seek(info.header_offset + 256)
        fh.write(b"\xff" * 64)
    loaded = SparseSession.load(path, device=CPU)  # meta + inventory still parse
    with pytest.raises((ValueError, zipfile.BadZipFile), match="CRC"):
        loaded.spmv(x)
    # Deleting the poisoned file recovers: replan, bitwise-identical.
    cache = str(tmp_path / "plans")
    os.makedirs(cache)
    plancache.clear_memo()
    fresh = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    assert np.array_equal(y_ref, np.asarray(fresh.spmv(x)))


def test_meta_array_mismatch_is_a_miss(problem, tmp_path):
    """A structurally valid zip whose members don't match its meta entry
    (here: a payload member dropped) must be rejected at load time — the
    lazy loader validates the member inventory before handing out a
    session whose thunks would explode later."""
    a, x = problem
    cache = str(tmp_path / "plans")
    s1 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    y_ref = np.asarray(s1.spmv(x))
    path = _plan_file(cache)
    mangled = path + ".mangled"
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(mangled, "w") as zout:
        for info in zin.infolist():
            if info.filename != "dp.tiles.npy":
                zout.writestr(info, zin.read(info.filename))
    os.replace(mangled, path)
    with pytest.raises(ValueError, match="missing arrays"):
        SparseSession.load(path, device=CPU)
    _assert_recovers(a, x, cache, y_ref)


def test_partial_write_leaves_no_visible_file(problem, tmp_path):
    """A writer killed between write and rename leaves only a temp file:
    warm starts must ignore it (miss → replan), and gc() sweeps it once
    stale."""
    a, x = problem
    cache = str(tmp_path / "plans")
    os.makedirs(cache)
    key = plancache.plan_key(a, TOPO, "NL-HL", (16, 16), "selective", 0)
    stray = os.path.join(cache, f"plan-{key}.npz.tmp-9999-0")
    with open(stray, "wb") as fh:
        fh.write(b"PK\x03\x04 torn half-archive")
    sess = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    y_ref = np.asarray(sess.spmv(x))
    assert os.path.exists(_plan_file(cache))  # planned + wrote the real file
    _assert_recovers(a, x, cache, y_ref)
    # The stray temp is invisible to loads and aged out by gc.
    assert os.path.exists(stray)
    os.utime(stray, times=(1, 1))  # stale since 1970
    stats = plancache.gc(cache, budget_bytes=1 << 40)
    assert stats["tmp_removed"] == 1 and not os.path.exists(stray)
    assert stats["files_removed"] == 0  # within budget: no plan pruned


def test_concurrent_writers_and_readers_one_cache_dir(problem, tmp_path):
    """Hammer one cache path with racing save_session writers and
    lazy-loading readers: every read must see a complete archive and
    bitwise-correct results (atomic temp+rename, unique temp names even
    within one process)."""
    a, x = problem
    sess = distribute(a, topology=TOPO, combo="NL-HL", device=CPU)
    y_ref = np.asarray(sess.spmv(x, executor="reference"))
    path = str(tmp_path / "plan.npz")
    sess.save(path)
    errors = []
    stop = threading.Event()

    def writer():
        try:
            while not stop.is_set():
                sess.save(path)
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    def reader():
        try:
            for _ in range(12):
                loaded = SparseSession.load(path, lazy=False, device=CPU)
                y = np.asarray(loaded.spmv(x, executor="reference"))
                assert np.array_equal(y, y_ref)
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(2)] + [
        threading.Thread(target=reader) for _ in range(3)
    ]
    for t in threads[2:]:
        t.start()
    for t in threads[:2]:
        t.start()
    for t in threads[2:]:
        t.join()
    stop.set()
    for t in threads[:2]:
        t.join()
    assert not errors, errors
    assert sorted(os.listdir(tmp_path)) == ["plan.npz"]  # no temp debris


# ---------------------------------------------------------------------------
# Disk GC


def _fill_cache(a, cache, seeds):
    paths = {}
    for seed in seeds:
        distribute(a, topology=TOPO, combo="NL-HL", seed=seed, cache_dir=cache, device=CPU)
        newest = max(
            (os.path.join(cache, n) for n in os.listdir(cache)),
            key=os.path.getmtime,
        )
        paths[seed] = newest
    return paths


def test_gc_respects_budget_and_evicts_lru_first(problem, tmp_path):
    a, _ = problem
    cache = str(tmp_path / "plans")
    paths = _fill_cache(a, cache, seeds=(0, 1, 2, 3))
    sizes = {s: os.path.getsize(p) for s, p in paths.items()}
    # Explicit access order: 1 is hottest, 0 second, then 3, then 2.
    for rank, seed in enumerate((2, 3, 0, 1)):
        os.utime(paths[seed], times=(1_000_000 + rank, 1_000_000))
    budget = sizes[0] + sizes[1] + 1
    stats = plancache.gc(cache, budget)
    survivors = {s for s, p in paths.items() if os.path.exists(p)}
    assert survivors == {0, 1}  # least-recently-used (2, then 3) went first
    assert stats["files_removed"] == 2
    assert stats["bytes_in_use"] <= budget
    assert stats["bytes_freed"] == sizes[2] + sizes[3]


def test_gc_keep_overrides_budget(problem, tmp_path):
    a, _ = problem
    cache = str(tmp_path / "plans")
    paths = _fill_cache(a, cache, seeds=(0, 1))
    stats = plancache.gc(cache, budget_bytes=0, keep=(paths[1],))
    assert not os.path.exists(paths[0]) and os.path.exists(paths[1])
    assert stats["files_removed"] == 1


def test_distribute_budget_prunes_as_it_writes(problem, tmp_path):
    """cache_budget_bytes on distribute(): the directory never exceeds
    budget + the just-written plan, and the hot key survives its own
    write (eviction stress: 6 keys through a ~2-file budget)."""
    a, x = problem
    cache = str(tmp_path / "plans")
    distribute(a, topology=TOPO, combo="NL-HL", seed=0, cache_dir=cache, device=CPU)
    per_file = os.path.getsize(_plan_file(cache))
    budget = int(2.5 * per_file)
    for seed in range(1, 6):
        distribute(a, topology=TOPO, combo="NL-HL", seed=seed, cache_dir=cache,
                   cache_budget_bytes=budget, device=CPU)
        files = [os.path.join(cache, n) for n in os.listdir(cache)
                 if n.startswith("plan-")]
        assert sum(os.path.getsize(p) for p in files) <= budget
    # The newest key's file is always present, and still loads.
    plancache.clear_memo()
    warm = distribute(a, topology=TOPO, combo="NL-HL", seed=5, cache_dir=cache,
                      cache_budget_bytes=budget, device=CPU)
    y = np.asarray(warm.spmv(x))
    assert np.isfinite(y).all()
    # An evicted key replans and re-enters the cache without error.
    plancache.clear_memo()
    distribute(a, topology=TOPO, combo="NL-HL", seed=1, cache_dir=cache,
               cache_budget_bytes=budget, device=CPU)


def test_gc_on_missing_dir_is_noop(tmp_path):
    stats = plancache.gc(str(tmp_path / "nope"), 0)
    assert stats == {"files_removed": 0, "bytes_freed": 0, "bytes_in_use": 0,
                     "tmp_removed": 0, "files_pinned": 0}


def test_gc_ignores_foreign_files(problem, tmp_path):
    a, _ = problem
    cache = str(tmp_path / "plans")
    _fill_cache(a, cache, seeds=(0,))
    foreign = os.path.join(cache, "notes.txt")
    with open(foreign, "w") as fh:
        fh.write("not a plan")
    plancache.gc(cache, budget_bytes=0, keep=(_plan_file(cache),))
    assert os.path.exists(foreign)


# ---------------------------------------------------------------------------
# In-process memo bounds


def _key(a, seed):
    return plancache.plan_key(a, TOPO, "NL-HL", (16, 16), "selective", seed) + "|cpu"


def test_memo_count_bound_evicts_oldest_first(problem, tmp_path, monkeypatch):
    a, _ = problem
    cache = str(tmp_path / "plans")
    monkeypatch.setattr(plancache, "_MEMO_MAX", 2)
    for seed in (0, 1, 2):
        distribute(a, topology=TOPO, combo="NL-HL", seed=seed, cache_dir=cache, device=CPU)
    assert list(plancache._MEMO) == [_key(a, 1), _key(a, 2)]
    # A hit refreshes recency: 1 becomes newest, so 2 is evicted next.
    distribute(a, topology=TOPO, combo="NL-HL", seed=1, cache_dir=cache, device=CPU)
    distribute(a, topology=TOPO, combo="NL-HL", seed=3, cache_dir=cache, device=CPU)
    assert list(plancache._MEMO) == [_key(a, 1), _key(a, 3)]


def test_memo_byte_budget(problem, tmp_path):
    a, x = problem
    cache = str(tmp_path / "plans")
    distribute(a, topology=TOPO, combo="NL-HL", seed=0, cache_dir=cache, device=CPU)
    per_session = plancache._MEMO_NBYTES[_key(a, 0)]
    assert per_session > 0
    # Budget for ~1.5 sessions: every insert evicts back down to one.
    plancache.set_memo_limit(max_bytes=int(1.5 * per_session))
    for seed in (1, 2, 3):
        distribute(a, topology=TOPO, combo="NL-HL", seed=seed, cache_dir=cache, device=CPU)
        assert list(plancache._MEMO) == [_key(a, seed)]
    # The newest session always survives, even if it alone exceeds the
    # budget (a serving process must keep its working plan).
    plancache.set_memo_limit(max_bytes=1)
    distribute(a, topology=TOPO, combo="NL-HL", seed=4, cache_dir=cache, device=CPU)
    assert list(plancache._MEMO) == [_key(a, 4)]
    # Evicted keys still warm-start from disk, bitwise.
    plancache.set_memo_limit(max_bytes=None)
    s1 = distribute(a, topology=TOPO, combo="NL-HL", seed=1, cache_dir=cache, device=CPU)
    plancache.clear_memo()
    s2 = distribute(a, topology=TOPO, combo="NL-HL", seed=1, cache_dir=cache, device=CPU)
    assert np.array_equal(np.asarray(s1.spmv(x)), np.asarray(s2.spmv(x)))


def test_set_memo_limit_reports_and_applies_now(problem, tmp_path):
    a, _ = problem
    cache = str(tmp_path / "plans")
    for seed in (0, 1, 2):
        distribute(a, topology=TOPO, combo="NL-HL", seed=seed, cache_dir=cache, device=CPU)
    assert len(plancache._MEMO) == 3
    limits = plancache.set_memo_limit(max_sessions=1)
    assert limits["max_sessions"] == 1
    assert list(plancache._MEMO) == [_key(a, 2)]


# ---------------------------------------------------------------------------
# GC vs lazy loads: the race of gc pruning an archive a live lazy
# session still needs is closed by pinning


def test_gc_never_collects_live_lazy_archive(problem, tmp_path):
    a, x = problem
    cache = str(tmp_path / "plans")
    s1 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    y_ref = np.asarray(s1.spmv(x))
    path = _plan_file(cache)
    plancache.clear_memo()
    lazy = plancache.load_session(path, lazy=True, device=CPU)
    stats = plancache.gc(cache, budget_bytes=0)
    assert stats["files_pinned"] == 1 and stats["files_removed"] == 0
    assert os.path.exists(path)
    # First touch materializes from the still-present archive, bitwise.
    assert np.array_equal(y_ref, np.asarray(lazy.spmv(x)))
    # spmv only forces the execution arrays; the matrix/partition thunks
    # still point at the file, so the pin must hold until full
    # materialization.
    stats = plancache.gc(cache, budget_bytes=0)
    assert stats["files_pinned"] == 1
    lazy.materialize()
    stats = plancache.gc(cache, budget_bytes=0)
    assert stats["files_removed"] == 1 and stats["files_pinned"] == 0


def test_gc_pin_released_when_lazy_session_dies(problem, tmp_path):
    import gc as pygc

    a, _ = problem
    cache = str(tmp_path / "plans")
    distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    path = _plan_file(cache)
    plancache.clear_memo()
    lazy = plancache.load_session(path, lazy=True, device=CPU)
    del lazy
    pygc.collect()
    stats = plancache.gc(cache, budget_bytes=0)
    assert stats["files_removed"] == 1 and stats["files_pinned"] == 0


def test_writer_gc_reader_race(problem, tmp_path):
    """Concurrent writer + GC hammering + lazy readers. The contract: a
    load may miss cleanly (ValueError / missing file — the caller
    replans, same as any cache miss), but a session that *was* returned
    must always materialize to the right bits — gc can never break it
    after the fact."""
    a, x = problem
    cache = str(tmp_path / "plans")
    sess = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    y_ref = np.asarray(sess.spmv(x))
    path = _plan_file(cache)
    stop = threading.Event()
    errors = []

    def hammer():
        while not stop.is_set():
            try:
                plancache.gc(cache, budget_bytes=0)
                plancache.save_session(sess, path)
            except Exception as err:  # pragma: no cover - failure path
                errors.append(err)
                return

    t = threading.Thread(target=hammer)
    t.start()
    loaded = 0
    try:
        while loaded < 12 and not errors:
            plancache.clear_memo()
            try:
                lazy = plancache.load_session(path, lazy=True, device=CPU)
            except (ValueError, OSError):
                continue  # clean load-time miss; caller would replan
            loaded += 1
            assert np.array_equal(y_ref, np.asarray(lazy.materialize().spmv(x)))
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert loaded == 12


def test_gc_reads_lazy_pins_while_loads_register(problem, tmp_path):
    """gc() reads the lazy-pin registry while loads on other threads add
    to it; with the interpreter switching threads every microsecond, a
    read outside the store lock raises "Set changed size during
    iteration" within a few hundred loads."""
    a, _ = problem
    cache = str(tmp_path / "plans")
    distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    path = _plan_file(cache)
    stop = threading.Event()
    errors = []

    def collect():
        while not stop.is_set():
            try:
                plancache.gc(cache, budget_bytes=1 << 40)
            except Exception as err:  # pragma: no cover - failure path
                errors.append(err)
                return

    held = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=collect)
    t.start()
    try:
        for _ in range(2000):
            held.append(plancache.load_session(path, lazy=True, device=CPU))
            if errors:
                break
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    assert not errors, errors
    assert len(held) == 2000


def test_gc_pins_last_good_generation_and_journal(problem, tmp_path):
    from repro_torch.sparse.delta import SparseDelta

    a, _ = problem
    cache = str(tmp_path / "gens")
    sess = distribute(a, topology=TOPO, combo="NL-HL", device=CPU)
    plancache.save_generation(sess, cache, "g")
    _, gen1 = plancache.save_generation(sess, cache, "g")
    delta = SparseDelta.upserts(
        a.shape, a.row[:1], a.col[:1], np.array([0.5], np.float32))
    plancache.journal_delta(cache, "g", gen1, delta)
    stats = plancache.gc(cache, budget_bytes=0)
    # gen0 superseded and collected; gen1 + its journal survive any budget
    assert plancache.last_good_generation(cache, "g") == gen1
    assert stats["files_removed"] == 1 and stats["files_pinned"] == 2
    got = plancache.load_last_good(cache, "g", device=CPU)
    assert got is not None and got[1] == gen1
    assert len(plancache.load_journal(cache, "g", gen1)) == 1


# ---------------------------------------------------------------------------
# Memo accounting: resident bytes, not logical nbytes


def test_session_nbytes_is_resident_not_logical(problem, tmp_path):
    a, _ = problem
    path = str(tmp_path / "plan.npz")
    sess = distribute(a, topology=TOPO, combo="NL-HL", device=CPU)
    sess.save(path)
    lazy = plancache.load_session(path, lazy=True, device=CPU)
    assert plancache._session_nbytes(lazy) == 0  # nothing resident yet
    lazy.materialize()
    full = plancache._session_nbytes(lazy)
    assert full > 0
    assert plancache._session_nbytes(sess) == full


def test_memo_byte_budget_counts_resident_bytes(problem, tmp_path):
    """Lazy hydrated sessions are near-free until materialized: a byte
    budget that could never hold them materialized holds many lazy, and
    eviction kicks in (oldest first) only once bytes become resident."""
    a, _ = problem
    paths = []
    for i in range(3):
        sess = distribute(a, topology=TOPO, combo="NL-HL", seed=i, device=CPU)
        p = str(tmp_path / f"p{i}.npz")
        sess.save(p)
        paths.append(p)
    plancache.clear_memo()
    plancache.set_memo_limit(max_sessions=None, max_bytes=4096)
    hydrated = [plancache.hydrate_session(p, device=CPU) for p in paths]
    assert len(plancache._MEMO) == 3  # all resident-cheap, none evicted
    hydrated[0].materialize()  # now key 0 actually occupies memory
    sess3 = distribute(a, topology=TOPO, combo="NL-HL", seed=3, device=CPU)
    p3 = str(tmp_path / "p3.npz")
    sess3.save(p3)
    plancache.hydrate_session(p3, device=CPU)
    keys = list(plancache._MEMO)
    assert f"file:{os.path.abspath(paths[0])}|cpu" not in keys  # oldest+heavy out
    assert f"file:{os.path.abspath(p3)}|cpu" in keys
