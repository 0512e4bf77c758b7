"""The plan store of :mod:`repro_torch.api.plancache`, on the CPU.

First the case-for-case port of ``tests/test_plancache.py`` and
``tests/test_plancache_prop.py`` inside the port: a loaded session is
*bitwise* equivalent to the saved one — every planning array round-trips
exactly through the ``.npz``, so ``spmv`` returns bit-identical results
on every executor, single and batched, lazy and eager, v1 and v2 — and
the cache key separates any two planning runs that could differ. (The
reference's ``shard_map`` warm-start subprocess case has its
counterpart in ``tests/test_torch_shard_exec.py``, which loads archives
naming ``shard_map`` in gloo process groups.)

Then the cases across packages: the same numpy COO planned by the JAX
package and by the port gives the same :func:`plan_key`, archives whose
members and ``meta.json`` are equal member for member, and archives that
load in the other package, where the loaded session's ``spmv`` is
bitwise the loading package's own session's. An archive whose meta
names the JAX package's ``shard_map`` executor keeps that name in the
port; outside a ``torch.distributed`` process group its first ``spmv``
raises, unless the load overrides the executor
(``tests/test_torch_shard_exec.py`` runs such an archive in a group).
"""
import hashlib
import os
import tempfile

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.api as jx
import repro.api.plancache as jx_plancache
import repro_torch.api.plancache as plancache
from repro.sparse.formats import COO as JxCOO
from repro_torch.api import SparseSession, Topology, distribute, hydrate_session
from repro_torch.api.plancache import plan_key
from repro_torch.sparse.generate import banded_coo, powerlaw_coo, random_coo
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

TOPO = Topology(2, 2)
CPU = "cpu"


@pytest.fixture()
def problem():
    a = random_coo(300, 4000, seed=13)
    x = np.random.default_rng(3).standard_normal(a.shape[1]).astype(np.float32)
    xs = np.random.default_rng(4).standard_normal((4, a.shape[1])).astype(np.float32)
    return a, x, xs


@pytest.fixture(autouse=True)
def _fresh_memo():
    plancache.clear_memo()
    jx_plancache.clear_memo()
    yield
    plancache.clear_memo()
    jx_plancache.clear_memo()


@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap"])
def test_save_load_round_trip_bitwise(problem, exchange, tmp_path):
    a, x, xs = problem
    sess = distribute(a, topology=TOPO, combo="NL-HC", exchange=exchange, device=CPU)
    path = str(tmp_path / "plan.npz")
    assert sess.save(path) == path
    loaded = SparseSession.load(path, device=CPU)
    assert loaded.combo == sess.combo
    assert loaded.exchange == exchange
    assert loaded.topology == sess.topology
    assert loaded.device == sess.device
    np.testing.assert_array_equal(loaded.device_plan.tiles, sess.device_plan.tiles)
    np.testing.assert_array_equal(loaded.partition.elem_unit, sess.partition.elem_unit)
    for ex in ("simulate", "reference"):
        for xin in (x, xs):
            assert np.array_equal(sess.spmv(xin, executor=ex),
                                  loaded.spmv(xin, executor=ex)), (exchange, ex)


def test_load_preserves_metrics_and_costs(problem, tmp_path):
    a, _, _ = problem
    sess = distribute(a, topology=TOPO, combo="NC-HL", exchange="selective", device=CPU)
    path = str(tmp_path / "plan.npz")
    sess.save(path)
    loaded = SparseSession.load(path, device=CPU)
    assert loaded.costs() == sess.costs()
    assert loaded.partition.inter_fd == sess.partition.inter_fd
    assert loaded.partition.hyper_cut == sess.partition.hyper_cut
    ref = SparseSession.load(path, executor="reference", device=CPU)
    assert ref.executor == "reference"


def test_cache_dir_layers(problem, tmp_path):
    a, x, _ = problem
    cache = str(tmp_path / "plans")
    s1 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    files = os.listdir(cache)
    assert len(files) == 1 and files[0].startswith("plan-")
    # Second call: in-process memo — same plan objects, shared closures.
    s2 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    assert s2.device_plan is s1.device_plan
    assert s2._spmv_cache is s1._spmv_cache
    assert os.listdir(cache) == files
    # A fresh process: memo cleared — loads the npz, bitwise.
    plancache.clear_memo()
    s3 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    assert s3.device_plan is not s1.device_plan
    assert np.array_equal(s1.spmv(x), s3.spmv(x))
    s4 = distribute(a, topology=TOPO, combo="NL-HL", executor="reference",
                    cache_dir=cache, device=CPU)
    assert s4.executor == "reference"
    assert s4.device_plan is s3.device_plan


def test_plan_key_separates_planning_inputs(problem):
    a, _, _ = problem
    base = plan_key(a, TOPO, "NL-HL", (16, 16), "selective", 0)
    assert base == plan_key(a, TOPO, "NL-HL", (16, 16), "selective", 0)
    assert base == plan_key(a, TOPO, "NL-HL", 16, "selective", 0)
    others = [
        plan_key(a, TOPO, "NL-HC", (16, 16), "selective", 0),
        plan_key(a, TOPO, "NL-HL", (8, 8), "selective", 0),
        plan_key(a, TOPO, "NL-HL", (16, 16), "overlap", 0),
        plan_key(a, TOPO, "NL-HL", (16, 16), "selective", 1),
        plan_key(a, Topology(4, 1), "NL-HL", (16, 16), "selective", 0),
        plan_key(a, TOPO, "nezgt", (16, 16), "selective", 0, {"dim": "cols"}),
    ]
    assert len({base, *others}) == len(others) + 1
    b = random_coo(300, 4000, seed=13)
    bumped = type(a)(a.shape, a.row, a.col, a.val + 1.0)
    assert plan_key(bumped, TOPO, "NL-HL", (16, 16), "selective", 0) != base
    assert plan_key(b, TOPO, "NL-HL", (16, 16), "selective", 0) == base


def test_memo_hit_still_populates_new_cache_dir(problem, tmp_path):
    a, _, _ = problem
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    distribute(a, topology=TOPO, combo="NL-HL", cache_dir=dir_a, device=CPU)
    distribute(a, topology=TOPO, combo="NL-HL", cache_dir=dir_b, device=CPU)  # memo hit
    assert os.listdir(dir_a) == os.listdir(dir_b) != []
    victim = os.path.join(dir_a, os.listdir(dir_a)[0])
    os.remove(victim)
    distribute(a, topology=TOPO, combo="NL-HL", cache_dir=dir_a, device=CPU)
    assert os.path.exists(victim)


def test_corrupt_cache_file_treated_as_miss(problem, tmp_path):
    a, x, _ = problem
    cache = str(tmp_path / "plans")
    s1 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    path = os.path.join(cache, os.listdir(cache)[0])
    with open(path, "wb") as fh:
        fh.write(b"not a zip archive")
    plancache.clear_memo()
    s2 = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    assert np.array_equal(s1.spmv(x), s2.spmv(x))
    s3 = SparseSession.load(path, device=CPU)
    assert np.array_equal(s1.spmv(x), s3.spmv(x))


def test_memo_is_lru_bounded(problem, tmp_path, monkeypatch):
    a, x, _ = problem
    cache = str(tmp_path / "plans")
    monkeypatch.setattr(plancache, "_MEMO_MAX", 2)
    for seed in (0, 1, 2):
        distribute(a, topology=TOPO, combo="NL-HL", seed=seed, cache_dir=cache, device=CPU)
    assert len(plancache._MEMO) == 2
    s0 = distribute(a, topology=TOPO, combo="NL-HL", seed=0, cache_dir=cache, device=CPU)
    assert np.isfinite(s0.spmv(x)).all()
    plancache.clear_memo()
    assert len(plancache._MEMO) == 0


def test_memo_key_includes_the_device(problem, tmp_path):
    """The archive's name is device-free, the memo's key is not: a session
    hydrated for one device is never handed to a caller on another."""
    a, _, _ = problem
    cache = str(tmp_path / "plans")
    s_cpu = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device=CPU)
    s_meta = distribute(a, topology=TOPO, combo="NL-HL", cache_dir=cache, device="meta")
    assert len(os.listdir(cache)) == 1  # one archive for both
    assert s_meta.device.type == "meta" and s_cpu.device.type == "cpu"
    assert s_meta._spmv_cache is not s_cpu._spmv_cache
    key = plan_key(a, TOPO, "NL-HL", (16, 16), "selective", 0)
    assert set(plancache._MEMO) == {f"{key}|cpu", f"{key}|meta"}
    path = os.path.join(cache, os.listdir(cache)[0])
    h_cpu = hydrate_session(path, device=CPU)
    h_meta = hydrate_session(path, device="meta")
    assert h_cpu is hydrate_session(path, device=CPU)
    assert h_cpu is not h_meta and h_meta.device.type == "meta"
    assert f"file:{os.path.abspath(path)}|cpu" in plancache._MEMO


def test_save_leaves_no_temp_files(problem, tmp_path):
    a, _, _ = problem
    sess = distribute(a, topology=TOPO, combo="NL-HL", device=CPU)
    sess.save(str(tmp_path / "plan.npz"))
    assert sorted(os.listdir(tmp_path)) == ["plan.npz"]


def test_unknown_future_version_rejected(problem, tmp_path, monkeypatch):
    a, _, _ = problem
    sess = distribute(a, topology=TOPO, combo="NL-HL", device=CPU)
    path = str(tmp_path / "plan.npz")
    future = plancache.FORMAT_VERSION + 1
    monkeypatch.setattr(plancache, "FORMAT_VERSION", future)
    monkeypatch.setattr(plancache, "READABLE_VERSIONS", (1, 2, future))
    sess.save(path)
    monkeypatch.undo()
    with pytest.raises(ValueError, match=f"format v{future}"):
        SparseSession.load(path, device=CPU)


def test_v1_archive_reads_transparently(problem, tmp_path):
    a, x, xs = problem
    sess = distribute(a, topology=TOPO, combo="NL-HC", exchange="overlap", device=CPU)
    v1 = str(tmp_path / "v1.npz")
    v2 = str(tmp_path / "v2.npz")
    sess.save(v1, format_version=1)
    sess.save(v2)
    assert os.path.getsize(v2) < os.path.getsize(v1)
    for path in (v1, v2):
        loaded = SparseSession.load(path, device=CPU)
        np.testing.assert_array_equal(loaded.device_plan.tiles, sess.device_plan.tiles)
        np.testing.assert_array_equal(
            loaded.selective.selective.tile_col_local,
            sess.selective.selective.tile_col_local,
        )
        for ex in ("simulate", "reference"):
            for xin in (x, xs):
                assert np.array_equal(sess.spmv(xin, executor=ex),
                                      loaded.spmv(xin, executor=ex))


def test_lazy_load_defers_payload(problem, tmp_path):
    a, x, _ = problem
    sess = distribute(a, topology=TOPO, combo="NL-HL", device=CPU)
    path = str(tmp_path / "plan.npz")
    sess.save(path)
    loaded = SparseSession.load(path, device=CPU)
    assert not loaded.is_materialized
    assert "unmaterialized" in repr(loaded) and "<lazy>" in repr(loaded)
    sibling = loaded.with_executor("reference")
    assert not loaded.is_materialized  # re-wrap must not force the thunks
    y = sibling.spmv(x)  # CSR oracle: reads the matrix only...
    assert callable(sibling._device_plan)  # ...tiles stay on disk
    assert np.array_equal(y, sess.spmv(x, executor="reference"))
    y2 = loaded.spmv(x)  # simulate: now the tiles materialize
    assert not callable(loaded._device_plan)
    assert loaded.device_plan is sibling.device_plan  # once, shared
    assert np.array_equal(y2, sess.spmv(x))
    assert SparseSession.load(path, lazy=False, device=CPU).is_materialized


@pytest.mark.parametrize("fmt", [1, 2])
def test_lazy_cpu_load_never_writes_the_archive(problem, tmp_path, fmt):
    """On the CPU the hoisted tiles of a v1 archive alias its read-only
    memory map: spmv and value views read it, nothing writes it."""
    a, x, xs = problem
    sess = distribute(a, topology=TOPO, combo="NL-HC", exchange="selective", device=CPU)
    path = sess.save(str(tmp_path / "plan.npz"), format_version=fmt)
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    loaded = SparseSession.load(path, device=CPU)
    assert np.array_equal(loaded.spmv(xs), sess.spmv(xs))
    if fmt == 1:  # the padded payload is served straight from the map
        assert not loaded.device_plan.tiles.flags.writeable
    for fn in (np.abs, lambda v: 2.0 * v):
        got = loaded.with_value_map(fn).spmv(x)
        assert np.array_equal(got, sess.with_value_map(fn).spmv(x))
    assert np.array_equal(loaded.spmv(x), sess.spmv(x))
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == digest


# ---------------------------------------------------------------------------
# The round-trip property (tests/test_plancache_prop.py)

COMBOS = ("NL-HL", "NL-HC", "NC-HL", "NC-HC")
EXCHANGES = ("replicated", "selective", "overlap")


def _round_trip_case(a, topo, combo, exchange, block, version, lazy=True):
    sess = distribute(a, topology=topo, combo=combo, exchange=exchange, block=block,
                      device=CPU)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    xs = rng.standard_normal((3, a.shape[1])).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plan.npz")
        sess.save(path, format_version=version)
        plancache.clear_memo()
        loaded = SparseSession.load(path, lazy=lazy, device=CPU)
        np.testing.assert_array_equal(loaded.partition.elem_unit, sess.partition.elem_unit)
        for f in ("tiles", "tile_row", "tile_col", "real_tiles"):
            np.testing.assert_array_equal(
                getattr(loaded.device_plan, f), getattr(sess.device_plan, f),
                err_msg=f"device_plan.{f} (v{version})",
            )
        assert loaded.costs() == sess.costs()
        for ex in ("simulate", "reference"):
            for xin in (x, xs):
                assert np.array_equal(sess.spmv(xin, executor=ex),
                                      loaded.spmv(xin, executor=ex)), (combo, exchange, ex)


@settings(max_examples=12, deadline=None)
@given(
    n=st.integers(min_value=48, max_value=320),
    density=st.integers(min_value=2, max_value=10),
    nodes=st.integers(min_value=2, max_value=4),
    cores=st.integers(min_value=1, max_value=3),
    combo_i=st.integers(min_value=0, max_value=3),
    exchange_i=st.integers(min_value=0, max_value=2),
    block=st.sampled_from([8, 16]),
    seed=st.integers(min_value=0, max_value=2**16),
    version=st.sampled_from([1, 2]),
)
def test_round_trip_property(n, density, nodes, cores, combo_i, exchange_i, block, seed,
                             version):
    a = random_coo(n, n * density, seed=seed)
    _round_trip_case(a, Topology(nodes, cores), COMBOS[combo_i], EXCHANGES[exchange_i],
                     block, version)


@pytest.mark.parametrize(
    "gen,n,nnz,topo,combo,exchange,block,version,lazy",
    [
        (random_coo, 128, 1200, Topology(2, 2), "NL-HL", "selective", 16, 2, True),
        (random_coo, 128, 1200, Topology(2, 2), "NL-HL", "selective", 16, 1, True),
        (banded_coo, 256, 3000, Topology(2, 3), "NL-HC", "overlap", 16, 2, True),
        (banded_coo, 256, 3000, Topology(2, 3), "NL-HC", "overlap", 16, 1, False),
        (powerlaw_coo, 300, 4500, Topology(3, 2), "NC-HL", "replicated", 8, 2, False),
        (powerlaw_coo, 222, 2200, Topology(2, 2), "nezgt", "selective", 16, 2, True),
        (random_coo, 333, 4000, Topology(2, 4), "NC-HC", "overlap", 8, 1, True),
        (banded_coo, 191, 2000, Topology(4, 1), "hyper", "replicated", 16, 2, True),
    ],
)
def test_round_trip_seeded_sweep(gen, n, nnz, topo, combo, exchange, block, version, lazy):
    _round_trip_case(gen(n, nnz, seed=n + nnz), topo, combo, exchange, block, version,
                     lazy=lazy)


def test_round_trip_survives_value_view():
    a = random_coo(150, 1800, seed=5)
    x = np.random.default_rng(1).standard_normal(150).astype(np.float32)
    sess = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange="overlap",
                      device=CPU)
    view = sess.with_value_map(np.abs)
    with tempfile.TemporaryDirectory() as d:
        path = view.save(os.path.join(d, "plan.npz"))
        loaded = SparseSession.load(path, device=CPU)
        assert loaded.tile_transform is None  # baked, not recorded
        np.testing.assert_array_equal(loaded.matrix.val, np.abs(a.val))
        for ex in ("simulate", "reference"):
            assert np.array_equal(view.spmv(x, executor=ex), loaded.spmv(x, executor=ex))


# ---------------------------------------------------------------------------
# Across packages: one archive format, one key


def _jx_coo(a):
    return JxCOO(a.shape, a.row, a.col, a.val)


@pytest.fixture(scope="module")
def shared():
    a = banded_coo(256, 2400, seed=17)
    rng = np.random.default_rng(18)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    xs = rng.standard_normal((3, a.shape[1])).astype(np.float32)
    return a, x, xs


def _both(a, exchange, **kw):
    j = jx.distribute(_jx_coo(a), topology=jx.Topology(2, 2), combo="NL-HC",
                      exchange=exchange, block=16, **kw)
    p = distribute(a, topology=TOPO, combo="NL-HC", exchange=exchange, block=16,
                   device=CPU, **kw)
    return j, p


def _members(path):
    with np.load(path, allow_pickle=False) as z:
        return {name: z[name] for name in z.files}


def test_plan_key_matches_jax(shared):
    a, _, _ = shared
    ja = _jx_coo(a)
    for topo, combo, block, exchange, seed, kw in (
        ((2, 2), "NL-HL", 16, "selective", 0, None),
        ((2, 2), "NL-HC", (8, 16), "overlap:2", 3, {"locality_weight": "auto"}),
        ((4, 1), "nezgt", (16, 16), "replicated", 1, {"dim": "cols", "fm_passes": 2}),
    ):
        assert plan_key(a, Topology(*topo), combo, block, exchange, seed, kw) == (
            jx_plancache.plan_key(ja, jx.Topology(*topo), combo, block, exchange, seed, kw)
        )


@pytest.mark.parametrize("fmt", [1, 2])
@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap", "overlap:2"])
def test_archives_cross_load(shared, tmp_path, fmt, exchange):
    """Member for member equal archives, and each package's archive loads
    in the other with its spmv bitwise the loading package's own."""
    a, x, xs = shared
    j, p = _both(a, exchange)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    if fmt == 1 and exchange == "overlap:2":  # v1 predates multi-wave plans
        with pytest.raises(ValueError) as ej:
            j.save(jpath, format_version=1)
        with pytest.raises(ValueError) as ep:
            p.save(ppath, format_version=1)
        assert str(ep.value) == str(ej.value)
        return
    j.save(jpath, format_version=fmt)
    p.save(ppath, format_version=fmt)
    mj, mp = _members(jpath), _members(ppath)
    assert sorted(mp) == sorted(mj)
    assert str(mp["meta.json"]) == str(mj["meta.json"])
    for name in mj:
        assert mp[name].dtype == mj[name].dtype and mp[name].shape == mj[name].shape, name
        assert np.array_equal(mp[name], mj[name]), name
    in_port = SparseSession.load(jpath, device=CPU)
    in_jax = jx.SparseSession.load(ppath)
    for xin in (x, xs):
        assert np.array_equal(in_port.spmv(xin), p.spmv(xin))
        assert np.array_equal(np.asarray(in_jax.spmv(xin)), np.asarray(j.spmv(xin)))


def test_cache_dir_shared_with_jax(shared, tmp_path):
    """A plan the JAX package cached is a disk hit for the port: no
    second archive, and the port's lazy load computes bitwise its own
    cold plan."""
    a, x, xs = shared
    cache = str(tmp_path / "plans")
    jx.distribute(_jx_coo(a), topology=jx.Topology(2, 2), combo="NL-HC",
                  exchange="overlap:2", block=16, cache_dir=cache)
    files = os.listdir(cache)
    hit = distribute(a, topology=TOPO, combo="NL-HC", exchange="overlap:2", block=16,
                     cache_dir=cache, device=CPU)
    assert os.listdir(cache) == files
    assert not hit.is_materialized  # loaded, not planned
    cold = distribute(a, topology=TOPO, combo="NL-HC", exchange="overlap:2", block=16,
                      device=CPU)
    assert np.array_equal(hit.spmv(xs), cold.spmv(xs))


def test_shard_map_named_archive(shared, tmp_path):
    """The meta keeps the JAX package's ``shard_map``: nothing substitutes
    ``simulate``; outside a process group the first spmv raises, and an
    ``executor=`` override loads a session bitwise the port's own."""
    a, x, _ = shared
    j, p = _both(a, "selective", executor="shard_map")
    path = j.save(str(tmp_path / "sharded.npz"))
    loaded = SparseSession.load(path, device=CPU)
    assert loaded.executor == "shard_map"
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        loaded.spmv(x)
    with pytest.raises(RuntimeError, match="process group"):
        hydrate_session(path, device=CPU).spmv(x)
    with pytest.raises(RuntimeError, match="process group"):
        loaded.with_executor("shard_map").spmv(x)
    assert loaded.verify("strict").ok  # the linter runs no executor
    over = SparseSession.load(path, executor="simulate", device=CPU)
    assert np.array_equal(over.spmv(x), p.spmv(x, executor="simulate"))
