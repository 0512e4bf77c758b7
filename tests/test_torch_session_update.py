"""Incremental replanning for the port's :meth:`SparseSession.update`, on
the CPU: the case-for-case port of ``tests/test_session_update.py`` and
``tests/test_delta_merge.py``, then the same deltas through both
packages.

Across packages: for the same numpy COO, plan and delta, the port's
patched ``DevicePlan`` and exchange-plan arrays are bitwise the JAX
package's, and the :class:`UpdateReport` is equal field for field — on
value-only and structural patches, chained patches, the patch-vs-replan
rule and forced replans. (The reference's ``shard_map`` subprocess case
runs in ``tests/test_torch_shard_exec.py``, on gloo process groups.)

What the reference's tier holds, inside the port:

The load-bearing invariant (DESIGN.md §14): a *patched* session is
bitwise-indistinguishable from a cold plan of the mutated matrix —

* value-only deltas: ``update(delta)`` ≡ ``distribute(delta.apply(A))``
  exactly, device-plan arrays and ``spmv`` alike (partitioners are
  deterministic in (pattern, seed), so the cold plan lands on the same
  assignment and the patched tiles must match it bit for bit);
* structural deltas: the patch keeps the incremental unit assignment
  (inherited units for inserts), so the oracle is a cold
  ``pack_units`` + exchange build *on that same assignment* — again
  bitwise, on every executor;
* replans: a fresh partition of the mutated matrix — pinned against the
  sequential CSR oracle.

Sweeps cover combo × exchange (multi-wave ``overlap:K`` included),
hypothesis-driven random deltas,
PAPER_SUITE cells, the degenerate deltas (empty, single-block, a delta
that empties a whole unit), and the §13 patch-vs-replan decision rule.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
import repro.api as jx
from repro.sparse.delta import SparseDelta as JxDelta
from repro.sparse.formats import COO as JxCOO
from repro_torch.api import SparseSession, SparseDelta, Topology, distribute
from repro_torch.api.exchange import resolve_exchange
from repro_torch.api.session import PATCH_TOUCH_LIMIT, REPLAN_FM_KW
from repro_torch.pmvc.plan_device import pack_units
from repro_torch.sparse.formats import COO, csr_from_coo
from repro_torch.sparse.generate import PAPER_SUITE, generate, random_coo
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

TOPO = Topology(2, 2)
BLOCK = 32
CPU = "cpu"


def _mat(seed=0, n=256, nnz=3000):
    return random_coo(n, nnz, seed=seed)


def _rand_delta(a, rng, *, n_value=0, n_insert=0, n_delete=0):
    """A valid random delta: value updates + inserts + deletes, all
    disjoint, deletes/updates on existing coords, inserts on holes."""
    n, m = a.shape
    akey = a.row.astype(np.int64) * m + a.col
    perm = rng.permutation(a.nnz)
    del_idx = perm[:n_delete]
    val_idx = perm[n_delete : n_delete + n_value]
    up_row = [a.row[val_idx]]
    up_col = [a.col[val_idx]]
    up_val = [rng.standard_normal(val_idx.size).astype(np.float32)]
    if n_insert:
        cand_r = rng.integers(0, n, n_insert * 4).astype(a.row.dtype)
        cand_c = rng.integers(0, m, n_insert * 4).astype(a.col.dtype)
        ckey = cand_r.astype(np.int64) * m + cand_c
        fresh = ~np.isin(ckey, akey)
        _, first = np.unique(ckey, return_index=True)
        uniq = np.zeros(ckey.size, dtype=bool)
        uniq[first] = True
        pick = np.nonzero(fresh & uniq)[0][:n_insert]
        up_row.append(cand_r[pick])
        up_col.append(cand_c[pick])
        up_val.append(rng.standard_normal(pick.size).astype(np.float32))
    return SparseDelta.merge(
        a.shape,
        up_row=np.concatenate(up_row),
        up_col=np.concatenate(up_col),
        up_val=np.concatenate(up_val),
        del_row=a.row[del_idx],
        del_col=a.col[del_idx],
    )


def _cold_same_assignment(patched: SparseSession, mutated: COO) -> SparseSession:
    """The structural-patch oracle: cold-pack the mutated matrix on the
    *patched* session's unit assignment and rebuild its exchange."""
    dp = patched.device_plan
    dp_cold = pack_units(
        mutated, patched.partition.elem_unit, dp.num_units, dp.bm, dp.bn
    )
    return SparseSession(
        mutated,
        patched.topology,
        patched.partition,
        dp_cold,
        exchange=patched.exchange,
        selective=resolve_exchange(patched.exchange)(dp_cold),
        executor=patched.executor,
        device=patched.device,
    )


def _assert_same_plan(dp_a, dp_b):
    assert np.array_equal(dp_a.real_tiles, dp_b.real_tiles)
    assert np.array_equal(dp_a.tile_row, dp_b.tile_row)
    assert np.array_equal(dp_a.tile_col, dp_b.tile_col)
    assert np.array_equal(dp_a.tiles, dp_b.tiles)


# ---------------------------------------------------------------------------
# Bitwise: patched == cold, across combo x exchange


@pytest.mark.parametrize("combo", ["NL-HL", "nezgt"])
@pytest.mark.parametrize(
    "exchange", ["replicated", "selective", "overlap", "overlap:2"]
)
def test_value_patch_bitwise_equals_cold_distribute(combo, exchange):
    """A value-only delta patched in place is indistinguishable from
    planning the mutated matrix from scratch — same plan arrays, same
    spmv bits."""
    a = _mat(1)
    rng = np.random.default_rng(11)
    sess = distribute(
        a, topology=TOPO, combo=combo, exchange=exchange, block=BLOCK, seed=0, device=CPU)
    delta = _rand_delta(a, rng, n_value=12)
    patched = sess.update(delta, force="patch")
    assert patched.update_report.action == "patched"
    assert not patched.update_report.structural
    mutated = delta.apply(a)
    cold = distribute(
        mutated, topology=TOPO, combo=combo, exchange=exchange, block=BLOCK, seed=0, device=CPU)
    _assert_same_plan(patched.device_plan, cold.device_plan)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    assert np.array_equal(np.asarray(patched.spmv(x)), np.asarray(cold.spmv(x)))


@pytest.mark.parametrize("combo", ["NL-HL", "nezgt"])
@pytest.mark.parametrize(
    "exchange", ["replicated", "selective", "overlap", "overlap:2"]
)
def test_structural_patch_bitwise_equals_cold_pack(combo, exchange):
    """Inserts + deletes patched in place match a cold pack of the
    mutated matrix on the same (incrementally inherited) assignment."""
    a = _mat(2)
    rng = np.random.default_rng(13)
    sess = distribute(
        a, topology=TOPO, combo=combo, exchange=exchange, block=BLOCK, seed=0, device=CPU)
    delta = _rand_delta(a, rng, n_value=6, n_insert=8, n_delete=8)
    patched = sess.update(delta, force="patch")
    assert patched.update_report.action == "patched"
    assert patched.update_report.structural
    mutated = delta.apply(a)
    cold = _cold_same_assignment(patched, mutated)
    _assert_same_plan(patched.device_plan, cold.device_plan)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    assert np.array_equal(np.asarray(patched.spmv(x)), np.asarray(cold.spmv(x)))


def test_chained_patches_stay_bitwise():
    """Plans survive repeated patching: five stacked structural deltas,
    each checked against the cold pack of its cumulative matrix."""
    a = _mat(3)
    rng = np.random.default_rng(17)
    sess = distribute(
        a, topology=TOPO, combo="NL-HL", exchange="selective", block=BLOCK, seed=0, device=CPU)
    cur = a
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    for _ in range(5):
        delta = _rand_delta(cur, rng, n_value=4, n_insert=3, n_delete=3)
        sess = sess.update(delta, force="patch")
        cur = delta.apply(cur)
        cold = _cold_same_assignment(sess, cur)
        assert np.array_equal(np.asarray(sess.spmv(x)), np.asarray(cold.spmv(x)))


@pytest.mark.parametrize("name", ["bcsstm09", "t2dal"])
def test_paper_suite_cells_update(name):
    """Suite matrices from the paper's Table 4.2: mixed deltas through
    the full decision rule stay correct against the CSR oracle, and
    patches stay bitwise against the same-assignment cold pack."""
    a = generate(PAPER_SUITE[name], seed=0)
    rng = np.random.default_rng(23)
    sess = distribute(
        a, topology=TOPO, combo="NL-HC", exchange="selective", block=BLOCK, seed=0, device=CPU)
    delta = _rand_delta(a, rng, n_value=10, n_insert=5, n_delete=5)
    new = sess.update(delta)
    mutated = delta.apply(a)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(new.spmv(x))
    y_ref = csr_from_coo(mutated).matvec(x)
    err = np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1e-30)
    assert err < 1e-4, (name, new.update_report.action, err)
    if new.update_report.action == "patched":
        cold = _cold_same_assignment(new, mutated)
        assert np.array_equal(y, np.asarray(cold.spmv(x)))


# ---------------------------------------------------------------------------
# Hypothesis: random deltas never break the patched == cold invariant


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    n_value=st.integers(min_value=0, max_value=12),
    n_insert=st.integers(min_value=0, max_value=10),
    n_delete=st.integers(min_value=0, max_value=10),
)
def test_random_delta_patch_property(seed, n_value, n_insert, n_delete):
    a = _mat(4, n=128, nnz=900)
    rng = np.random.default_rng(seed)
    sess = distribute(
        a, topology=TOPO, combo="nezgt", exchange="selective", block=16, seed=0, device=CPU)
    delta = _rand_delta(
        a, rng, n_value=n_value, n_insert=n_insert, n_delete=n_delete
    )
    patched = sess.update(delta, force="patch")
    mutated = delta.apply(a)
    cold = _cold_same_assignment(patched, mutated)
    _assert_same_plan(patched.device_plan, cold.device_plan)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    assert np.array_equal(np.asarray(patched.spmv(x)), np.asarray(cold.spmv(x)))


# ---------------------------------------------------------------------------
# Seeded sweep: many seeds, cheap cells, no hypothesis dependency


@pytest.mark.parametrize("seed", range(8))
def test_seeded_sweep_mixed_deltas(seed):
    a = _mat(5, n=128, nnz=900)
    rng = np.random.default_rng(1000 + seed)
    sess = distribute(
        a, topology=TOPO, combo="NL-HL", exchange="overlap", block=16, seed=0, device=CPU)
    delta = _rand_delta(a, rng, n_value=5, n_insert=4, n_delete=4)
    patched = sess.update(delta, force="patch")
    mutated = delta.apply(a)
    cold = _cold_same_assignment(patched, mutated)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    assert np.array_equal(np.asarray(patched.spmv(x)), np.asarray(cold.spmv(x)))


# ---------------------------------------------------------------------------
# Degenerate deltas


def test_empty_delta_is_identity():
    a = _mat(6)
    sess = distribute(
        a, topology=TOPO, combo="NL-HL", exchange="selective", block=BLOCK, seed=0, device=CPU)
    new = sess.update(SparseDelta.empty(a.shape))
    assert new.update_report.action == "patched"
    assert new.update_report.touched_tiles == 0
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
    assert np.array_equal(np.asarray(new.spmv(x)), np.asarray(sess.spmv(x)))


def test_all_in_one_block_delta():
    """Every mutation lands in one tile: exactly one tile is touched and
    the patch is still bitwise against the cold plan."""
    a = _mat(7)
    sess = distribute(
        a, topology=TOPO, combo="NL-HL", exchange="selective", block=BLOCK, seed=0, device=CPU)
    in_block = (a.row < BLOCK) & (a.col < BLOCK)
    # Tile identity includes the owning unit (a split tile lives on two
    # units) — stay within one unit's piece so exactly one tile moves.
    unit = sess.partition.elem_unit
    in_block &= unit == unit[np.nonzero(in_block)[0][0]]
    idx = np.nonzero(in_block)[0][:4]
    assert idx.size, "seed produced no elements in tile (0,0); pick another"
    delta = SparseDelta.upserts(
        a.shape, a.row[idx], a.col[idx], np.full(idx.size, 2.5, np.float32)
    )
    patched = sess.update(delta, force="patch")
    assert patched.update_report.touched_tiles == 1
    mutated = delta.apply(a)
    cold = distribute(
        mutated, topology=TOPO, combo="NL-HL", exchange="selective",
        block=BLOCK, seed=0, device=CPU)
    x = np.random.default_rng(1).standard_normal(a.shape[1]).astype(np.float32)
    assert np.array_equal(np.asarray(patched.spmv(x)), np.asarray(cold.spmv(x)))


def test_delta_that_empties_a_unit():
    """Deleting every element a unit owns leaves that unit with zero
    real tiles; the patched plan must still pack and execute."""
    a = _mat(8, n=128, nnz=900)
    sess = distribute(
        a, topology=TOPO, combo="nezgt", exchange="selective", block=16, seed=0, device=CPU)
    unit = sess.partition.elem_unit
    victim = int(np.argmin(np.bincount(unit, minlength=TOPO.units)))
    sel = unit == victim
    assert sel.any(), "every unit owns elements in this cell"
    delta = SparseDelta.deletes(a.shape, a.row[sel], a.col[sel])
    patched = sess.update(delta, force="patch")
    assert int(patched.device_plan.real_tiles[victim]) == 0
    mutated = delta.apply(a)
    cold = _cold_same_assignment(patched, mutated)
    _assert_same_plan(patched.device_plan, cold.device_plan)
    x = np.random.default_rng(2).standard_normal(a.shape[1]).astype(np.float32)
    assert np.array_equal(np.asarray(patched.spmv(x)), np.asarray(cold.spmv(x)))


def test_invalid_deltas_raise():
    a = _mat(9, n=64, nnz=300)
    with pytest.raises(ValueError):  # delete of a structural zero
        akey = a.row.astype(np.int64) * a.shape[1] + a.col
        r, c = 0, 0
        while (np.int64(r) * a.shape[1] + c) in akey:
            c += 1
        SparseDelta.deletes(a.shape, np.array([r]), np.array([c])).apply(a)
    with pytest.raises(ValueError):  # out-of-bounds upsert
        SparseDelta.upserts(
            a.shape, np.array([a.shape[0]]), np.array([0]),
            np.array([1.0], np.float32),
        ).validate()
    sess = distribute(a, topology=TOPO, block=16, device=CPU)
    with pytest.raises(ValueError):  # shape mismatch
        sess.update(SparseDelta.empty((a.shape[0] + 1, a.shape[1])))


# ---------------------------------------------------------------------------
# The Sec. 13 patch-vs-replan decision rule


def test_small_delta_patches_large_delta_replans():
    a = _mat(10)
    rng = np.random.default_rng(31)
    sess = distribute(
        a, topology=TOPO, combo="NL-HL", exchange="selective", block=BLOCK, seed=0, device=CPU)
    small = sess.update(_rand_delta(a, rng, n_value=3))
    assert small.update_report.action == "patched"
    assert small.update_report.touched_fraction <= PATCH_TOUCH_LIMIT
    # Touch (almost) every tile: the fraction rule must force a replan.
    big = sess.update(
        _rand_delta(a, rng, n_value=a.nnz // 2), force=None
    )
    assert big.update_report.action == "replanned"
    assert "PATCH_TOUCH_LIMIT" in big.update_report.reason


def test_forced_replan_lightens_fm_budget():
    a = _mat(11)
    sess = distribute(
        a, topology=TOPO, combo="NL-HL", exchange="selective", block=BLOCK, seed=0, device=CPU)
    rng = np.random.default_rng(37)
    new = sess.update(_rand_delta(a, rng, n_value=2), force="replan")
    assert new.update_report.action == "replanned"
    assert new.update_report.reason == "forced"
    cfg = new._plan_config["partitioner_kw"]
    for k, v in REPLAN_FM_KW.items():
        assert cfg[k] == v
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    mutated = _rand_delta(a, np.random.default_rng(37), n_value=2).apply(a)
    y_ref = csr_from_coo(mutated).matvec(x)
    y = np.asarray(new.spmv(x))
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-4


def test_replan_preserves_plan_config():
    """A replan re-runs the partitioner the session was planned with —
    flat method and dim survive the round trip."""
    a = _mat(12)
    sess = distribute(
        a, topology=TOPO, combo="nezgt", exchange="selective", block=BLOCK, seed=0, device=CPU)
    rng = np.random.default_rng(41)
    new = sess.update(_rand_delta(a, rng, n_value=2), force="replan")
    assert new.partition.name == "nezgt:rows"
    assert new._plan_config["combo"] == "nezgt"


def test_update_report_shape():
    a = _mat(13, n=128, nnz=900)
    sess = distribute(a, topology=TOPO, block=16, device=CPU)
    rng = np.random.default_rng(43)
    rep = sess.update(_rand_delta(a, rng, n_value=2)).update_report
    assert rep.total_tiles > 0 and 0 < rep.touched_tiles <= rep.total_tiles
    assert 0.0 < rep.touched_fraction <= 1.0


# ---------------------------------------------------------------------------
# SparseDelta.merge edge cases (tests/test_delta_merge.py): malformed
# batches fail eagerly at construction with a message naming the problem

SHAPE = (10, 10)


def test_conflicting_upsert_and_delete():
    with pytest.raises(ValueError, match="upsert and delete sets overlap"):
        SparseDelta.merge(
            SHAPE,
            up_row=[1], up_col=[2], up_val=[3.0],
            del_row=[1], del_col=[2],
        )


def test_duplicate_upsert_coords():
    with pytest.raises(ValueError, match="duplicate coordinates in upserts"):
        SparseDelta.merge(
            SHAPE, up_row=[4, 4], up_col=[5, 5], up_val=[1.0, 2.0]
        )


def test_duplicate_delete_coords():
    with pytest.raises(ValueError, match="duplicate coordinates in deletes"):
        SparseDelta.merge(SHAPE, del_row=[3, 3], del_col=[7, 7])


@pytest.mark.parametrize(
    "kw",
    [
        {"up_row": [10], "up_col": [0], "up_val": [1.0]},
        {"up_row": [0], "up_col": [-1], "up_val": [1.0]},
        {"del_row": [0], "del_col": [10]},
    ],
)
def test_out_of_bounds_rejected(kw):
    with pytest.raises(ValueError, match="coordinates out of bounds for shape"):
        SparseDelta.merge(SHAPE, **kw)


def test_mismatched_lengths_rejected():
    with pytest.raises(ValueError, match="matching shapes"):
        SparseDelta.merge(SHAPE, up_row=[1, 2], up_col=[3], up_val=[1.0])


def test_empty_merge_is_identity():
    delta = SparseDelta.merge(SHAPE)
    assert delta.size == 0
    a = generate(PAPER_SUITE["bcsstm09"], seed=0)
    delta = SparseDelta.merge(a.shape)
    b = delta.apply(a)
    assert b.row.shape == a.row.shape
    np.testing.assert_array_equal(b.row, a.row)
    np.testing.assert_array_equal(b.col, a.col)
    np.testing.assert_array_equal(b.val, a.val)


def test_valid_combined_merge_applies():
    a = generate(PAPER_SUITE["bcsstm09"], seed=0)
    # Overwrite one existing entry, insert one new, delete another.
    r0, c0 = int(a.row[0]), int(a.col[0])
    r1, c1 = int(a.row[1]), int(a.col[1])
    akey = set(zip(a.row.tolist(), a.col.tolist()))
    new = next(
        (i, j)
        for i in range(a.shape[0])
        for j in range(a.shape[1])
        if (i, j) not in akey
    )
    delta = SparseDelta.merge(
        a.shape,
        up_row=[r0, new[0]], up_col=[c0, new[1]], up_val=[9.0, 7.0],
        del_row=[r1], del_col=[c1],
    )
    b = delta.apply(a)
    assert b.row.shape[0] == a.row.shape[0]  # +1 insert, -1 delete
    bmap = {(int(r), int(c)): float(v) for r, c, v in zip(b.row, b.col, b.val)}
    assert bmap[(r0, c0)] == 9.0
    assert bmap[new] == 7.0
    assert (r1, c1) not in bmap


# ---------------------------------------------------------------------------
# Across packages: the same plan and delta through the JAX package


def _jx_coo(a):
    return JxCOO(a.shape, a.row, a.col, a.val)


def _jx_delta(d):
    return JxDelta(shape=d.shape, up_row=d.up_row, up_col=d.up_col, up_val=d.up_val,
                   del_row=d.del_row, del_col=d.del_col)


def _pair(a, combo, exchange, block=BLOCK):
    j = jx.distribute(_jx_coo(a), topology=jx.Topology(2, 2), combo=combo,
                      exchange=exchange, block=block, seed=0)
    p = distribute(a, topology=TOPO, combo=combo, exchange=exchange, block=block,
                   seed=0, device=CPU)
    return j, p


def _assert_same(p, j, path="session"):
    """Equal field for field through nested dataclasses; arrays bitwise,
    with their dtype and shape."""
    if dataclasses.is_dataclass(j):
        assert dataclasses.is_dataclass(p) and type(p).__name__ == type(j).__name__, path
        for f in dataclasses.fields(j):
            _assert_same(getattr(p, f.name), getattr(j, f.name), f"{path}.{f.name}")
    elif isinstance(j, np.ndarray):
        p = np.asarray(p)
        assert (p.dtype, p.shape) == (j.dtype, j.shape), path
        assert np.array_equal(p, j), path
    else:
        assert p == j, path


def _assert_update_matches(p, j):
    _assert_same(p.update_report, j.update_report, "update_report")
    for name in ("matrix", "partition", "device_plan", "selective"):
        _assert_same(getattr(p, name), getattr(j, name), name)
    assert p.exchange == j.exchange
    assert p.device == torch.device(CPU)


@pytest.mark.parametrize("kind", ["value", "structural"])
@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap", "overlap:2"])
@pytest.mark.parametrize("combo", ["NL-HL", "nezgt"])
def test_patches_match_jax(combo, exchange, kind):
    a = _mat(2)
    counts = {"value": dict(n_value=12),
              "structural": dict(n_value=6, n_insert=8, n_delete=8)}[kind]
    delta = _rand_delta(a, np.random.default_rng(13), **counts)
    j, p = _pair(a, combo, exchange)
    pj = j.update(_jx_delta(delta), force="patch")
    pp = p.update(delta, force="patch")
    assert pp.update_report.structural == (kind == "structural")
    _assert_update_matches(pp, pj)


def test_chained_patches_match_jax():
    a = _mat(3)
    rng = np.random.default_rng(17)
    j, p = _pair(a, "NL-HL", "overlap:2")
    cur = a
    for _ in range(4):
        delta = _rand_delta(cur, rng, n_value=4, n_insert=3, n_delete=3)
        j, p = j.update(_jx_delta(delta)), p.update(delta)
        cur = delta.apply(cur)
        _assert_update_matches(p, j)


def test_patch_or_replan_rule_matches_jax():
    """The touch-limit replan and a forced replan run the same lightened
    planning run in both packages, so even the replanned sessions are
    equal array for array."""
    a = _mat(10)
    rng = np.random.default_rng(31)
    j, p = _pair(a, "NL-HL", "selective")
    for delta, force in (
        (_rand_delta(a, rng, n_value=3), None),
        (_rand_delta(a, rng, n_value=a.nnz // 2), None),
        (_rand_delta(a, rng, n_value=2, n_insert=2), "replan"),
    ):
        uj, up = j.update(_jx_delta(delta), force=force), p.update(delta, force=force)
        _assert_update_matches(up, uj)
        assert up._plan_config == uj._plan_config
    assert up.update_report.action == "replanned"


@pytest.mark.parametrize("force", ["patch", "replan"])
def test_update_of_a_loaded_session_matches_jax(tmp_path, force):
    """A session loaded from an archive carries no planning recipe: a
    replan reads it from the partition's name, in both packages."""
    a = _mat(12, n=160, nnz=1500)
    _, p = _pair(a, "nezgt", "overlap")
    path = p.save(str(tmp_path / "plan.npz"))
    lp = SparseSession.load(path, device=CPU)
    lj = jx.SparseSession.load(path)
    delta = _rand_delta(a, np.random.default_rng(41), n_value=3, n_insert=2, n_delete=2)
    _assert_update_matches(lp.update(delta, force=force), lj.update(_jx_delta(delta), force=force))


def test_update_keeps_the_device_and_starts_cold():
    """The patched session computes where the old one did, with its own
    executor closures: a structural patch may change the tile capacity."""
    a = _mat(14, n=128, nnz=900)
    sess = distribute(a, topology=TOPO, exchange="overlap:2", block=16, device=CPU)
    x = np.random.default_rng(3).standard_normal(a.shape[1]).astype(np.float32)
    y_old = sess.spmv(x)
    delta = _rand_delta(a, np.random.default_rng(5), n_insert=40)
    for force in ("patch", "replan"):
        new = sess.update(delta, force=force)
        assert new.device == sess.device
        assert new._spmv_cache is not sess._spmv_cache
        y_ref = csr_from_coo(delta.apply(a)).matvec(x)
        assert np.abs(new.spmv(x) - y_ref).max() / np.abs(y_ref).max() < 1e-5
    assert np.array_equal(sess.spmv(x), y_old)  # the old session is untouched
