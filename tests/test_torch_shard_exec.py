"""The port's ``shard_map`` executor on ``torch.distributed``, on the CPU.

The counterpart of the JAX package's ``shard_map`` subprocess cells
(``tests/test_api_session.py``, ``tests/test_pmvc_dist.py``,
``tests/test_session_update.py``), run on gloo process groups of 4 and
2 ranks started by ``torch.multiprocessing`` with a ``file://`` store:
one rank per unit, and two units stacked per rank. Every rank plans the
same matrix with the same seed and runs every cell of this file in one
spawn per group size (:func:`_rank_cells`); the tests then read what
each rank returned. Each spawn has its own time limit, so a hang fails
the tests instead of eating the suite's.

Held: each spmv within 1e-5 relative of the float64 ``reference``
executor, of the port's ``simulate`` and of the JAX package's
``simulate`` on the same inputs, on replicated, selective, overlap and
overlap:2, for one x and a ``[4, N]`` batch, the same y on every rank;
the recorded schedule equal to ``golden_signature``; the JAX package's
thermal cell (8 units on 4 ranks) at its ``rtol = atol = 2e-4`` of
both packages' CSR matvec; an archive whose meta names ``shard_map`` running in a group;
patched ≡ cold bitwise on ``shard_map``; ``ValueError`` when the ranks
do not divide the units, and ``RuntimeError`` without a group.

``python tests/test_torch_shard_exec.py`` prints, for 4 gloo ranks,
whether column b of a batched spmv is bitwise the B = 1 spmv of that
column — a measurement: ``all_reduce`` promises no summation order.
"""
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.analysis import golden_signature, schedule_signature
from repro_torch.api import SparseDelta, SparseSession, Topology, distribute
from repro_torch.core.combined import two_level_partition
from repro_torch.pmvc.dist import Communicator, make_pmvc_step, make_unit_mesh, pad_x
from repro_torch.pmvc.plan_device import build_selective_plan, pack_units
from repro_torch.sparse.formats import csr_from_coo
from repro_torch.sparse.generate import PAPER_SUITE, generate, random_coo

CPU = "cpu"
EXCHANGES = ("replicated", "selective", "overlap", "overlap:2")
WORLDS = (4, 2)
SPAWN_TIMEOUT = 240.0  # seconds for one group's spawn; a run takes a few


def _api_matrix():
    return random_coo(256, 3000, seed=9)


def _api_x(n, batch=4):
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    xs = np.random.default_rng(2).standard_normal((batch, n)).astype(np.float32)
    return x, xs


def _thermal_x(n):
    return np.random.default_rng(7).standard_normal(n).astype(np.float32)


def _recorded_signature(sess, x):
    """The schedule of one step over ``sess``'s plan on this group,
    through a logging communicator."""
    log = []
    dp = sess.device_plan
    step = make_pmvc_step(dp, make_unit_mesh(dp.num_units, comm=Communicator(log=log)),
                          selective=sess.selective, device=CPU)
    step(pad_x(torch.as_tensor(x), dp.num_col_blocks, dp.bn))
    return schedule_signature(log)


def _rank_cells(world, jax_archive, batch):
    """Every cell of this file on one rank of the initialised group;
    ``batch`` is the width of the batched spmv."""
    out = {"api": {}, "thermal": {}, "update": {}}
    a = _api_matrix()
    x, xs = _api_x(a.shape[1], batch)
    for exchange in EXCHANGES:
        sess = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange=exchange,
                          executor="shard_map", device=CPU)
        out["api"][exchange] = {
            "y": sess.spmv(x), "yb": sess.spmv(xs),
            "cols": [sess.spmv(xs[j]) for j in range(xs.shape[0])],
            "sim": sess.spmv(x, executor="simulate"), "simb": sess.spmv(xs, executor="simulate"),
            "ref": sess.spmv(x, executor="reference"),
            "refb": sess.spmv(xs, executor="reference"),
            "sig": _recorded_signature(sess, x),
            "waves": getattr(sess.selective, "waves", 1),
        }

    # An archive whose meta names shard_map: the JAX package's, and the port's own.
    live = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange="selective",
                      executor="shard_map", device=CPU)
    jax_loaded = SparseSession.load(jax_archive, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        own = SparseSession.load(live.save(os.path.join(d, "own.npz")), device=CPU)
        out["archive"] = {"executors": (jax_loaded.executor, own.executor),
                          "jax": jax_loaded.spmv(x), "own": own.spmv(x), "live": live.spmv(x)}

    # Units that do not split over the ranks.
    odd = distribute(a, topology=Topology(3, 1), executor="shard_map", device=CPU)
    try:
        odd.spmv(x)
        out["odd"] = None
    except ValueError as err:
        out["odd"] = str(err)
    if world != 4:
        return out

    # tests/test_pmvc_dist.py's thermal cell: 8 units on 4 ranks.
    t = generate(PAPER_SUITE["thermal"])
    plan2 = two_level_partition(t, 4, 2, "NL-HL")
    unit = plan2.elem_node.astype(np.int64) * 2 + plan2.elem_core
    dp = pack_units(t, unit, 8, 16, 16)
    xt = _thermal_x(t.shape[1])
    xb = pad_x(torch.as_tensor(xt), dp.num_col_blocks, dp.bn)
    mesh = make_unit_mesh(8)
    for name, sp in (("replicated", None), ("selective", build_selective_plan(dp))):
        y = make_pmvc_step(dp, mesh, selective=sp, device=CPU)(xb)
        out["thermal"][name] = (y.reshape(-1)[: t.shape[0]].numpy(), csr_from_coo(t).matvec(xt))

    # tests/test_session_update.py's shard_map case: patched == cold, bitwise.
    u = random_coo(256, 3000, seed=21)
    rng = np.random.default_rng(5)
    idx = rng.permutation(u.nnz)[:10]
    delta = SparseDelta.upserts(u.shape, u.row[idx], u.col[idx],
                                rng.standard_normal(10).astype(np.float32))
    xu = rng.standard_normal(u.shape[1]).astype(np.float32)
    for exchange in ("selective", "overlap:2"):
        kw = {"topology": Topology(2, 2), "combo": "NL-HC", "exchange": exchange,
              "executor": "shard_map", "block": 32, "seed": 0, "device": CPU}
        patched = distribute(u, **kw).update(delta, force="patch")
        cold = distribute(delta.apply(u), **kw)
        out["update"][exchange] = (patched.spmv(xu), cold.spmv(xu))
    return out


def _rank_main(rank, world, store, out_dir, jax_archive, batch):
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank)
    try:
        got = _rank_cells(world, jax_archive, batch)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(got, fh)


def spawn_group(world, work_dir, jax_archive, batch=4):
    """Run :func:`_rank_cells` on ``world`` gloo ranks; returns each
    rank's results. Fails after SPAWN_TIMEOUT seconds, killing the ranks."""
    ctx = mp.start_processes(
        _rank_main,
        args=(world, os.path.join(work_dir, "store"), work_dir, jax_archive, batch),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT} s")
    out = []
    for rank in range(world):
        with open(os.path.join(work_dir, f"rank{rank}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _jax_archive(path):
    """The JAX package's plan of the API matrix, saved naming shard_map."""
    import repro.api as jx
    from repro.sparse.formats import COO as JxCOO

    a = _api_matrix()
    sess = jx.distribute(JxCOO(a.shape, a.row, a.col, a.val), topology=jx.Topology(2, 2),
                         combo="NL-HC", exchange="selective", executor="shard_map")
    return sess.save(path)


def _jax_outputs(batch=4):
    """The JAX package's y on this file's inputs: its ``simulate`` on the
    API matrix for each exchange (x and the batch), and its CSR matvec
    on the thermal cell."""
    import repro.api as jx
    from repro.sparse.formats import COO as JxCOO, csr_from_coo as jx_csr_from_coo
    from repro.sparse.generate import PAPER_SUITE as JX_SUITE, generate as jx_generate

    a = _api_matrix()
    x, xs = _api_x(a.shape[1], batch)
    out = {}
    for exchange in EXCHANGES:
        sess = jx.distribute(JxCOO(a.shape, a.row, a.col, a.val), topology=jx.Topology(2, 2),
                             combo="NL-HC", exchange=exchange, executor="simulate")
        out[exchange] = (np.asarray(sess.spmv(x)), np.asarray(sess.spmv(xs)))
    t = jx_generate(JX_SUITE["thermal"])
    out["thermal"] = np.asarray(jx_csr_from_coo(t).matvec(_thermal_x(t.shape[1])))
    return out


@pytest.fixture(scope="module")
def jax_y():
    return _jax_outputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{world: [rank 0's results, ...]}`` for both group sizes."""
    base = tmp_path_factory.mktemp("groups")
    archive = _jax_archive(str(base / "jax-shard-map.npz"))
    out = {}
    for world in WORLDS:
        work = base / f"w{world}"
        work.mkdir()
        out[world] = spawn_group(world, str(work), archive)
    return out


def _rel(y, ref):
    return float(np.abs(y - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("world", WORLDS)
def test_spmv_matches_oracle_and_simulate(runs, jax_y, world, exchange):
    """One unit a rank (4 ranks) and two units stacked (2 ranks): single
    and batched spmv within 1e-5 of the float64 oracle, of the port's
    simulate and of the JAX package's simulate on the same inputs, and
    the same bits on every rank."""
    cells = [r["api"][exchange] for r in runs[world]]
    c = cells[0]
    jx_y, jx_yb = jax_y[exchange]
    assert c["y"].shape == c["ref"].shape and c["yb"].shape == c["refb"].shape == (4, 256)
    for y, ref in ((c["y"], c["ref"]), (c["yb"], c["refb"]),
                   (c["y"], c["sim"]), (c["yb"], c["simb"]),
                   (c["y"], jx_y), (c["yb"], jx_yb)):
        assert y.shape == ref.shape and _rel(y, ref) < 1e-5, (world, exchange, _rel(y, ref))
    for other in cells[1:]:
        assert np.array_equal(other["y"], c["y"]) and np.array_equal(other["yb"], c["yb"])


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("world", WORLDS)
def test_recorded_schedule_is_golden(runs, world, exchange):
    for r in runs[world]:
        c = r["api"][exchange]
        assert c["sig"] == golden_signature(exchange, c["waves"])


@pytest.mark.parametrize("exchange", ("replicated", "selective"))
def test_thermal_eight_units_on_four_ranks(runs, jax_y, exchange):
    """Each rank's y against the port's CSR matvec and the JAX package's
    on the same matrix and x."""
    for r in runs[4]:
        y, y_ref = r["thermal"][exchange]
        np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(y, jax_y["thermal"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_archive_naming_shard_map_runs_in_a_group(runs, world):
    """Archives keep the executor name; in a group they run on it, the
    JAX package's archive bitwise the port's live session."""
    for r in runs[world]:
        c = r["archive"]
        assert c["executors"] == ("shard_map", "shard_map")
        assert np.array_equal(c["jax"], c["live"]) and np.array_equal(c["own"], c["live"])


@pytest.mark.parametrize("exchange", ("selective", "overlap:2"))
def test_patched_equals_cold_on_shard_map(runs, exchange):
    for r in runs[4]:
        patched, cold = r["update"][exchange]
        assert np.array_equal(patched, cold), exchange


@pytest.mark.parametrize("world", WORLDS)
def test_units_must_split_over_the_ranks(runs, world):
    for r in runs[world]:
        assert r["odd"] is not None and f"3 units do not split evenly over {world}" in r["odd"]


def test_executor_raises_without_a_group():
    """No process group: building the executor raises, and nothing runs
    the units on one device in its place."""
    assert not dist.is_initialized()
    sess = distribute(_api_matrix(), topology=Topology(2, 2), executor="shard_map", device=CPU)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        sess.spmv(np.ones(256, np.float32))
    with pytest.raises(RuntimeError, match="never runs the units on one device"):
        make_unit_mesh(4)
    assert "shard_map" not in sess._spmv_cache


if __name__ == "__main__":
    print(f"gloo, 4 ranks, {sys.platform}, torch {torch.__version__}:")
    for batch in (4, 64):
        with tempfile.TemporaryDirectory() as d:
            archive = _jax_archive(os.path.join(d, "jax.npz"))
            os.mkdir(os.path.join(d, "w4"))
            ranks = spawn_group(4, os.path.join(d, "w4"), archive, batch)
        for exchange in EXCHANGES:
            c = ranks[0]["api"][exchange]
            same = sum(np.array_equal(c["yb"][j], col) for j, col in enumerate(c["cols"]))
            print(f"  {exchange}, B={batch}: {same} of {batch} columns bitwise the B=1 "
                  f"spmv; bitwise simulate at B={batch}: "
                  f"{bool(np.array_equal(c['yb'], c['simb']))}")
