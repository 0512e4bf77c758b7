"""The port's runtime (:mod:`repro_torch.runtime`) against the JAX
package's, on the CPU.

``FaultInjector``, ``Heartbeat`` (with ``time.monotonic`` patched) and
``StragglerMonitor`` are copies: the same inputs give the same failures,
the same dead workers, the same flags and the same EWMA, exactly.
``reshard_tree`` / ``elastic_restart`` place a tree on a CPU mesh and
read it back bitwise, with the placement keys the JAX package gives its
``spec_fn``; what is not ported (a sharded placement) says so.
"""
import time

import numpy as np
import pytest
import torch

import repro.runtime.elastic as jx_elastic
import repro.runtime.fault as jx_fault
import repro_torch.runtime as RT
from repro_torch.runtime.elastic import P, Replicated, local_devices

SCHEDULES = ({}, {3: 1}, {0: 2, 5: 0, 6: 3}, {k: k % 4 for k in range(0, 20, 3)})


@pytest.mark.parametrize("schedule", SCHEDULES, ids=range(len(SCHEDULES)))
def test_fault_injector_fires_as_the_jax_one(schedule):
    def run(pkg):
        inj = pkg.FaultInjector(schedule=dict(schedule))
        seen = []
        for step in list(range(20)) + [3, 5, 6]:  # steps seen again never re-fire
            try:
                inj.check(step)
            except pkg.WorkerFailure as err:
                seen.append((err.step, err.worker, str(err)))
        return seen, inj.fired

    assert run(RT) == run(jx_fault)
    assert issubclass(RT.WorkerFailure, RuntimeError)


def test_heartbeat_declares_the_same_dead_workers(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    port, ref = RT.Heartbeat(5, timeout=2.0), jx_fault.Heartbeat(5, timeout=2.0)
    rng = np.random.default_rng(3)
    for _ in range(30):
        now[0] += float(rng.uniform(0.0, 1.5))
        for w in rng.choice(5, size=int(rng.integers(0, 4)), replace=False):
            port.beat(int(w))
            ref.beat(int(w))
        assert port.dead_workers() == ref.dead_workers()
        assert port.last_seen == ref.last_seen
    now[0] += 10.0
    assert port.dead_workers() == ref.dead_workers() == [0, 1, 2, 3, 4]


def test_straggler_monitor_flags_and_ewma_match():
    rng = np.random.default_rng(4)
    series = rng.uniform(0.8, 1.2, 200)
    series[rng.choice(200, 25, replace=False)] *= rng.uniform(2.0, 30.0, 25)
    for factor, alpha in ((3.0, 0.2), (1.5, 0.5)):
        port, ref = RT.StragglerMonitor(factor, alpha), jx_fault.StragglerMonitor(factor, alpha)
        for step, latency in enumerate(series):
            assert port.observe(step, float(latency)) == ref.observe(step, float(latency))
            assert port.ewma == ref.ewma
        assert port.flagged == ref.flagged and port.flagged


def _tree():
    rng = np.random.default_rng(5)
    return {
        "tiles": rng.standard_normal((2, 3, 4, 4)).astype(np.float32),
        "tile_row": rng.integers(0, 9, (2, 3)).astype(np.int32),
        "layers": [{"w": rng.standard_normal(5), "n": np.arange(4, dtype=np.int64)},
                   (torch.arange(3, dtype=torch.float32), np.array([True, False]))],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_reshard_tree_keeps_values_bitwise_on_a_cpu_mesh():
    tree = _tree()
    mesh = RT.make_mesh_any((1,), ("units",), device="cpu")
    assert mesh.shape == (1,) and mesh[0] == torch.device("cpu")
    keys = []
    placed = RT.reshard_tree(tree, mesh, lambda key, leaf: keys.append(key) or P())
    assert isinstance(placed["layers"][1], tuple) and isinstance(placed["layers"], list)
    for leaf, got in zip(_leaves(tree), _leaves(placed), strict=True):
        assert isinstance(got, Replicated) and len(got.shards) == 1
        want = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        back = np.asarray(got)
        assert back.dtype == want.dtype and np.array_equal(back, want)
    # A placed leaf is a copy: writing the host array leaves it as it was.
    before = np.asarray(placed["tiles"]).copy()
    tree["tiles"][...] = 0.0
    assert np.array_equal(np.asarray(placed["tiles"]), before)
    # The keys spec_fn sees are the JAX package's.
    jx_keys = []
    jx_elastic.reshard_tree(
        jax_leaves_only(_tree()), jx_elastic.make_mesh_any((1,), ("units",)),
        lambda key, leaf: jx_keys.append(key) or jx_elastic.P())
    assert sorted(keys) == sorted(jx_keys)


def jax_leaves_only(tree):
    """The same tree with torch leaves as numpy, for the JAX package."""
    if isinstance(tree, dict):
        return {k: jax_leaves_only(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_leaves_only(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def test_elastic_restart_restores_then_places():
    tree = _tree()

    class Manager:
        def __init__(self):
            self.asked = []

        def restore(self, template, step):
            self.asked.append((template, step))
            return tree, 7

    mgr = Manager()
    mesh = RT.make_mesh_any((1,), ("units",), device="cpu")
    placed, step = RT.elastic_restart(mgr, "template", mesh, lambda key, leaf: P(), step=3)
    assert step == 7 and mgr.asked == [("template", 3)]
    assert np.array_equal(np.asarray(placed["tiles"]), tree["tiles"])


def test_what_the_elastic_runtime_refuses():
    """A sharded spec on the one-device in-process mesh places the whole
    leaf, as JAX does on a one-device mesh; a spec that is not a
    PartitionSpec, or a mesh the devices cannot make, is refused."""
    mesh = RT.make_mesh_any((1,), ("units",), device="cpu")
    w = np.arange(4.0)
    placed = RT.reshard_tree({"w": w}, mesh, lambda key, leaf: P("units"))
    assert np.array_equal(np.asarray(placed["w"]), w)
    assert len(placed["w"].shards) == 1 and placed["w"].shards[0].shape == (4,)
    with pytest.raises(TypeError, match="PartitionSpec"):
        RT.reshard_tree({"w": np.zeros(4)}, mesh, lambda key, leaf: None)
    with pytest.raises(ValueError, match="needs 2 devices, 1 present"):
        RT.make_mesh_any((2,), ("units",), device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        RT.make_mesh_any((1,), ("a", "b"), device="cpu")
    assert P().replicated and P(None, None).replicated and not P("units").replicated
    assert local_devices("cpu") == [torch.device("cpu")]
