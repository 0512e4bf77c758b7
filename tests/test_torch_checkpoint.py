"""The port's checkpoint manager: every case of ``tests/test_checkpoint.py``
on the port's trees, then checkpoints crossing between the packages both
ways — a JAX ``(params, OptState)`` of a reduced language model restored
by the port, and the port's restored by the JAX package, bitwise, with
the same keys, shapes and types in ``arrays.npz`` and ``meta.json``."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models as ref_models
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.checkpoint import flatten_tree as ref_flatten_tree
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.optim import init_opt as ref_init_opt
from repro.optim import opt_update as ref_opt_update
from repro_torch.checkpoint import CheckpointManager, flatten_tree, unflatten_tree
from repro_torch.config import get_arch
from repro_torch.models import build, lm_from_numpy, lm_to_numpy
from repro_torch.models.interop import opt_from_numpy, opt_to_numpy
from repro_torch.optim import OptState, init_opt


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((8, 16), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.tensor(3.5)},
        "tuple": (torch.ones((3,)), torch.zeros((2, 2), dtype=torch.bfloat16)),
    }


def _leaves(tree):
    return [np.asarray(v, np.float32) for v in flatten_tree(tree).values()]


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(5, tree)
    restored, step = mgr.restore(tree)
    assert step == 5
    for a, b in zip(_leaves(tree), _leaves(restored)):
        np.testing.assert_array_equal(a, b)
    assert restored["tuple"][1].dtype == torch.bfloat16
    assert restored["nested"]["b"].dtype == torch.int32


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(7, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore(tree)
    assert torch.equal(tree["a"], restored["a"])


def test_tmp_dirs_never_committed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    # A stale tmp dir (e.g. crash mid-write) must be invisible.
    os.makedirs(str(tmp_path / "step_000000099.tmp"))
    assert mgr.all_steps() == [1]


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((4, 4))})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones((8, 8))})


def test_missing_key_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((4,))})
    with pytest.raises(KeyError):
        mgr.restore({"w": torch.ones((4,)), "extra": torch.ones((2,))})


def test_flatten_unflatten_inverse():
    tree = _tree(3)
    flat = flatten_tree(tree)
    back = unflatten_tree(tree, flat)
    for a, b in zip(_leaves(tree), _leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_async_save_copies_before_the_next_update(tmp_path):
    """The step updates weights in place: an async save must write the
    values of the moment it was called."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones((64, 64))
    mgr.save(1, {"w": w}, blocking=False)
    w.mul_(3.0)
    restored, _ = mgr.restore({"w": w})
    assert torch.equal(restored["w"], torch.ones((64, 64)))


# Across packages: a reduced LM's (params, opt_state) after two AdamW
# steps, so the moments and the step are not their initial values.


def _jax_state(arch, dtype="float32"):
    import dataclasses

    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), dtype=dtype)
    params = ref_models.build(ref_cfg).init(jax.random.PRNGKey(0))
    opt = ref_init_opt(params)
    tc = RefTrainConfig(warmup_steps=0, learning_rate=1e-2)
    for i in range(2):
        grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01 * (i + 1), p.dtype), params)
        params, opt, _ = ref_opt_update(params, grads, opt, tc)
    return params, opt


def _port_cfg(arch, dtype):
    import dataclasses

    return dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)


def _template(cfg):
    params = build(cfg).init(torch.Generator().manual_seed(9), device="cpu")
    return params, init_opt(params)


@pytest.mark.parametrize("arch,dtype", [("qwen3-1.7b", "float32"), ("hymba-1.5b", "float32"),
                                        ("granite-moe-1b-a400m", "float32"),
                                        ("granite-moe-1b-a400m", "bfloat16"),
                                        ("seamless-m4t-medium", "float32")])
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch, dtype):
    params, opt = _jax_state(arch, dtype)
    RefCheckpointManager(str(tmp_path)).save(2, (params, opt))
    cfg = _port_cfg(arch, dtype)
    (p, o), step = CheckpointManager(str(tmp_path)).restore(_template(cfg))
    assert step == 2 and isinstance(o, OptState) and o.step == np.int32(2)
    assert type(o.step) is np.int32
    want = ref_flatten_tree((params, opt))
    got = flatten_tree((p, o))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert p["embed"].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert p["layers"][0]["moe"]["router"].dtype == torch.float32 if cfg.is_moe else True


@pytest.mark.parametrize("arch,dtype", [("qwen3-1.7b", "float32"),
                                        ("granite-moe-1b-a400m", "bfloat16"),
                                        ("seamless-m4t-medium", "float32")])
def test_port_checkpoint_restores_in_jax(tmp_path, arch, dtype):
    params, opt = _jax_state(arch, dtype)
    cfg = _port_cfg(arch, dtype)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    p = lm_from_numpy(cfg, tree, device="cpu")
    o = opt_from_numpy(cfg, jax.tree.map(np.asarray, opt), device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, (p, o), extra={"arch": arch})
    (rp, ro), step = RefCheckpointManager(str(tmp_path)).restore((params, opt))
    assert step == 2 and int(ro.step) == 2 and ro.step.dtype == jnp.int32
    for a, b in zip(jax.tree.leaves((params, opt)), jax.tree.leaves((rp, ro))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    with open(tmp_path / "step_000000002" / "meta.json") as f:
        assert json.load(f) == {"step": 2, "extra": {"arch": arch}}
    # The port's own round trip keeps the bf16 weights' bits.
    (p2, o2), _ = mgr.restore((p, o))
    for a, b in zip(p.parameters(), p2.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(lm_to_numpy(o2.mu)["embed"], lm_to_numpy(o.mu)["embed"])


def test_optimizer_state_crosses_through_numpy():
    params, opt = _jax_state("hymba-1.5b")
    cfg = get_arch("hymba-1.5b").reduced()
    o = opt_from_numpy(cfg, jax.tree.map(np.asarray, opt), device="cpu")
    mu, nu, step = opt_to_numpy(o)
    assert step == np.int32(2)
    for mine, ref in ((mu, opt.mu), (nu, opt.nu)):
        flat_mine = flatten_tree(mine)
        flat_ref = ref_flatten_tree(ref)
        assert flat_mine.keys() == flat_ref.keys()
        for k in flat_ref:
            np.testing.assert_array_equal(flat_mine[k], flat_ref[k], err_msg=k)


def test_bf16_is_stored_as_float32(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)})
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as z:
        assert z["w"].dtype == np.float32
    ref = RefCheckpointManager(str(tmp_path)).restore(
        {"w": jnp.zeros((2,), jnp.bfloat16)})[0]["w"]
    assert ref.dtype == ml_dtypes.bfloat16
