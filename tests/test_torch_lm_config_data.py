"""The port's copies of ``config.py``, ``configs/`` and
``data/synthetic.py`` against the JAX package's: every architecture
config, shape and skip rule equal, and the synthetic token stream
bitwise the reference's for the same seeds, steps and shards."""
import dataclasses

import numpy as np
import pytest

import repro.config as ref_config
import repro.configs as ref_configs
import repro.data.synthetic as ref_data
import repro_torch.config as config
import repro_torch.configs as configs
import repro_torch.data.synthetic as data
from repro_torch.data import DataConfig, SyntheticStream


def test_arch_ids_in_the_same_order():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert sorted(config.list_archs()) == sorted(ref_config.list_archs())


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_arch_config_equals_the_reference(arch):
    mine, ref = config.get_arch(arch), ref_config.get_arch(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    assert mine.reduced().param_count() == ref.reduced().param_count()
    assert (mine.hd, mine.is_moe, mine.d_inner, mine.ssm_heads) == (
        ref.hd, ref.is_moe, ref.d_inner, ref.ssm_heads)


def test_shapes_and_skip_rules_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_config.SHAPES.items()}
    for arch in ref_configs.ARCH_IDS:
        for name in ref_config.SHAPES:
            assert config.shape_applicable(config.get_arch(arch), config.SHAPES[name]) == (
                ref_config.shape_applicable(ref_config.get_arch(arch), ref_config.SHAPES[name]))
    assert dataclasses.asdict(config.TrainConfig()) == dataclasses.asdict(ref_config.TrainConfig())


def test_registry_refuses_duplicates_and_unknown_names():
    with pytest.raises(ValueError, match="duplicate arch"):
        config.register_arch(config.get_arch("qwen3-1.7b"))
    with pytest.raises(KeyError, match="unknown arch"):
        config.get_arch("no-such-arch")


def test_paper_workload_equals_the_reference():
    from repro.configs import paper_pmvc as ref_paper
    from repro_torch.configs import paper_pmvc

    for name in ("MATRICES", "NODE_COUNTS", "CORES_PER_NODE", "COMBOS", "BLOCK", "BLOCK_TPU"):
        assert getattr(paper_pmvc, name) == getattr(ref_paper, name)


@pytest.mark.parametrize("seed,step,shards", [(0, 0, 1), (3, 5, 2), (7, 11, 4), (1, 2, 8)])
def test_batch_at_is_bitwise_the_reference(seed, step, shards):
    kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=seed, stickiness=0.8)
    for i in range(shards):
        mine = SyntheticStream(DataConfig(**kw), shard_index=i, num_shards=shards)
        ref = ref_data.SyntheticStream(ref_data.DataConfig(**kw), shard_index=i,
                                       num_shards=shards)
        np.testing.assert_array_equal(mine.succ, ref.succ)
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_iteration_and_the_deprecated_alias_match_the_reference():
    dc = dict(vocab_size=50, seq_len=12, global_batch=4, seed=9)
    mine = SyntheticStream(DataConfig(**dc), start_step=3)
    ref = ref_data.SyntheticStream(ref_data.DataConfig(**dc), start_step=3)
    for _ in range(3):
        np.testing.assert_array_equal(next(mine), next(ref))
    assert mine.step == ref.step == 6
    with pytest.warns(DeprecationWarning, match="batch_at"):
        np.testing.assert_array_equal(mine._batch_at(2), ref.batch_at(2))


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_make_batch_is_bitwise_the_reference(arch):
    mine_cfg, ref_cfg = config.get_arch(arch).reduced(), ref_config.get_arch(arch).reduced()
    mine_shape = config.ShapeConfig("tiny", 20, 3, "train")
    ref_shape = ref_config.ShapeConfig("tiny", 20, 3, "train")
    for kw in ({"seed": 0}, {"seed": 4, "step": 2, "batch_override": 2}):
        a = data.make_batch(mine_cfg, mine_shape, **kw)
        b = ref_data.make_batch(ref_cfg, ref_shape, **kw)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(data.frontend_stub(mine_cfg, 2, 5, seed=3),
                                  ref_data.frontend_stub(ref_cfg, 2, 5, seed=3))


# tests/test_data_optim.py's stream cases, on the port.


def test_stream_deterministic():
    dc = DataConfig(vocab_size=100, seq_len=32, global_batch=8, seed=3)
    a = next(SyntheticStream(dc))
    b = next(SyntheticStream(dc))
    np.testing.assert_array_equal(a, b)


def test_stream_shards_tile_the_global_batch():
    """Elasticity invariant: the union of shard batches == global batch,
    independent of shard count."""
    dc = DataConfig(vocab_size=100, seq_len=16, global_batch=8, seed=4)
    full = next(SyntheticStream(dc))
    for num_shards in (2, 4, 8):
        parts = [
            next(SyntheticStream(dc, shard_index=i, num_shards=num_shards))
            for i in range(num_shards)
        ]
        np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)


def test_stream_is_learnable_markov():
    dc = DataConfig(vocab_size=50, seq_len=256, global_batch=2, seed=5, stickiness=0.9)
    batch = next(SyntheticStream(dc))
    stream = SyntheticStream(dc)
    # ~90% of transitions follow the fixed successor permutation.
    succ = stream.succ
    follows = (batch[:, 1:] == succ[batch[:, :-1]]).mean()
    assert follows > 0.8
