"""The port's LM serving: every case of ``tests/test_serve.py`` on the
port, then the port's ``ServeEngine`` against the JAX package's on the
same weights and requests — the same tokens, ticks and completion order,
and each tick's logits within 1e-4 of the largest |logit|."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models as ref_models
import repro.serve as ref_serve
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.config import get_arch as ref_get_arch
from repro_torch.config import get_arch
from repro_torch.models import build, lm_from_numpy
from repro_torch.serve import Request, ServeEngine, greedy_generate

TOL = 1e-4  # max |port - ref| / max |ref| over one tick's logits, float32


@pytest.fixture(scope="module")
def small_model():
    cfg = get_arch("qwen3-1.7b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params


def test_greedy_generate_shapes(small_model):
    cfg, model, params = small_model
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    out = greedy_generate(model, params, prompts, max_new=4)
    assert out.shape == (3, 4)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()


def test_greedy_generate_deterministic(small_model):
    cfg, model, params = small_model
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    a = greedy_generate(model, params, prompts, max_new=3)
    b = greedy_generate(model, params, prompts, max_new=3)
    np.testing.assert_array_equal(a, b)


def test_engine_matches_greedy(small_model):
    """The batched engine must produce the same tokens as standalone
    greedy decoding for each request."""
    cfg, model, params = small_model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 5).astype(np.int32) for _ in range(3)]
    singles = [
        greedy_generate(model, params, p[None], max_new=4)[0] for p in prompts
    ]
    eng = ServeEngine(model, params, batch_slots=4, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=4))
    eng.run_until_drained()
    by_rid = {r.rid: r.out for r in eng.completed}
    for i in range(3):
        np.testing.assert_array_equal(np.array(by_rid[i]), singles[i])


def test_engine_multiple_waves(small_model):
    cfg, model, params = small_model
    rng = np.random.default_rng(3)
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu")
    for i in range(5):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 3 + i).astype(np.int32), max_new=2))
    eng.run_until_drained()
    assert len(eng.completed) == 5
    assert all(len(r.out) == 2 for r in eng.completed)


def test_engine_ssm_family():
    cfg = get_arch("mamba2-2.7b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu")
    rng = np.random.default_rng(4)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 4).astype(np.int32), max_new=3))
    eng.run_until_drained()
    assert len(eng.completed) == 3


def test_engine_empty_queue_step_is_noop(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu")
    eng.step()
    eng.step()
    assert eng.ticks == 0  # no admitted wave -> no decode work, no tick
    assert eng.completed == []
    assert eng.state is None  # no cache was ever allocated


def test_engine_slot_reuse_across_waves(small_model):
    """5 requests through 2 slots = 3 waves; slot state resets between
    waves so late requests decode exactly like a fresh single run."""
    cfg, model, params = small_model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 4).astype(np.int32) for _ in range(5)]
    singles = [
        greedy_generate(model, params, p[None], max_new=3)[0] for p in prompts
    ]
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=3))
    eng.run_until_drained()
    assert len(eng.completed) == 5
    by_rid = {r.rid: r.out for r in eng.completed}
    for i in range(5):
        np.testing.assert_array_equal(np.array(by_rid[i]), singles[i])


def test_engine_run_until_drained_guard(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, batch_slots=1, max_len=64, device="cpu")
    eng.submit(
        Request(
            rid=0,
            prompt=np.zeros(4, np.int32),
            max_new=40,  # 4 prompt + 40 decode ticks > the max_ticks cap
        )
    )
    with pytest.raises(RuntimeError, match="did not drain"):
        eng.run_until_drained(max_ticks=10)
    eng.run_until_drained()  # recoverable: the same wave can finish later
    assert len(eng.completed) == 1


def test_engine_unequal_prompt_lengths_one_wave(small_model):
    """Slots with different prompt lengths coexist in one wave: the
    short prompt starts generating while the long one is still feeding,
    and both match their standalone decodes."""
    cfg, model, params = small_model
    rng = np.random.default_rng(6)
    short = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    long = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    want = [
        greedy_generate(model, params, p[None], max_new=3)[0]
        for p in (short, long)
    ]
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=short, max_new=3))
    eng.submit(Request(rid=1, prompt=long, max_new=3))
    eng.run_until_drained()
    by_rid = {r.rid: r.out for r in eng.completed}
    np.testing.assert_array_equal(np.array(by_rid[0]), want[0])
    np.testing.assert_array_equal(np.array(by_rid[1]), want[1])
    # One wave, governed by the longest slot: the tick feeding its last
    # prompt token already yields the first generated token, so the
    # wave costs prompt + max_new - 1 ticks.
    assert eng.ticks == 9 + 3 - 1


def test_engine_refuses_weights_on_another_device(small_model):
    _, model, params = small_model
    with pytest.raises(ValueError, match="weights are on cpu"):
        ServeEngine(model, params, device="meta")


# The port's engine against the JAX package's.


def _requests(vocab, lengths, max_new, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


@pytest.mark.parametrize("arch,slots,lengths,max_new", [
    ("qwen3-1.7b", 2, (3, 7, 2, 5, 4), (4, 2, 5, 3, 3)),  # three waves, unequal prompts
    ("h2o-danube-1.8b", 3, (12, 20, 9), (8, 5, 10)),  # the ring of 17 slots wraps
    ("hymba-1.5b", 2, (6, 3, 8), (3, 4, 2)),
    ("mamba2-2.7b", 2, (5, 2, 4), (3, 3, 4)),
])
def test_engine_matches_the_jax_engine(arch, slots, lengths, max_new):
    ref_cfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    ref_model = ref_models.build(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    model = build(cfg)
    params = lm_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")

    ticks, ref_ticks = [], []

    def recording(p, t, st, ctx=None):
        logits, st = model.decode_step(p, t, st, ctx)
        ticks.append(logits.numpy().copy())
        return logits, st

    eng = ServeEngine(dataclasses.replace(model, decode_step=recording), params,
                      batch_slots=slots, max_len=48, device="cpu")
    ref_eng = ref_serve.ServeEngine(ref_model, ref_params, batch_slots=slots, max_len=48)
    jitted = ref_eng._step

    def ref_recording(p, t, st):
        logits, st = jitted(p, t, st)
        ref_ticks.append(np.asarray(logits))
        return logits, st

    ref_eng._step = ref_recording
    for rid, prompt, m in _requests(cfg.vocab_size, lengths, max_new, seed=8):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=m))
        ref_eng.submit(ref_serve.Request(rid=rid, prompt=prompt, max_new=m))
    eng.run_until_drained()
    ref_eng.run_until_drained()

    assert eng.ticks == ref_eng.ticks == len(ticks) == len(ref_ticks)
    for i, (a, b) in enumerate(zip(ticks, ref_ticks)):
        assert np.abs(a - b).max() / np.abs(b).max() < TOL, i
    assert [r.rid for r in eng.completed] == [r.rid for r in ref_eng.completed]
    for r, ref_r in zip(eng.completed, ref_eng.completed):
        assert r.out == ref_r.out, r.rid


def test_greedy_generate_matches_the_jax_package():
    ref_cfg, cfg = ref_get_arch("granite-8b").reduced(), get_arch("granite-8b").reduced()
    ref_model = ref_models.build(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(9))
    params = lm_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    out = greedy_generate(build(cfg), params, prompts, max_new=5)
    ref = ref_serve.greedy_generate(ref_model, ref_params, prompts, max_new=5)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(ref))
