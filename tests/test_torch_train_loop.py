"""The port's training loop: every case of ``tests/test_train_loop.py`` on
the port (loss decreases, fault recovery counts, bit-exact resume,
microbatch equivalence is in ``test_torch_train_step.py``, the straggler
monitor), the caller's weights left as they were, and the two packages'
loops on the same weights and data: losses within 1e-4 over 10 steps,
with a restart in each."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models as ref_models
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.runtime import FaultInjector as RefFaultInjector
from repro.train import TrainLoop as RefTrainLoop
from repro.train import make_train_step as ref_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig, get_arch
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import build, lm_from_numpy
from repro_torch.runtime import FaultInjector
from repro_torch.train import TrainLoop, make_train_step

LOSS_TOL = 1e-4  # |port - ref| / |ref| of each step's loss


def _setup(tmp_path=None, steps=10, ckpt_every=4, micro=1, arch="qwen3-1.7b"):
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tc = TrainConfig(
        total_steps=steps, warmup_steps=2, checkpoint_every=ckpt_every,
        learning_rate=1e-2, microbatches=micro,
    )
    step_fn = make_train_step(model, tc)
    dc = DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=0)

    def batch_fn(s):
        return {"tokens": SyntheticStream(dc, start_step=s).batch_at(s)}

    ckpt = CheckpointManager(str(tmp_path), keep=3) if tmp_path else None
    return params, tc, step_fn, batch_fn, ckpt


def test_loss_decreases(tmp_path):
    params, tc, step_fn, batch_fn, _ = _setup(steps=15)
    loop = TrainLoop(step_fn, batch_fn, tc)
    res = loop.run(params, num_steps=15)
    losses = [h["loss"] for h in res.metrics_history]
    assert losses[-1] < losses[0]
    assert res.final_step == 15


def test_fault_recovery_counts(tmp_path):
    params, tc, step_fn, batch_fn, ckpt = _setup(tmp_path, steps=12)
    faults = FaultInjector(schedule={6: 1, 9: 0})
    loop = TrainLoop(step_fn, batch_fn, tc, ckpt=ckpt, fault_injector=faults)
    res = loop.run(params, num_steps=12)
    assert res.restarts == 2
    assert res.final_step == 12
    assert ckpt.latest_step() == 12


def test_resume_is_bit_exact(tmp_path):
    """A run interrupted by a failure must end in exactly the state of an
    uninterrupted run (the data stream is a pure function of step and the
    checkpoint restores params+opt bit-for-bit)."""
    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        p0, tc, step_fn, batch_fn, _ = _setup(tmp_path / arch / "a", steps=8, ckpt_every=2,
                                              arch=arch)
        ckpt_a = CheckpointManager(str(tmp_path / arch / "a"), keep=10)
        loop_a = TrainLoop(step_fn, batch_fn, tc, ckpt=ckpt_a)
        res_a = loop_a.run(p0, num_steps=8)

        ckpt_b = CheckpointManager(str(tmp_path / arch / "b"), keep=10)
        faults = FaultInjector(schedule={5: 0})
        loop_b = TrainLoop(step_fn, batch_fn, tc, ckpt=ckpt_b, fault_injector=faults)
        res_b = loop_b.run(p0, num_steps=8)
        assert res_b.restarts == 1

        for a, b in zip(res_a.params.parameters(), res_b.params.parameters()):
            assert torch.equal(a, b), arch
        for a, b in zip(res_a.opt_state.mu.parameters(), res_b.opt_state.mu.parameters()):
            assert torch.equal(a, b), arch
        assert res_a.opt_state.step == res_b.opt_state.step == 8


def test_run_leaves_the_callers_weights_as_they_were():
    params, tc, step_fn, batch_fn, _ = _setup(steps=3)
    before = params.map(lambda _, w: w.clone())
    res = TrainLoop(step_fn, batch_fn, tc).run(params, num_steps=3)
    for a, b in zip(before.parameters(), params.parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(params.parameters(),
                                                     res.params.parameters()))


def test_straggler_monitor_flags():
    from repro_torch.runtime.fault import StragglerMonitor

    mon = StragglerMonitor(factor=3.0)
    for _ in range(5):
        mon.observe(0, 0.1)
    assert mon.observe(6, 1.0) is True
    assert 6 in mon.flagged
    assert mon.observe(7, 0.11) is False


def test_loops_match_the_reference(tmp_path):
    """The same weights and stream through both packages' loops, each with
    a checkpoint cadence and a failure at step 6: every step's loss within
    LOSS_TOL, the same restarts and history length."""
    arch = "granite-moe-1b-a400m"
    kw = dict(total_steps=10, warmup_steps=2, checkpoint_every=4, learning_rate=1e-2)
    ref_cfg = ref_get_arch(arch).reduced()
    ref_model = ref_models.build(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = get_arch(arch).reduced()
    params = lm_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    dc = DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=0)

    def batch_fn(s):
        return {"tokens": SyntheticStream(dc, start_step=s).batch_at(s)}

    ref_tc = RefTrainConfig(**kw)
    ref_loop = RefTrainLoop(
        jax.jit(ref_make_train_step(ref_model, ref_tc)),
        lambda s: {k: jnp.asarray(v) for k, v in batch_fn(s).items()}, ref_tc,
        ckpt=RefCheckpointManager(str(tmp_path / "ref")), fault_injector=RefFaultInjector({6: 0}))
    ref_res = ref_loop.run(ref_params, num_steps=10)
    tc = TrainConfig(**kw)
    loop = TrainLoop(make_train_step(build(cfg), tc), batch_fn, tc,
                     ckpt=CheckpointManager(str(tmp_path / "port")),
                     fault_injector=FaultInjector({6: 0}))
    res = loop.run(params, num_steps=10)
    assert res.restarts == ref_res.restarts == 1
    assert len(res.metrics_history) == len(ref_res.metrics_history)
    for h, ref_h in zip(res.metrics_history, ref_res.metrics_history):
        assert h["step"] == ref_h["step"]
        assert abs(h["loss"] - ref_h["loss"]) <= LOSS_TOL * abs(ref_h["loss"]), h["step"]
        # Within 1e-6: jitted, XLA rewrites the schedule's arithmetic, and
        # the reference's step then differs from its own eager cosine_lr
        # (which the port equals, test_torch_optim.py) by an ulp or two at
        # about a third of the steps.
        assert abs(h["lr"] - ref_h["lr"]) <= 1e-6 * ref_h["lr"], h["step"]
    assert res.metrics_history[-1]["loss"] < res.metrics_history[0]["loss"]
