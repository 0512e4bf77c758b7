"""The port's train step against the JAX package's, on the same weights
(carried across with ``lm_from_numpy``) and the same numpy batches:
``loss_fn`` and its gradients family by family (loss within 1e-5
relative, each gradient leaf within 1e-4 of that leaf's max |g|), the
remat modes bitwise equal to ``"none"`` within the port (and ``"dots"``
saving exactly the products without a batch dimension), two microbatches
against the JAX step (a batch whose rows do not split refused by both),
and ``tests/test_models_smoke.py``'s train step on every family."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models as ref_models
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.configs import ARCH_IDS
from repro.optim import init_opt as ref_init_opt
from repro.train import loss_fn as ref_loss_fn
from repro.train import make_train_step as ref_make_train_step
from repro_torch.config import TrainConfig, get_arch
from repro_torch.models import build, lm_from_numpy, lm_to_numpy
from repro_torch.models.interop import opt_to_numpy
from repro_torch.optim import init_opt
from repro_torch.train import loss_fn, make_train_step
from repro_torch.train.step import value_and_grad

LOSS_TOL = 1e-5  # |port - ref| / |ref|
GRAD_TOL = 1e-4  # max |port - ref| / max |ref|, per gradient leaf
B = 2

# (arch, sequence length, config changes): every family; h2o's 40
# positions reach past its window of 16, hymba's 24 past its SWA window;
# granite-8b with an untied head over a padded vocabulary, hymba through
# the chunked online softmax; seamless with 8 frames.
FAMILIES = [
    ("qwen3-1.7b", 16, {}),
    ("h2o-danube-1.8b", 40, {}),
    ("mamba2-2.7b", 16, {}),
    ("hymba-1.5b", 24, {}),
    ("llava-next-34b", 16, {}),
    ("granite-moe-1b-a400m", 16, {}),
    ("moonshot-v1-16b-a3b", 16, {"moe_sort_dispatch": True}),
    ("granite-8b", 16, {"tie_embeddings": False, "vocab_pad_to": 96}),
    ("hymba-1.5b", 24, {"chunked_attn": True, "attn_chunk": 8}),
    ("seamless-m4t-medium", 16, {}),
]


def _batch(cfg, s, seed=0, b=B):
    batch = {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = np.random.default_rng(seed + 1).standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32)
    return batch


def _pair(arch, **kw):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    ref_model = ref_models.build(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = lm_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return (ref_model, ref_params), (build(cfg), params)


def _paths(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grad_tree(params, grads):
    return _paths(lm_to_numpy(params.map(lambda n, _: grads[n])))


def _leaf_errs(mine, ref):
    assert mine.keys() == ref.keys()
    return {k: float(np.abs(mine[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
            for k in ref}


@pytest.mark.parametrize("arch,s,kw", FAMILIES)
def test_loss_and_gradients_match_the_reference(arch, s, kw):
    (ref_model, ref_params), (model, params) = _pair(arch, **kw)
    batch = _batch(model.cfg, s)
    tc, ref_tc = TrainConfig(), RefTrainConfig()
    loss, metrics, grads = value_and_grad(model, params, batch, None, tc)
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(ref_model, p, ref_batch, None, ref_tc), has_aux=True))(ref_params)
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL * abs(float(ref_loss))
    for k in ("ce", "aux"):
        assert abs(float(metrics[k]) - float(ref_metrics[k])) <= LOSS_TOL * max(
            abs(float(ref_metrics[k])), 1e-30), k
    assert (float(metrics["aux"]) > 0) == model.cfg.is_moe
    errs = _leaf_errs(_grad_tree(params, grads), _paths(jax.tree.map(np.asarray, ref_grads)))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert not any(w.requires_grad for w in params.parameters())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m", "seamless-m4t-medium"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_match_the_reference(arch, remat):
    (ref_model, ref_params), (model, params) = _pair(arch)
    batch = _batch(model.cfg, 16)
    _, _, grads = value_and_grad(model, params, batch, None, TrainConfig(remat=remat))
    ref_tc = RefTrainConfig(remat=remat)
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(ref_model, p, ref_batch, None, ref_tc), has_aux=True))(ref_params)
    errs = _leaf_errs(_grad_tree(params, grads), _paths(jax.tree.map(np.asarray, ref_grads)))
    assert max(errs.values()) <= GRAD_TOL


@pytest.mark.parametrize("arch,s", [("qwen3-1.7b", 16), ("granite-moe-1b-a400m", 16),
                                    ("mamba2-2.7b", 16), ("hymba-1.5b", 24),
                                    ("seamless-m4t-medium", 16)])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bitwise_none(arch, s, remat):
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, s)
    loss, metrics, grads = value_and_grad(model, params, batch, None, TrainConfig())
    loss_r, metrics_r, grads_r = value_and_grad(model, params, batch, None,
                                                TrainConfig(remat=remat))
    assert torch.equal(loss, loss_r) and torch.equal(metrics["aux"], metrics_r["aux"])
    for n in grads:
        assert torch.equal(grads[n], grads_r[n]), n


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m", "hymba-1.5b"])
def test_dots_recomputes_all_but_the_projections(arch):
    """The backward pass under "dots" runs no projection again (its aten.mm
    calls are the gradient products of "none"), and recomputes the
    batched products (aten.bmm) as "full" does."""
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, 24 if cfg.family == "hybrid" else 16)
    counts = {}
    for remat in ("none", "full", "dots"):
        with torch.enable_grad():
            for w in params.parameters():
                w.requires_grad_(True)
            loss, _ = loss_fn(model, params, batch, None, TrainConfig(remat=remat))
            with _CountOps() as mode:
                torch.autograd.grad(loss, list(params.parameters()))
            for w in params.parameters():
                w.requires_grad_(False)
        counts[remat] = mode.counts
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"].get(mm) == counts["none"].get(mm)
    assert counts["full"].get(mm) > counts["none"].get(mm)
    assert counts["dots"].get(bmm) == counts["full"].get(bmm) > counts["none"].get(bmm)


def test_unknown_remat_is_refused():
    cfg = get_arch("qwen3-1.7b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="remat='some'"):
        model.forward(params, _batch(cfg, 8), remat="some")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m", "seamless-m4t-medium"])
def test_microbatches_match_the_reference_step(arch):
    """Two microbatches through the port's step and the JAX step (the
    frames of seamless split with the tokens): the
    loss and gradient norm within 1e-5, the moments (linear and quadratic
    in the accumulated gradient) within 1e-4 of each leaf's max, the
    weights within tests/test_train_loop.py's microbatch tolerance."""
    (ref_model, ref_params), (model, params) = _pair(arch)
    batch = _batch(model.cfg, 32, seed=3, b=4)
    kw = dict(total_steps=10, warmup_steps=0, microbatches=2, learning_rate=1e-3)
    step = make_train_step(model, TrainConfig(**kw))
    params, state, metrics = step(params, init_opt(params), batch)
    ref_step = jax.jit(ref_make_train_step(ref_model, RefTrainConfig(**kw)))
    ref_params, ref_state, ref_metrics = ref_step(
        ref_params, ref_init_opt(ref_params), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(4))
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(metrics[k]) - float(ref_metrics[k])) <= LOSS_TOL * abs(
            float(ref_metrics[k])), k
    assert float(metrics["aux"]) == float(ref_metrics["aux"]) == 0.0
    mu, nu, _ = opt_to_numpy(state)
    for mine, ref in ((mu, ref_state.mu), (nu, ref_state.nu)):
        errs = _leaf_errs(_paths(mine), _paths(jax.tree.map(np.asarray, ref)))
        assert max(errs.values()) <= GRAD_TOL
    mine, ref = _paths(lm_to_numpy(params)), _paths(jax.tree.map(np.asarray, ref_params))
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=2e-2, atol=2e-4, err_msg=k)


def test_microbatch_equivalence():
    """tests/test_train_loop.py: gradient accumulation (2 microbatches) ~=
    full-batch step, on the port."""
    cfg = get_arch("qwen3-1.7b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 32))}
    tc1 = TrainConfig(total_steps=10, warmup_steps=0, microbatches=1, learning_rate=1e-3)
    tc2 = TrainConfig(total_steps=10, warmup_steps=0, microbatches=2, learning_rate=1e-3)
    p1, p2 = (params.map(lambda _, w: w.clone()) for _ in range(2))
    p1, _, m1 = make_train_step(model, tc1)(p1, init_opt(p1), batch)
    p2, _, m2 = make_train_step(model, tc2)(p2, init_opt(p2), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    for a, b in zip(p1.parameters(), p2.parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-4)


# tests/test_models_smoke.py's train step on the port: every family.


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_no_nans(arch):
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    before = params.map(lambda _, w: w.clone())
    tc = TrainConfig(total_steps=10, warmup_steps=1)
    step = make_train_step(model, tc)
    params2, _, metrics = step(params, init_opt(params), _batch(cfg, 16),
                               torch.Generator().manual_seed(1))
    assert float(metrics["loss"]) > 0
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    # params actually moved
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(before.parameters(), params2.parameters())]
    assert max(moved) > 0


@pytest.mark.parametrize("rows,refused", [(5, True), (4, False)])
def test_uneven_microbatches_are_refused_before_any_work(rows, refused):
    """microbatches=2 over a rows x 16 batch: 5 rows are refused by both
    packages (the reference's reshape raises TypeError, the port a
    ValueError before any forward, the weights untouched); 4 rows give
    the loss and gradients of the two halves, each through the step's
    own value_and_grad."""
    (ref_model, ref_params), (model, params) = _pair("qwen3-1.7b")
    batch = _batch(model.cfg, 16, seed=5, b=rows)
    kw = dict(total_steps=10, warmup_steps=0, microbatches=2, learning_rate=1e-3)
    forwards = []

    def counted(*args, **kwargs):
        forwards.append(1)
        return model.forward(*args, **kwargs)

    spy = dataclasses.replace(model, forward=counted)
    before = params.map(lambda _, w: w.clone())
    step = make_train_step(spy, TrainConfig(**kw))
    if refused:
        ref_step = ref_make_train_step(ref_model, RefTrainConfig(**kw))
        with pytest.raises(TypeError):
            ref_step(ref_params, ref_init_opt(ref_params),
                     {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(4))
        with pytest.raises(ValueError, match="tokens has 5"):
            step(params, init_opt(params), batch)
        assert forwards == []
        assert all(torch.equal(a, b) for a, b in zip(before.parameters(), params.parameters()))
        return
    halves = [value_and_grad(model, before, {k: v[i:i + 2] for k, v in batch.items()}, None,
                             TrainConfig(**kw)) for i in (0, 2)]
    _, _, metrics = step(params, init_opt(params), batch)
    assert len(forwards) == 2
    two = torch.tensor(2.0)
    assert torch.equal(metrics["loss"], (halves[0][0] + halves[1][0]) / two)
    norm = torch.sqrt(sum(((halves[0][2][n].float() + halves[1][2][n].float()) / two)
                          .double().square().sum() for n in halves[0][2]))
    assert abs(float(metrics["grad_norm"]) - float(norm)) <= 1e-6 * float(norm)


def test_deterministic_blocks_nest_and_overlap_across_threads():
    """Nested blocks, and blocks of two threads that overlap in either
    order, keep the mode on until the last one leaves, then restore what
    the first one found (warn-only included)."""
    import threading

    from repro_torch.train.step import deterministic

    def mode():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())

    before = mode()
    try:
        for found in ((False, False), (True, True)):
            torch.use_deterministic_algorithms(found[0], warn_only=found[1])
            with deterministic():
                with deterministic():
                    assert mode() == (True, False)
                assert mode() == (True, False)
            assert mode() == found
            for first_out in ("main", "worker"):
                entered, release, left = (threading.Event() for _ in range(3))
                seen = []

                def worker():
                    with deterministic():
                        entered.set()
                        release.wait(10)
                        seen.append(mode())
                    left.set()

                t = threading.Thread(target=worker)
                with deterministic():
                    t.start()
                    assert entered.wait(10)
                    if first_out == "worker":
                        release.set()
                        assert left.wait(10)
                    seen.append(mode())
                if first_out == "main":
                    seen.append(mode())  # the worker is still inside its block
                    release.set()
                t.join(10)
                assert all(m == (True, False) for m in seen), seen
                assert mode() == found
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def test_deterministic_holds_under_many_threads():
    """32 threads enter and leave ``deterministic()`` 100 times each with
    a short switch interval: every block sees the mode on, and the mode
    found before is back after the last one leaves."""
    import sys
    import threading

    from repro_torch.train.step import deterministic

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    off = []

    def worker():
        for _ in range(100):
            with deterministic():
                if not torch.are_deterministic_algorithms_enabled():
                    off.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert off == []
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) == before
