"""The port's encoder-decoder family (seamless-m4t-medium) against the JAX
package's, on the same weights (carried across with ``lm_from_numpy``)
and the same seeded numpy inputs: ``cross_attention``, ``encode``,
``encdec_forward`` and ``encdec_decode_step`` at 1e-5 of the largest
|output| each, the family through ``build`` at 1e-4 (bf16 at 2e-2);
the weights' tree through ``interop`` bitwise both ways, its stacked
leaves in the reference's order for the optimizer, int8 on JAX's noise
with one scale per stacked leaf, ``greedy_generate`` on frames, the LM
``ServeEngine`` failing on this family as the reference's does, and
``remat`` as the reference has it (``"full"`` recomputes the decoder,
``"dots"`` nothing)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models as ref_models
import repro.serve as ref_serve
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro.config import get_arch as ref_get_arch
from repro.models import attention as ref_attn
from repro.models import encdec as ref_encdec
from repro.optim import compress_int8 as ref_compress_int8
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig, get_arch
from repro_torch.models import Params, build, lm_from_numpy, lm_to_numpy
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models.common import stacked_groups
from repro_torch.models.interop import opt_from_numpy, opt_to_numpy
from repro_torch.optim import compress_int8, init_opt
from repro_torch.serve import Request, ServeEngine, greedy_generate
from repro_torch.train import loss_fn

ARCH = "seamless-m4t-medium"
MODULE_TOL = 1e-5  # max |port - ref| / max |ref|, one function, float32
FAMILY_TOL = 1e-4  # the same through build(cfg), forward and decode
TOL_BF16 = 2e-2  # max |port - ref| of the logits, tests/test_models_smoke.py:86
B, S, T = 2, 16, 8  # batch, decoder tokens, encoder frames


def _pair(**kw):
    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), **kw)
    ref_params = ref_models.build(ref_cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params)
    return (ref_cfg, ref_params), (cfg, lm_from_numpy(cfg, tree, device="cpu"))


def _batch(cfg, s=S, seed=0, b=B, t=T):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "frontend_embeds": rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)}


def _err(mine, ref, scaled=True):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    d = np.abs(mine.float().numpy() - ref).max()
    return d / np.abs(ref).max() if scaled else d


def _paths(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("s,t", [(16, 8), (1, 8), (5, 13)])
def test_cross_attention_matches_the_reference(s, t):
    """Grouped queries (4 heads over 2 kv heads) over S decoder states and
    T encoder states, S ≠ T and a single decode row included."""
    (ref_cfg, ref_params), (cfg, params) = _pair()
    rng = np.random.default_rng(s * 100 + t)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    lp = params["dec_layers"][1]["xattn"]
    ref_lp = jax.tree.map(lambda a: a[1], ref_params["dec_layers"]["xattn"])
    with torch.no_grad():
        out = attn_mod.cross_attention(lp, torch.as_tensor(x), torch.as_tensor(mem), cfg)
    ref = ref_attn.cross_attention(ref_lp, jnp.asarray(x), jnp.asarray(mem), ref_cfg)
    assert out.shape == ref.shape == (B, s, cfg.d_model)
    assert _err(out, ref) < MODULE_TOL


def test_encode_matches_the_reference():
    (ref_cfg, ref_params), (cfg, params) = _pair()
    frames = _batch(cfg)["frontend_embeds"]
    with torch.no_grad():
        mem = encdec.encode(params, frames, cfg)
    ref = ref_encdec.encode(ref_params, jnp.asarray(frames), ref_cfg)
    assert mem.shape == ref.shape == (B, T, cfg.d_model)
    assert _err(mem, ref) < MODULE_TOL


def test_encdec_forward_matches_the_reference():
    (ref_cfg, ref_params), (cfg, params) = _pair()
    batch = _batch(cfg)
    with torch.no_grad():
        logits, aux = encdec.encdec_forward(params, batch, cfg)
    ref_logits, ref_aux = ref_encdec.encdec_forward(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    assert logits.shape == ref_logits.shape == (B, S, cfg.vocab_size)
    assert _err(logits, ref_logits) < MODULE_TOL
    assert aux.dtype == torch.float32 and float(aux) == float(ref_aux) == 0.0


def test_encdec_decode_step_matches_the_reference():
    """Each step's logits, and the caches and memory after the last, on
    one state the port writes in place and the reference carries."""
    (ref_cfg, ref_params), (cfg, params) = _pair()
    batch = _batch(cfg)
    state = encdec.init_encdec_state(params, batch["frontend_embeds"], cfg, S)
    ref_state = ref_encdec.init_encdec_state(ref_params, jnp.asarray(batch["frontend_embeds"]),
                                             ref_cfg, S)
    assert _err(state.mem, ref_state.mem) < MODULE_TOL
    assert isinstance(state.pos, int) and state.pos == 0
    ref_step = jax.jit(lambda p, t, st: ref_encdec.encdec_decode_step(p, t, st, ref_cfg))
    for t in range(S):
        tok = batch["tokens"][:, t:t + 1]
        lg, state = encdec.encdec_decode_step(params, tok, state, cfg)
        ref_lg, ref_state = ref_step(ref_params, jnp.asarray(tok), ref_state)
        assert lg.shape == ref_lg.shape == (B, cfg.vocab_size)
        assert _err(lg, ref_lg) < MODULE_TOL, t
    assert state.pos == int(ref_state.pos) == S
    for name in ("mem", "kv_k", "kv_v"):
        mine, ref = getattr(state, name), getattr(ref_state, name)
        assert mine.shape == ref.shape, name
        assert _err(mine, ref) < MODULE_TOL, name


@pytest.mark.parametrize("dtype,tol,scaled", [("float32", FAMILY_TOL, True),
                                              ("bfloat16", TOL_BF16, False)])
def test_family_matches_the_reference(dtype, tol, scaled):
    """Through ``build``: the teacher-forced forward, then every decode
    step on a state from ``init_state``."""
    (ref_cfg, ref_params), (cfg, params) = _pair(dtype=dtype)
    model, ref_model = build(cfg), ref_models.build(ref_cfg)
    batch = _batch(cfg)
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    ref_logits, _ = ref_model.forward(ref_params, ref_batch)
    assert logits.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert _err(logits, ref_logits, scaled) < tol
    state = model.init_state(params, batch, max_len=S)
    ref_state = ref_model.init_state(ref_params, ref_batch, max_len=S)
    ref_step = jax.jit(ref_model.decode_step)
    for t in range(S):
        tok = batch["tokens"][:, t:t + 1]
        lg, state = model.decode_step(params, tok, state)
        ref_lg, ref_state = ref_step(ref_params, jnp.asarray(tok), ref_state)
        assert _err(lg, ref_lg, scaled) < tol, t


def test_build_init_is_deterministic_per_seed():
    cfg = get_arch(ARCH).reduced()
    model = build(cfg)
    a, b = (model.init(torch.Generator().manual_seed(3), device="cpu") for _ in range(2))
    c = model.init(torch.Generator().manual_seed(4), device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["dec_layers.0.xattn.wq"], pc["dec_layers.0.xattn.wq"])
    assert len(a["enc_layers"]) == cfg.encoder_layers and len(a["dec_layers"]) == cfg.num_layers
    assert not any(p.requires_grad for p in a.parameters())
    assert {n.split(".")[0] for n in pa} == {"embed", "enc_layers", "dec_layers", "enc_norm",
                                             "final_norm"}


def test_weights_and_moments_cross_through_interop_bitwise():
    """The reference's tree → the port → back, leaf for leaf; and the
    port's optimizer state likewise, with enc_layers and dec_layers
    stacked over their own layer counts."""
    (ref_cfg, ref_params), (cfg, params) = _pair()
    tree = _paths(jax.tree.map(np.asarray, ref_params))
    back = _paths(lm_to_numpy(params))
    assert back.keys() == tree.keys()
    for k in tree:
        assert back[k].dtype == tree[k].dtype and np.array_equal(back[k], tree[k]), k
    assert back["enc_layers/attn/wq"].shape[0] == cfg.encoder_layers
    assert back["dec_layers/xattn/wq"].shape[0] == cfg.num_layers
    rng = np.random.default_rng(2)
    moments = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                           jax.tree.map(np.asarray, ref_params))
    state = opt_from_numpy(cfg, (moments, moments, np.int32(5)), device="cpu")
    mu, nu, step = opt_to_numpy(state)
    assert step == np.int32(5) and type(step) is np.int32
    want = _paths(moments)
    for got in (_paths(mu), _paths(nu)):
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    bad = dict(jax.tree.map(np.asarray, ref_params))
    bad["enc_layers"] = jax.tree.map(lambda a: a[:1], bad["enc_layers"])
    with pytest.raises(ValueError, match=r"enc_layers\.attn\.w.: shape \(1, .* stack 2 layers"):
        lm_from_numpy(cfg, bad, device="cpu")


def test_stacked_groups_follow_the_reference_leaf_order():
    """The optimizer's leaves: enc_layers.N.* and dec_layers.N.* form one
    stacked leaf each, in ``jax.tree.leaves`` order."""
    (_, ref_params), (cfg, params) = _pair()
    groups = stacked_groups(n for n, _ in params.named_parameters())
    assert [k for k, _ in groups] == list(_paths(ref_params))
    named = dict(groups)
    assert named["enc_layers/norm1"] == [f"enc_layers.{i}.norm1"
                                         for i in range(cfg.encoder_layers)]
    assert named["dec_layers/xattn/wo"] == [f"dec_layers.{i}.xattn.wo"
                                            for i in range(cfg.num_layers)]
    assert named["enc_norm"] == ["enc_norm"]


def test_int8_on_jax_noise_is_the_reference_per_stacked_leaf():
    """The quantizer on JAX's own noise, bitwise the reference's; each
    decoder layer's gradient ten times the one before it, so a scale per
    block instead of per stacked leaf would show."""
    (_, ref_params), (cfg, _) = _pair()
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, ref_params))

    def by_layer(a):
        scale = np.float32(10.0) ** np.arange(a.shape[0], dtype=np.float32)
        return a * scale.reshape((-1,) + (1,) * (a.ndim - 1))

    grads["dec_layers"] = jax.tree.map(by_layer, grads["dec_layers"])
    key = jax.random.PRNGKey(7)
    ref = _paths(jax.tree.map(np.asarray, ref_compress_int8(jax.tree.map(jnp.asarray, grads), key)))
    leaves = _paths(grads)
    keys = jax.random.split(key, len(leaves))
    uniform = {k: np.asarray(jax.random.uniform(kk, a.shape, jnp.float32))
               for (k, a), kk in zip(leaves.items(), keys)}
    module = lm_from_numpy(cfg, grads, device="cpu")
    out = compress_int8(dict(module.named_parameters()), uniform=uniform)
    mine = _paths(lm_to_numpy(Params.map(module, lambda n, _: out[n])))
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_checkpoint_writes_the_reference_keys(tmp_path):
    (_, ref_params), (cfg, params) = _pair()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (params, init_opt(params)))
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as z:
        keys = set(z.files)
    want = {"0/" + k for k in _paths(ref_params)}
    assert want <= keys
    assert "0/enc_layers/attn/wq" in keys and "1/mu/dec_layers/xattn/wk" in keys
    (restored, _), _ = mgr.restore((build(cfg).init(torch.Generator().manual_seed(1),
                                                     device="cpu"), init_opt(params)))
    mine = dict(restored.named_parameters())
    assert all(torch.equal(w, mine[n]) for n, w in params.named_parameters())


def test_greedy_generate_on_frames_is_the_reference():
    (ref_cfg, ref_params), (cfg, params) = _pair()
    batch = _batch(cfg, s=6, seed=4)
    want = ref_serve.greedy_generate(ref_models.build(ref_cfg), ref_params, batch["tokens"], 5,
                                     frontend_embeds=batch["frontend_embeds"])
    got = greedy_generate(build(cfg), params, batch["tokens"], 5,
                          frontend_embeds=batch["frontend_embeds"])
    assert got.shape == (B, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_lm_serve_engine_fails_on_this_family_as_the_reference():
    """The engine's tokens-only wave has no frames: ``init_state`` raises
    ``KeyError: 'frontend_embeds'`` in both packages; the port invents
    none."""
    (ref_cfg, ref_params), (cfg, params) = _pair()
    prompt = np.arange(4, dtype=np.int32)
    ref_eng = ref_serve.ServeEngine(ref_models.build(ref_cfg), ref_params, batch_slots=2,
                                    max_len=16)
    eng = ServeEngine(build(cfg), params, batch_slots=2, max_len=16, device="cpu")
    for e, req in ((ref_eng, ref_serve.Request), (eng, Request)):
        e.submit(req(rid=0, prompt=prompt, max_new=3))
        with pytest.raises(KeyError, match="frontend_embeds"):
            e.run_until_drained()
    assert eng.state is None and eng.ticks == 0


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_the_decoder_blocks_only_for_full():
    """``"full"`` reruns each decoder block's products in the backward
    pass and never the encoder's; ``"dots"`` runs exactly ``"none"``'s
    ops, as the reference's enc-dec wraps its decoder for ``"full"``
    alone."""
    cfg = get_arch(ARCH).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
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
    assert counts["dots"] == counts["none"]
    # A decoder block's forward runs 11 projections (4 of attention, 4 of
    # cross-attention, 3 of the MLP); the recompute stops before the last,
    # whose output the backward does not need. An encoder block would add
    # 7 more each.
    assert counts["full"][mm] - counts["none"][mm] == 10 * cfg.num_layers
    assert counts["full"][bmm] > counts["none"][bmm]
    with pytest.raises(ValueError, match="remat='some'"):
        model.forward(params, batch, remat="some")
