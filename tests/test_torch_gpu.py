"""The port on the card: each CUDA kernel (Block-ELL SpMM, grouped matmul,
flash attention) against its plain version, two launches bitwise equal
and the launch counter rising, a small session end to end against the
float64 oracle, the single-shard entry points, the serving engine
bitwise its direct solves, and the plan store: save → load bitwise with
the first spmv of a lazy load on ``stream``, a patched spmv bitwise the
cold pack, and a load with no device given taking the card. Then the
engine killed at each fault point, bitwise its uninterrupted run, and
the ``shard_map`` executor on an NCCL group of one rank, within 1e-5 of
the oracle on the golden schedule, and both executors inside the train
step's deterministic mode, bitwise the same calls outside it. Last, the language models: each
family's forward and decode steps on the card within 1e-5 of the CPU's
on the same weights, and the LM engine's tokens bitwise
``greedy_generate``'s on the same batch. Last, training: one step's
loss and gradients on the card against the CPU's, the step
deterministic (two runs bitwise equal), and a loop resumed after a
failure bitwise the uninterrupted one.

Marked ``gpu``; each test asks a fixture for the card and skips without
one. The file imports no JAX, so it also runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.api import (
    STEPPERS,
    SparseDelta,
    SparseSession,
    Topology,
    distribute,
    load_session,
)
from repro_torch.analysis import (
    audit_session,
    golden_signature,
    schedule_signature,
    trace_pmvc_step,
)
import repro_torch.api.solvers as solvers
from repro_torch import trace
from repro_torch.api.exchange import resolve_exchange
from repro_torch.config import get_arch
from repro_torch.core.nezgt import nezgt_partition
from repro_torch.kernels.attn import attention_plain, attention_variant, flash_attention, mha
from repro_torch.kernels.gmm import gmm_plain, gmm_variant, grouped_matmul, plan_groups
from repro_torch.kernels.spmv import (
    bell_spmm,
    bell_spmm_plain,
    bell_tiles,
    pack_inputs,
    spmm_shard,
    spmm_shard_ref,
    spmm_variant,
    spmv_shard,
)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import build, lm_from_numpy, lm_to_numpy
from repro_torch.optim import init_opt
from repro_torch.train import TrainLoop, make_train_step
from repro_torch.train.step import value_and_grad
from repro_torch.pmvc.dist import (Communicator, LocalCommunicator, hoist_tiles, make_pmvc_step,
                                   make_unit_mesh, pad_x)
from repro_torch.pmvc.plan_device import pack_units
from repro_torch.runtime import FaultInjector
from repro_torch.serve import Request, ServeEngine, SparseServeEngine, Status, greedy_generate
from repro_torch.sparse.bell import pack_bell, tile_counts
from repro_torch.sparse.formats import COO
from repro_torch.sparse.generate import banded_coo, random_coo
from repro_torch.kernels.spmv.cg_update import cg_buffers, cg_update, cg_update_plain
from repro_torch.kernels.spmv.gather import gather_rows, gather_rows_plain
from repro_torch.kernels.spmv.ops import RING_MAX_BATCH
from _torch_one_rank import OneRankChain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tile_set(rng, bm, bn, u_n=3, nrb=20, nsrc=25, t_max=30):
    counts = rng.integers(1, t_max + 1, size=u_n)
    t = t_max + 2
    tiles = np.zeros((u_n, t, bm, bn), np.float32)
    rows = np.zeros((u_n, t), np.int32)
    src = np.zeros((u_n, t), np.int32)
    for u, c in enumerate(counts):
        tiles[u, :c] = rng.standard_normal((c, bm, bn))
        rows[u, :c] = np.sort(rng.integers(0, nrb, size=c))
        src[u, :c] = rng.integers(0, nsrc, size=c)
    return tiles, rows, src, counts, nrb, nsrc


def _variant(name, bt, x):
    """One variant by its C entry point, on the same inputs, whichever the
    wrapper would choose."""
    from repro_torch.kernels.spmv.ops import _library

    u_n, t_n, bm, bn = bt.tiles.shape
    b = x.shape[3]
    out = torch.empty((u_n, bt.nrb, bm, b), dtype=torch.float32, device=x.device)
    tname = "f16" if bt.tiles.dtype == torch.float16 else "f32"
    ustride = 0 if x.shape[0] == 1 else x.shape[1] * bn * b
    ptrs = (bt.tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(), x.data_ptr())
    if name == "ring":
        args = (*ptrs, bt.pieces.data_ptr(), out.data_ptr(), int(bt.pieces.shape[0]), u_n, t_n)
    elif name == "stream":
        args = (*ptrs, bt.spans.data_ptr(), out.data_ptr(), int(bt.spans.shape[0]), t_n)
    else:
        args = (*ptrs, out.data_ptr(), u_n, t_n)
    rc = getattr(_library(), f"bell_spmm_{name}_{tname}")(
        *args, bt.nrb, bm, bn, b, ustride, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


@pytest.mark.parametrize("bm,bn", [(8, 8), (8, 16), (16, 16), (32, 32), (8, 128), (128, 128)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float16, 2e-2)])
@pytest.mark.parametrize("b", [1, 3, 8, 64])
@pytest.mark.parametrize("ux", ["U", 1])
def test_kernel_matches_plain_and_is_column_stable(cuda, bm, bn, dtype, tol, b, ux):
    rng = np.random.default_rng(bm * 1000 + bn)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, bm, bn)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda).to(dtype), rows, src, counts, nrb)
    u_x = len(counts) if ux == "U" else 1  # per-unit sources, or one shared source
    x = torch.as_tensor(rng.standard_normal((u_x, nsrc, bn, b)).astype(np.float32),
                        device=cuda).to(dtype)
    variant = spmm_variant(dtype, bm, bn, b)
    before = bell_spmm.launches
    before_variant = bell_spmm.variant_launches[variant]
    y = bell_spmm(bt, x)
    assert bell_spmm.launches == before + 1
    assert bell_spmm.variant_launches[variant] == before_variant + 1
    y_plain = bell_spmm_plain(bt.tiles, bt.tile_row, bt.tile_src, bt.counts, x, nrb)
    # Relative to the result's scale: FMA and separate multiply-add round apart.
    assert float((y - y_plain).abs().max() / y_plain.abs().max()) <= tol
    assert torch.equal(y, bell_spmm(bt, x))
    # One FMA chain in every variant and patch: column j is the B = 1
    # launch, and the stream kernel's result is the simt kernel's.
    for j in range(b):
        assert torch.equal(y[..., j:j + 1], bell_spmm(bt, x[..., j:j + 1].contiguous()))
    assert torch.equal(y, _variant("simt", bt, x))


def test_kernel_refuses_misaligned_sources(cuda):
    rng = np.random.default_rng(4)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, 16, 16)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda), rows, src, counts, nrb)
    flat = torch.zeros(3 * nsrc * 16 * 8 + 1, device=cuda)
    x = flat[1:].view(3, nsrc, 16, 8)  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        bell_spmm(bt, x)


# Tile shapes off the kernel's sweep grid: (24, 16) reaches ring and stream
# (a new bm), the others simt.
@pytest.mark.parametrize("bm,bn", [(24, 16), (16, 24), (12, 12), (4, 4), (16, 12)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float16, 2e-2)])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("ux", ["U", 1])
def test_kernel_takes_any_tile_shape(cuda, bm, bn, dtype, tol, b, ux):
    rng = np.random.default_rng(bm * 100 + bn)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, bm, bn)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda).to(dtype), rows, src, counts, nrb)
    u_x = len(counts) if ux == "U" else 1
    x = torch.as_tensor(rng.standard_normal((u_x, nsrc, bn, b)).astype(np.float32),
                        device=cuda).to(dtype)
    variant = spmm_variant(dtype, bm, bn, b)
    wide = "ring" if b <= RING_MAX_BATCH else "stream"
    assert variant == (wide if (bm, bn) == (24, 16) else "simt")
    before = bell_spmm.variant_launches[variant]
    y = bell_spmm(bt, x)
    assert bell_spmm.variant_launches[variant] == before + 1
    y_plain = bell_spmm_plain(bt.tiles, bt.tile_row, bt.tile_src, bt.counts, x, nrb)
    assert float((y - y_plain).abs().max() / y_plain.abs().max()) <= tol
    for j in range(b):
        assert torch.equal(y[..., j:j + 1], bell_spmm(bt, x[..., j:j + 1].contiguous()))
    assert torch.equal(y, _variant("simt", bt, x))


def _ring_tile_set(rng, bm, bn, u_n=4, nrb=300, nsrc=37):
    """Rows of 0, 1, a few and 17 or more tiles, and a unit with none."""
    per = rng.integers(0, 6, size=(u_n, nrb))
    per[:, ::7] = 0
    per[:, 3::11] = 1
    per[:, 5::13] = rng.integers(17, 40, size=per[:, 5::13].shape)
    per[2] = 0
    counts = per.sum(axis=1)
    t = int(counts.max()) + 2
    tiles = np.zeros((u_n, t, bm, bn), np.float32)
    rows = np.zeros((u_n, t), np.int32)
    src = np.zeros((u_n, t), np.int32)
    for u, c in enumerate(counts):
        tiles[u, :c] = rng.standard_normal((c, bm, bn))
        rows[u, :c] = np.repeat(np.arange(nrb), per[u])
        src[u, :c] = rng.integers(0, nsrc, size=c)
    return tiles, rows, src, counts, nrb, nsrc


@pytest.mark.parametrize("bm,bn", [(8, 8), (8, 16), (16, 16), (24, 16), (32, 32), (16, 32),
                                   (32, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("ux", ["U", 1])
def test_ring_is_bitwise_stream_and_simt(cuda, bm, bn, dtype, ux):
    """The ring variant at every B it takes, on rows of 0, 1 and 17+
    tiles and a unit with none: bitwise the stream and simt kernels on the
    same inputs, per-unit sources and one shared source, the wrapper's
    launch counted on ring."""
    rng = np.random.default_rng(bm * 100 + bn)
    tiles, rows, src, counts, nrb, nsrc = _ring_tile_set(rng, bm, bn)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda).to(dtype), rows, src, counts, nrb)
    u_x = len(counts) if ux == "U" else 1
    for b in range(1, RING_MAX_BATCH + 1):
        x = torch.as_tensor(rng.standard_normal((u_x, nsrc, bn, b)).astype(np.float32),
                            device=cuda).to(dtype)
        assert spmm_variant(dtype, bm, bn, b) == "ring"
        before = bell_spmm.variant_launches["ring"]
        y = bell_spmm(bt, x)
        assert bell_spmm.variant_launches["ring"] == before + 1
        assert torch.equal(y, _variant("stream", bt, x)), b
        assert torch.equal(y, _variant("simt", bt, x)), b
        for j in range(b):
            assert torch.equal(y[..., j:j + 1], bell_spmm(bt, x[..., j:j + 1].contiguous()))


def test_ring_raises_its_shared_memory_as_tiles_shrink(cuda):
    """One instantiation (float32, bn 16, B = 3) on a fresh thread, whose
    launcher state starts empty: 24-row tiles, then 8-row tiles, whose
    16-tile stages need more shared memory than the 5-tile stages of the
    first. Both launch, bitwise stream."""
    import threading

    rng = np.random.default_rng(8)
    cases = []
    for bm in (24, 8):
        tiles, rows, src, counts, nrb, nsrc = _ring_tile_set(rng, bm, 16)
        bt = bell_tiles(torch.as_tensor(tiles, device=cuda), rows, src, counts, nrb)
        x = torch.as_tensor(rng.standard_normal((1, nsrc, 16, 3)).astype(np.float32), device=cuda)
        cases.append((bt, x))
    got = []

    def launch():
        try:
            got.extend(bell_spmm(bt, x) for bt, x in cases)
        except RuntimeError as e:  # a refused launch, reported to the test's thread
            got.append(e)

    t = threading.Thread(target=launch)
    t.start()
    t.join()
    assert len(got) == 2 and all(isinstance(y, torch.Tensor) for y in got), got
    for (bt, x), y in zip(cases, got, strict=True):
        assert torch.equal(y, _variant("stream", bt, x))


def _stencil27(n):
    """HPCG's 27-point stencil on an n^3 grid (26 on the diagonal, -1 off it)."""
    iz, iy, ix = (a.ravel() for a in np.meshgrid(*(np.arange(n),) * 3, indexing="ij"))
    rows, cols, vals = [], [], []
    for dz, dy, dx in np.ndindex(3, 3, 3):
        jx, jy, jz = ix + dx - 1, iy + dy - 1, iz + dz - 1
        ok = (jx >= 0) & (jx < n) & (jy >= 0) & (jy < n) & (jz >= 0) & (jz < n)
        rows.append(np.nonzero(ok)[0])
        cols.append(jx[ok] + n * (jy[ok] + n * jz[ok]))
        vals.append(np.full(int(ok.sum()), 26.0 if (dx, dy, dz) == (1, 1, 1) else -1.0))
    row, col = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((col, row))
    return COO((n**3, n**3), row[order].astype(np.int32), col[order].astype(np.int32),
               np.concatenate(vals)[order].astype(np.float32))


@pytest.mark.parametrize("exchange", ["replicated", "selective"])
def test_ring_on_the_stencil_plan_is_bitwise_stream(cuda, exchange):
    """HPCG's stencil at 32^3 under NL-HC on 16 units (about 9 tiles a
    row, as at 64^3): the ring kernel bitwise stream and simt on the plan's
    own tiles at B = 1 to 3, float32 and float16, and the session's spmv
    (ring at B = 1) within 1e-5 of the float64 oracle."""
    sess = distribute(_stencil27(32), topology=Topology(4, 4), combo="NL-HC", block=16,
                      exchange=exchange)
    dp = sess.device_plan
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.float16):
        bt = bell_tiles(hoist_tiles(dp.tiles, device=cuda).to(dtype), dp.tile_row,
                        dp.tile_col, dp.real_tiles, dp.num_row_blocks)
        assert float(np.diff(bt.row_ptr.cpu().numpy(), axis=1).mean()) > 5
        for b in range(1, RING_MAX_BATCH + 1):
            x = torch.as_tensor(rng.standard_normal((1, dp.num_col_blocks, 16, b)).astype(
                np.float32), device=cuda).to(dtype)
            y = bell_spmm(bt, x)
            assert torch.equal(y, _variant("stream", bt, x)), (dtype, b)
            assert torch.equal(y, _variant("simt", bt, x)), (dtype, b)
    before = bell_spmm.variant_launches["ring"]
    x = rng.standard_normal(32**3).astype(np.float32)
    y, y_ref = sess.spmv(x), sess.spmv(x, executor="reference")
    assert bell_spmm.variant_launches["ring"] > before
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5


def test_ring_refuses_misaligned_sources(cuda):
    rng = np.random.default_rng(4)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, 16, 16)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda), rows, src, counts, nrb)
    flat = torch.zeros(3 * nsrc * 16 + 1, device=cuda)
    x = flat[1:].view(3, nsrc, 16, 1)  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="ring kernel copies 16-byte"):
        bell_spmm(bt, x)


@pytest.fixture(scope="module")
def stencil_sessions():
    """HPCG's stencil at 16^3 and 32^3 on the card, as the benchmark plans
    64^3 (NL-HC on 16 units, selective, 16 x 16 tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {n: distribute(_stencil27(n), topology=Topology(4, 4), combo="NL-HC", block=16,
                          exchange="selective") for n in (16, 32)}


def _cg_plain_on_the_card(monkeypatch, sess, **kw):
    """The device loop with the plain update in place of the fused one, on
    the same session."""
    with monkeypatch.context() as m:
        m.setattr(solvers, "cg_update", cg_update_plain)
        return sess.solve("cg", device_loop=True, **kw)


def _cg_fused_traced(sess, **kw):
    """A device-loop solve with the tracer on, and the fused updates it
    launched (``cg_update.launches``)."""
    before = cg_update.launches
    trace.enable()
    try:
        res = sess.solve("cg", device_loop=True, **kw)
    finally:
        trace.disable()
    return res, cg_update.launches - before


@pytest.mark.parametrize("batch", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [16, 32])
def test_fused_cg_update_matches_the_plain_update(cuda, stencil_sessions, monkeypatch, n,
                                                  batch):
    """50 iterations of the device loop, fused against plain on one
    session: x within 1e-6 and the residuals within 1e-9 (only the two
    dots' summation order differs), two fused solves bitwise equal, every
    iteration fused; and a batch with an all-zero row, which stays 0."""
    sess = stencil_sessions[n]
    b = np.random.default_rng(n + batch).standard_normal((batch, n**3)).astype(np.float32)
    fused, counted = _cg_fused_traced(sess, b=b, iters=50, tol=0.0)
    assert fused.iters_run == 50 and counted == 50
    again = sess.solve("cg", b=b, iters=50, tol=0.0, device_loop=True)
    assert np.array_equal(fused.x, again.x) and fused.residuals == again.residuals
    plain = _cg_plain_on_the_card(monkeypatch, sess, b=b, iters=50, tol=0.0)
    assert np.abs(fused.x - plain.x).max() / np.abs(plain.x).max() < 1e-6
    np.testing.assert_allclose(fused.residuals, plain.residuals, rtol=1e-9, atol=0)
    b[batch // 2] = 0.0
    fused = sess.solve("cg", b=b, iters=50, tol=0.0, device_loop=True)
    plain = _cg_plain_on_the_card(monkeypatch, sess, b=b, iters=50, tol=0.0)
    assert not fused.x[batch // 2].any()
    assert np.abs(fused.x - plain.x).max() / np.abs(plain.x).max(initial=1e-30) < 1e-6
    np.testing.assert_allclose(fused.residuals, plain.residuals, rtol=1e-9, atol=0)


def test_fused_cg_keeps_the_single_vector_bookkeeping(cuda, stencil_sessions, monkeypatch):
    """``b=[N]``: a zero right-hand side breaks down after one (fused)
    iteration with the residuals ``[0.0]``; a ``tol`` stop ends where the
    plain update's does."""
    sess = stencil_sessions[16]
    zero, counted = _cg_fused_traced(sess, b=np.zeros(16**3, np.float32), iters=30)
    assert zero.iters_run == 1 and not zero.converged and counted == 1
    assert zero.residuals == [0.0] and not zero.x.any()
    b = np.random.default_rng(1).standard_normal(16**3).astype(np.float32)
    fused, counted = _cg_fused_traced(sess, b=b, iters=200, tol=1e-3)
    plain = _cg_plain_on_the_card(monkeypatch, sess, b=b, iters=200, tol=1e-3)
    assert fused.converged and fused.iters_run == plain.iters_run < 200
    assert counted == fused.iters_run
    assert len(fused.residuals) == fused.iters_run + 1
    np.testing.assert_allclose(fused.residuals, plain.residuals, rtol=1e-9, atol=0)


@pytest.mark.parametrize("b,variant", [(1, "ring"), (4, "stream")])
def test_composed_exchange_is_the_chain_on_the_card(cuda, stencil_sessions, b, variant):
    """On the selective stencil plan, y from the one-gather exchange a
    ``LocalCommunicator`` composes is bitwise the three-step chain's, on
    the variant the batch width picks."""
    sess = stencil_sessions[32]
    dp = sess.device_plan
    steps = [make_pmvc_step(dp, make_unit_mesh(dp.num_units, comm=comm),
                            selective=sess.selective, device=cuda)
             for comm in (LocalCommunicator(), OneRankChain())]
    x = torch.randn((dp.num_col_blocks, dp.bn, b), generator=torch.Generator().manual_seed(b))
    x = x.to(cuda)
    before, gathers = bell_spmm.variant_launches[variant], gather_rows.launches
    composed = steps[0](x)
    assert gather_rows.launches == gathers + 1  # the exchange's one launch
    chain = steps[1](x)
    assert bell_spmm.variant_launches[variant] == before + 2
    assert torch.equal(composed, chain)


@pytest.mark.parametrize("dtype,tail,offset", [
    (torch.float32, (16, 1), 0),  # 64-byte rows: 16-byte vectors
    (torch.float32, (16, 4), 0),
    (torch.float32, (16, 1), 1),  # a source 4 bytes off: 4-byte words
    (torch.float32, (3, 1), 0),   # 12-byte rows
    (torch.float16, (3, 1), 0),   # 6-byte rows: bytes
    (torch.float64, (8, 2), 0),
])
def test_gather_rows_is_the_plain_gather(cuda, dtype, tail, offset):
    """The hand-written gather, by each of its vector widths, bitwise
    ``gather_rows_plain``: rows in any order, repeated, and −1 slots as
    zero rows."""
    g = torch.Generator().manual_seed(3)
    rows = 1000
    flat = torch.randn(rows * math.prod(tail) + offset, generator=g).to(dtype).to(cuda)
    src = flat[offset:].view(rows, *tail)  # offset elements past the allocation's start
    index = torch.randint(-1, rows, (7, 300), generator=g)
    index[0, :5] = -1
    index = index.to(cuda)
    before = gather_rows.launches
    got = gather_rows(src, index)
    assert gather_rows.launches == before + 1
    want = gather_rows_plain(src, index)
    assert got.shape == (7, 300, *tail) and torch.equal(got, want)
    assert not got[index < 0].any()


def test_fused_cg_update_is_the_plain_update_at_one_iteration(cuda):
    """One call on random state against the plain update (the zero row
    frozen), with ``ap`` in the spmv's transposed layout."""
    rng = np.random.default_rng(2)
    z, r, p = (torch.as_tensor(rng.standard_normal((3, 5000)).astype(np.float32), device=cuda)
               for _ in range(3))
    ap = torch.as_tensor(rng.standard_normal((5000, 3)).astype(np.float32), device=cuda).T
    p[1] = 0.0
    rs = (r.double() ** 2).sum(-1)
    want = cg_buffers(z.clone(), r.clone(), p.clone(), rs, 1)
    cg_update_plain(want, ap, 1)
    buf = cg_buffers(z.clone(), r.clone(), p.clone(), rs, 1)
    cg_update(buf, ap, 1)
    assert buf.ok.tolist() == want.ok.tolist() == [1, 0, 1]
    for got, exp in ((buf.z, want.z), (buf.r, want.r), (buf.p, want.p)):
        assert torch.equal(got[1], exp[1])
        assert float((got - exp).abs().max() / exp.abs().max()) < 1e-6
    torch.testing.assert_close(buf.rs[1], want.rs[1], rtol=1e-12, atol=0)
    assert float(buf.resid[0]) == pytest.approx(float(want.resid[0]), rel=1e-12)


def test_kernel_refuses_tiles_past_simt_shared_memory(cuda):
    rng = np.random.default_rng(5)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, 128, 200, t_max=2)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda), rows, src, counts, nrb)
    x = torch.zeros((1, nsrc, 200, 1), device=cuda)
    before = bell_spmm.launches
    with pytest.raises(ValueError, match="shared memory"):
        bell_spmm(bt, x)
    assert bell_spmm.launches == before


def test_spmm_shard_on_the_card(cuda):
    a = random_coo(192, 1500, seed=0)
    owner = nezgt_partition(tile_counts(a, 16, 16), 3).assignment
    bell = pack_bell(a, owner, 3, 16, 16)
    xs = np.random.default_rng(1).standard_normal((8, 192)).astype(np.float32)
    for shard in bell.shards:
        r = len(shard.row_blocks)
        tiles, tr, tc, xb = pack_inputs(shard, xs, 16)
        assert tiles.device.type == "cuda"
        before = bell_spmm.launches
        y = spmm_shard(tiles, tr, tc, xb, r)
        assert bell_spmm.launches == before + 1
        y_ref = spmm_shard_ref(tiles, tr, tc, xb, r)
        assert float((y - y_ref).abs().max() / y_ref.abs().max()) <= 1e-5
        _, _, _, xb1 = pack_inputs(shard, xs[3], 16)
        assert torch.equal(spmv_shard(tiles, tr, tc, xb1, r), y[..., 3])


def _diag_heavy_coo(seed, n=96, nnz=700):
    """tests/test_serve_sparse.py's graph: random entries, a dominant diagonal."""
    rng = np.random.default_rng(seed)
    d = np.arange(n, dtype=np.int32)
    row = np.concatenate([rng.integers(0, n, nnz).astype(np.int32), d])
    col = np.concatenate([rng.integers(0, n, nnz).astype(np.int32), d])
    val = np.concatenate([rng.standard_normal(nnz).astype(np.float32),
                          np.full(n, 8.0, np.float32)])
    order = np.argsort(row, kind="stable")
    return COO((n, n), row[order], col[order], val[order])


@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap:2"])
def test_engine_is_the_direct_solve_on_the_card(cuda, exchange):
    """Every stepper served at B = 4 slots, bitwise its direct batched-of-1
    solve on the same card session, and the B = 4 spmv's columns bitwise
    the B = 1 spmv."""
    sess = distribute(_diag_heavy_coo(1), topology=Topology(2, 2), block=16,
                      exchange=exchange)
    assert sess.device.type == "cuda"
    rng = np.random.default_rng(3)
    x = rng.random((4, 96)).astype(np.float32)
    y = sess.spmv(x)
    for j in range(4):
        assert np.array_equal(y[j], sess.spmv(x[j:j + 1])[0])
    eng = SparseServeEngine(batch_slots=4, default_iters=6)
    eng.register_graph("g", sess)
    keys = {"pagerank": "seeds", "jacobi": "b", "spmv": "x", "cg": "b"}
    assert set(keys) == set(STEPPERS.names())
    sent = []
    for solver, key in keys.items():
        for _ in range(5):  # more than the slots: refill mid-flight
            payload = {key: rng.random(96).astype(np.float32)}
            sent.append((eng.submit("g", solver, payload=payload, tol=1e-4), solver, payload))
    eng.run_until_drained()
    for t, solver, payload in sent:
        assert t.status is Status.DONE
        if solver == "spmv":
            assert np.array_equal(t.result.x, sess.spmv(payload["x"][None])[0])
            continue
        ref = sess.solve(solver, iters=6, tol=1e-4, **{k: v[None] for k, v in payload.items()})
        assert np.array_equal(t.result.x, ref.x[0]), solver
        assert t.result.residuals == ref.residuals, solver
        assert t.result.iters_run == ref.iters_run


def test_session_on_the_card_matches_the_oracle(cuda):
    a = banded_coo(3000, 40000, seed=0)
    x = np.random.default_rng(0).standard_normal((8, 3000)).astype(np.float32)
    for exchange in ("replicated", "selective", "overlap:2"):
        sess = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange=exchange)
        assert sess.device.type == "cuda"
        before = bell_spmm.launches
        y = sess.spmv(x)
        assert bell_spmm.launches > before
        y_ref = sess.spmv(x, executor="reference")
        assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5
        host = sess.solve("pagerank", iters=10)
        dev = sess.solve("pagerank", iters=10, device_loop=True)
        np.testing.assert_allclose(dev.x, host.x, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap:2"])
@pytest.mark.parametrize("fmt", [1, 2])
def test_save_load_is_bitwise_on_the_card(cuda, tmp_path, exchange, fmt):
    """A lazily loaded session's first spmv materializes the archive,
    hoists the tiles and launches the variant ``spmm_variant`` names for
    B = 1; B = 1 and B = 8 are bitwise the saved session's."""
    if fmt == 1 and exchange == "overlap:2":
        exchange = "overlap"  # v1 predates multi-wave plans
    a = banded_coo(3000, 40000, seed=1)
    x = np.random.default_rng(1).standard_normal((8, 3000)).astype(np.float32)
    sess = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange=exchange)
    path = sess.save(str(tmp_path / "plan.npz"), format_version=fmt)
    loaded = load_session(path)
    assert loaded.device.type == "cuda" and not loaded.is_materialized
    before = dict(bell_spmm.variant_launches)
    y1 = loaded.spmv(x[:1])
    dp = loaded.device_plan
    assert bell_spmm.variant_launches[spmm_variant(torch.float32, dp.bm, dp.bn, 1)] > \
        before[spmm_variant(torch.float32, dp.bm, dp.bn, 1)]
    assert bell_spmm.variant_launches["simt"] == before["simt"]
    assert np.array_equal(y1, sess.spmv(x[:1]))
    assert np.array_equal(loaded.spmv(x), sess.spmv(x))


@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap:2"])
def test_patched_spmv_is_the_cold_pack_on_the_card(cuda, exchange):
    a = banded_coo(3000, 40000, seed=2)
    rng = np.random.default_rng(2)
    sess = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange=exchange)
    band = np.abs(a.row - a.col) <= 4
    cand = np.nonzero(band)[0]
    dele = rng.choice(cand, 300, replace=False)
    r = rng.integers(0, 3000, 600).astype(np.int32)
    c = np.clip(r + rng.integers(-4, 5, 600), 0, 2999).astype(np.int32)
    key = r.astype(np.int64) * 3000 + c
    fresh = ~np.isin(key, a.row.astype(np.int64) * 3000 + a.col)
    _, first = np.unique(key, return_index=True)
    pick = np.intersect1d(np.nonzero(fresh)[0], first)[:300]
    delta = SparseDelta.merge(a.shape, up_row=r[pick], up_col=c[pick],
                              up_val=rng.standard_normal(pick.size).astype(np.float32),
                              del_row=a.row[dele], del_col=a.col[dele])
    patched = sess.update(delta, force="patch")
    assert patched.device.type == "cuda" and patched.update_report.structural
    mutated = delta.apply(a)
    dp = patched.device_plan
    cold_dp = pack_units(mutated, patched.partition.elem_unit, dp.num_units, dp.bm, dp.bn)
    cold = SparseSession(mutated, patched.topology, patched.partition, cold_dp,
                         exchange=exchange, selective=resolve_exchange(exchange)(cold_dp),
                         executor="simulate", device=cuda)
    x = rng.standard_normal((8, 3000)).astype(np.float32)
    y = patched.spmv(x)
    assert np.array_equal(y, cold.spmv(x))
    y_ref = patched.spmv(x, executor="reference")
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5
    patched.verify("full")


def test_load_without_a_device_takes_the_card_or_raises(cuda, tmp_path, monkeypatch):
    sess = distribute(banded_coo(500, 4000, seed=3), topology=Topology(2, 1))
    path = sess.save(str(tmp_path / "plan.npz"))
    assert load_session(path).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_session(path)


# The reference tests' tolerances (tests/test_kernels_gmm.py and
# tests/test_kernels_attn.py), as rtol and atol.
GMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


# The reference tests' shapes (simt), then shapes of the wgmma (bf16) and
# regblock (float32) variants: N not a multiple of 256, 64-row blocks with a
# ragged N, the granite widths, K not a multiple of 64.
def _serve_three(sess, tmp_path=None, injector=None):
    """tests/test_elastic_recovery.py's three requests, drained."""
    rng = np.random.default_rng(9)
    seeds, b = rng.random(160).astype(np.float32), rng.random(160).astype(np.float32)
    eng = SparseServeEngine(batch_slots=4, fault_injector=injector,
                            recovery_dir=None if tmp_path is None else str(tmp_path))
    eng.register_graph("g", sess)
    tickets = [eng.submit("g", "pagerank", payload={"seeds": seeds}, iters=10),
               eng.submit("g", "pagerank", payload={"seeds": seeds}, iters=6),
               eng.submit("g", "jacobi", payload={"b": b}, iters=8)]
    eng.run_until_drained()
    return eng, tickets


@pytest.mark.parametrize("kill_at", range(12))
def test_kill_point_matrix_on_the_card(cuda, tmp_path, kill_at):
    """Unit 1 killed at each engine fault point, the engine on the card:
    the rebuilt sessions are on the card, the results bitwise the
    uninterrupted run's."""
    sess = distribute(_diag_heavy_coo(1, n=160, nnz=1400), topology=Topology(2, 2),
                      combo="NL-HL", exchange="selective", block=32, seed=0)
    _, base = _serve_three(sess)
    injector = FaultInjector(schedule={kill_at: 1})
    eng, got = _serve_three(sess, tmp_path, injector)
    assert injector.fired == [kill_at] and eng.recoveries == 1
    assert all(s.device.type == "cuda" for s in eng._graphs.values())
    for t0, t1 in zip(base, got, strict=True):
        assert t1.status is Status.DONE, t1.error
        assert np.array_equal(t0.result.x, t1.result.x)
        assert t0.result.residuals == t1.result.residuals


def test_spmv_and_shard_map_run_inside_deterministic(cuda, tmp_path):
    """The main path's spmv (``simulate``) and the one-rank ``shard_map``
    step inside the train step's ``deterministic()`` block, on every
    exchange at B = 1 and 8: no op refuses the mode, and each result is
    bitwise the same call outside the block; the mode is off again after
    it."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.train.step import deterministic

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        a = banded_coo(3000, 40000, seed=5)
        x = np.random.default_rng(5).standard_normal((8, 3000)).astype(np.float32)
        for exchange in ("replicated", "selective", "overlap:2"):
            sess = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange=exchange)
            outs = {}
            for inside in (False, True):
                with deterministic() if inside else contextlib.nullcontext():
                    assert torch.are_deterministic_algorithms_enabled() == inside
                    outs[inside] = [sess.spmv(xb, executor=ex) for ex in ("simulate", "shard_map")
                                    for xb in (x[0], x)]
            for y_out, y_in in zip(outs[False], outs[True], strict=True):
                assert np.array_equal(y_out, y_in), exchange
            assert not torch.are_deterministic_algorithms_enabled()
    finally:
        dist.destroy_process_group()


def test_shard_map_on_an_nccl_group_of_one(cuda, tmp_path):
    """All units stacked on one rank of an NCCL group: within 1e-5 of
    the float64 oracle on every exchange, single and batched, the
    recorded schedule the golden one, every contraction on the variant
    ``spmm_variant`` names for its batch width."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        a = banded_coo(3000, 40000, seed=4)
        x = np.random.default_rng(4).standard_normal((8, 3000)).astype(np.float32)
        for exchange in ("replicated", "selective", "overlap:2"):
            sess = distribute(a, topology=Topology(2, 2), combo="NL-HC", exchange=exchange,
                              executor="shard_map")
            dp = sess.device_plan
            for xb in (x[0], x):
                before = dict(bell_spmm.variant_launches)
                y, y_ref = sess.spmv(xb), sess.spmv(xb, executor="reference")
                assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5, exchange
                named = spmm_variant(torch.float32, dp.bm, dp.bn, 1 if xb.ndim == 1 else len(xb))
                ran = {v: bell_spmm.variant_launches[v] - before[v] for v in before}
                assert ran[named] > 0 and sum(ran.values()) == ran[named], (exchange, ran)
            log = []
            dp = sess.device_plan
            step = make_pmvc_step(dp, make_unit_mesh(dp.num_units, comm=Communicator(log=log)),
                                  selective=sess.selective)
            step(pad_x(torch.as_tensor(x[0], device=cuda), dp.num_col_blocks, dp.bn))
            waves = getattr(sess.selective, "waves", 1)
            assert schedule_signature(log) == golden_signature(exchange, waves)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap:2"])
def test_schedule_audit_runs_on_the_card(cuda, exchange):
    """With no device given, the audit records the step on the card (no
    process group): the golden schedule, through launches of the variant
    ``spmm_variant`` names for its single vector."""
    sess = distribute(banded_coo(3000, 40000, seed=4), topology=Topology(2, 2), combo="NL-HC",
                      exchange=exchange)
    dp = sess.device_plan
    named = spmm_variant(torch.float32, dp.bm, dp.bn, 1)
    before = bell_spmm.variant_launches[named]
    rep = audit_session(sess)
    assert rep.ok, str(rep)
    assert bell_spmm.variant_launches[named] > before
    events = trace_pmvc_step(sess.device_plan, sess.selective, batch=8)
    assert schedule_signature(events) == rep.golden


@pytest.mark.parametrize("e,k,n,bm", [(4, 32, 64, 8), (8, 64, 128, 16), (2, 16, 16, 8),
                                      (3, 256, 320, 128), (8, 256, 384, 128),
                                      (4, 512, 192, 64), (32, 1024, 512, 128),
                                      (4, 80, 256, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain(cuda, e, k, n, bm, dtype, out_dtype):
    rng = np.random.default_rng(e * 100 + k)
    m_tiles = 2 * e + 1
    x = torch.as_tensor(rng.standard_normal((m_tiles * bm, k)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.standard_normal((e, k, n)), device=cuda).to(dtype)
    gid = torch.as_tensor(rng.integers(0, e, size=m_tiles), dtype=torch.int32, device=cuda)
    before = grouped_matmul.launches
    variant = gmm_variant(dtype, bm, k, n)
    before_variant = grouped_matmul.variant_launches[variant]
    y = grouped_matmul(x, w, gid, bm=bm, bk=16, bn=16, out_dtype=out_dtype)
    assert grouped_matmul.launches == before + 1
    assert grouped_matmul.variant_launches[variant] == before_variant + 1
    assert y.dtype == out_dtype and y.shape == (m_tiles * bm, n)
    y_plain = gmm_plain(x, w, gid, bm=bm, out_dtype=out_dtype)
    tol = max(GMM_TOL[dtype], GMM_TOL[out_dtype])
    torch.testing.assert_close(y.float(), y_plain.float(), rtol=tol, atol=tol)
    assert torch.equal(y, grouped_matmul(x, w, gid, bm=bm, bk=16, bn=16, out_dtype=out_dtype))


def test_gmm_dispatch_on_the_card(cuda):
    rng = np.random.default_rng(3)
    e, k, n, bm = 4, 64, 96, 16
    expert_of_token = rng.integers(0, e, size=75)
    order, gid, _ = plan_groups(expert_of_token, e, bm)
    x_tok = rng.standard_normal((75, k)).astype(np.float32)
    xs = np.zeros((len(order), k), np.float32)
    xs[order >= 0] = x_tok[order[order >= 0]]
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    y = grouped_matmul(torch.as_tensor(xs, device=cuda), torch.as_tensor(w, device=cuda),
                       torch.as_tensor(gid, device=cuda), bm=bm, bk=16, bn=32).cpu().numpy()
    for tok in range(75):
        pos = int(np.nonzero(order == tok)[0][0])
        np.testing.assert_allclose(y[pos], x_tok[tok] @ w[expert_of_token[tok]],
                                   rtol=2e-4, atol=2e-4)


# T < S with a window leaves rows that see no key: (128, 32, 32, 16) with
# (True, 8), (64, 32, 16, 16) with (False, 8), (128, 32, 16, 16) with
# (True, 4), (256, 64, 64, 64) and (256, 64, 128, 32) with (True, 8). D 24
# runs both types on the simt variant; float32 takes regblock at 64-multiple
# tiles; bf16 takes wgmma where bq is a multiple of 64 (bkv = 16 and 32
# under its 128-key chunk, bq = 256 as two 128-row blocks), mma elsewhere.
ATTN_CASES = [(causal, window, s, t, bq, bkv, d)
              for causal, window in ((True, 0), (False, 0), (True, 8), (True, 32), (False, 16),
                                     (False, 8), (True, 4))
              for s, t, bq, bkv in ((64, 64, 16, 16), (128, 128, 32, 16), (256, 256, 128, 128),
                                    (128, 256, 64, 32), (128, 32, 32, 16), (64, 32, 16, 16),
                                    (128, 32, 16, 16), (256, 64, 64, 64), (128, 128, 64, 64),
                                    (128, 128, 64, 16), (512, 512, 256, 128),
                                    (256, 64, 128, 32))
              for d in (16, 24, 64, 80, 128)]
# Then a window of 16 and 64 x 64 tiles on a 64-token sequence; T > S and
# T < S on tiles outside the grid above; and the D the wgmma variant stages
# in two 64-column boxes or in one box partly past D (48, 96, 112).
ATTN_CASES += [(causal, window, s, s, bq, bkv, d)
               for causal, window in ((True, 0), (False, 0), (True, 8), (True, 16), (True, 32))
               for s, bq, bkv in ((64, 64, 64), (64, 16, 16), (128, 32, 16))
               for d in (16, 80) if window == 16 or bq == 64]
ATTN_CASES += [(True, 16, 64, 192, 32, 64, 80), (True, 4, 256, 64, 128, 64, 64),
               (True, 0, 256, 256, 64, 16, 128), (False, 0, 128, 256, 64, 32, 48),
               (True, 16, 256, 256, 128, 64, 112), (True, 8, 256, 64, 128, 32, 96),
               (True, 0, 384, 384, 128, 64, 16)]


@pytest.mark.parametrize("causal,window,s,t,bq,bkv,d", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(cuda, causal, window, s, t, bq, bkv, d, dtype):
    rng = np.random.default_rng(s + d + window)
    q, k, v = (torch.as_tensor(rng.standard_normal((3, n, d)), device=cuda).to(dtype)
               for n in (s, t, t))
    before = flash_attention.launches
    variant = attention_variant(dtype, d, bq, bkv)
    before_variant = flash_attention.variant_launches[variant]
    o = flash_attention(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv)
    assert flash_attention.launches == before + 1
    assert flash_attention.variant_launches[variant] == before_variant + 1
    assert o.dtype == dtype and o.shape == q.shape
    # The plain version with the kernel's tiles: a row whose tile visits no
    # key is 0, one whose visited keys are all masked their mean of v.
    o_plain = attention_plain(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv)
    torch.testing.assert_close(o.float(), o_plain.float(), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])
    assert torch.equal(o, mha(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv))


def _attn_entry(variant, q, k, v, **kw):
    """One bf16 variant by its C entry point, whatever the wrapper would pick."""
    from repro_torch.kernels.attn.ops import _library

    o = torch.empty_like(q)
    bh, s, d = q.shape
    rc = getattr(_library(), f"flash_attention_{variant}_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, k.shape[1], d, kw["bq"],
        kw["bkv"], int(kw["causal"]), kw["window"], d**-0.5,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"{variant} launch failed: cudaError {rc}"
    return o


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0), (False, 48)])
@pytest.mark.parametrize("s,t,bq,bkv", [(512, 512, 128, 128), (256, 384, 64, 16),
                                        (512, 128, 256, 64)])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_attention_wgmma_agrees_with_mma(cuda, causal, window, s, t, bq, bkv, d):
    """The Hopper variant and the mma.sync one on the same inputs, within
    the bf16 tolerance of each other."""
    rng = np.random.default_rng(7 * d + s + window)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, n, d)), device=cuda).bfloat16()
               for n in (s, t, t))
    kw = {"causal": causal, "window": window, "bq": bq, "bkv": bkv}
    assert attention_variant(torch.bfloat16, d, bq, bkv) == "wgmma"
    o_wg, o_mma = _attn_entry("wgmma", q, k, v, **kw), _attn_entry("mma", q, k, v, **kw)
    torch.testing.assert_close(o_wg.float(), o_mma.float(), rtol=ATTN_TOL[torch.bfloat16],
                               atol=ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("d,window", [(64, 0), (80, 512), (128, 0)])
def test_attention_wgmma_launches_are_bitwise_equal(cuda, d, window):
    """Fixed summation order, no atomics: two launches of the wgmma variant
    over many 128-key chunks give the same bits."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.as_tensor(rng.standard_normal((8, 2048, d)), device=cuda).bfloat16()
               for _ in range(3))
    kw = {"causal": True, "window": window, "bq": 128, "bkv": 128}
    before = flash_attention.variant_launches["wgmma"]
    o1, o2 = flash_attention(q, k, v, **kw), flash_attention(q, k, v, **kw)
    assert flash_attention.variant_launches["wgmma"] == before + 2
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fault", ["misaligned", "strided"])
def test_attention_refuses_misaligned_or_strided_inputs(cuda, dtype, fault):
    """TMA and cp.async copy from 16-byte aligned, contiguous rows: such an
    input is refused before any launch, never copied or sent elsewhere."""
    bh, s, d = 2, 128, 64
    q, k, v = (torch.zeros((bh, s, d), dtype=dtype, device=cuda) for _ in range(3))
    if fault == "misaligned":  # one element past a 16-byte boundary
        q = torch.zeros(bh * s * d + 8, dtype=dtype, device=cuda)[1:1 + bh * s * d].view(bh, s, d)
    else:  # every other column of a wider tensor
        k = torch.zeros((bh, s, 2 * d), dtype=dtype, device=cuda)[..., ::2]
    before = dict(flash_attention.variant_launches)
    with pytest.raises(ValueError, match="16-byte" if fault == "misaligned" else "contiguous"):
        flash_attention(q, k, v, causal=True, bq=128, bkv=128)
    assert flash_attention.variant_launches == before


# -- language models ----------------------------------------------------------

LM_TOL = 1e-5  # card vs CPU: max |d| / max |logit|, float32, TF32 off


@pytest.mark.parametrize("arch,s", [("qwen3-1.7b", 16), ("h2o-danube-1.8b", 40),
                                    ("mamba2-2.7b", 16), ("hymba-1.5b", 24),
                                    ("llava-next-34b", 16), ("seamless-m4t-medium", 16)])
def test_lm_on_the_card_matches_the_cpu(cuda, arch, s):
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    card = lm_from_numpy(cfg, lm_to_numpy(cpu), device=cuda)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)

    def err(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    with torch.no_grad():
        assert err(model.forward(card, batch)[0], model.forward(cpu, batch)[0]) < LM_TOL
    states = [model.init_state(p, batch, max_len=s) for p in (card, cpu)]
    for t in range(s):
        tok = batch["tokens"][:, t : t + 1]
        (lg_card, states[0]), (lg_cpu, states[1]) = (
            model.decode_step(p, tok, st) for p, st in zip((card, cpu), states))
        assert lg_card.device.type == "cuda"
        assert err(lg_card, lg_cpu) < LM_TOL, t


def test_lm_engine_is_greedy_generate_on_the_card(cuda):
    """Equal-length prompts in one wave of a ``ServeEngine`` whose
    ``max_len`` is the prompt plus ``max_new``: the engine's batch is
    ``greedy_generate``'s, so its tokens are bitwise the same."""
    cfg = get_arch("qwen3-1.7b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(2))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
    want = greedy_generate(model, params, prompts, max_new=6)
    eng = ServeEngine(model, params, batch_slots=4, max_len=18)
    assert eng.device.type == "cuda"
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=6))
    eng.run_until_drained()
    assert eng.ticks == 12 + 6 - 1
    for r in eng.completed:
        np.testing.assert_array_equal(np.array(r.out), want[r.rid])


TRAIN_ARCHS = ["qwen3-1.7b", "mamba2-2.7b", "hymba-1.5b", "granite-moe-1b-a400m",
               "seamless-m4t-medium"]


def _train_batch(cfg, b, s):
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.frontend:
        batch["frontend_embeds"] = rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Loss within 1e-5 relative, each gradient leaf within 1e-4 of its max."""
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    card = lm_from_numpy(cfg, lm_to_numpy(cpu), device=cuda)
    batch = _train_batch(cfg, 2, 16)
    loss_c, _, g_c = value_and_grad(model, card, batch, None, TrainConfig())
    loss, _, g = value_and_grad(model, cpu, batch, None, TrainConfig())
    assert abs(float(loss_c) - float(loss)) <= 1e-5 * abs(float(loss))
    for n in g:
        assert g_c[n].device.type == "cuda"
        assert float((g_c[n].cpu() - g[n]).abs().max()) <= 1e-4 * float(g[n].abs().max()), n


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_train_step_is_deterministic_on_the_card(cuda, arch, remat):
    """Two steps from the same state give the same bits (the step runs
    under deterministic algorithms), and "dots" gives "none"'s."""
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    p0 = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = _train_batch(cfg, 4, 32)
    step = make_train_step(model, TrainConfig(warmup_steps=0, remat=remat))
    outs = []
    for _ in range(2):
        p = p0.map(lambda _, w: w.clone())
        p, state, metrics = step(p, init_opt(p), batch)
        outs.append((p, state, metrics))
    (a, sa, ma), (b, sb, mb) = outs
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    for x, y in zip(list(a.parameters()) + list(sa.nu.parameters()),
                    list(b.parameters()) + list(sb.nu.parameters())):
        assert torch.equal(x, y)
    _, _, g_none = value_and_grad(model, p0, batch, None, TrainConfig())
    _, _, g_remat = value_and_grad(model, p0, batch, None, TrainConfig(remat=remat))
    assert all(torch.equal(g_none[n], g_remat[n]) for n in g_none)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_resume_is_bit_exact_on_the_card(cuda, tmp_path, arch):
    cfg = get_arch(arch).reduced()
    model = build(cfg)
    p0 = model.init(torch.Generator(device=cuda).manual_seed(0))
    tc = TrainConfig(total_steps=8, warmup_steps=2, checkpoint_every=2, learning_rate=1e-2)
    dc = DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=0)

    def batch_fn(s):
        return {"tokens": SyntheticStream(dc, start_step=s).batch_at(s)}

    step = make_train_step(model, tc)
    runs = []
    for name, faults in (("a", None), ("b", None), ("c", FaultInjector({5: 0}))):
        loop = TrainLoop(step, batch_fn, tc, fault_injector=faults,
                         ckpt=CheckpointManager(str(tmp_path / name), keep=10))
        runs.append(loop.run(p0, num_steps=8))
    assert runs[2].restarts == 1
    for res in runs[1:]:
        for x, y in zip(runs[0].params.parameters(), res.params.parameters()):
            assert x.device.type == "cuda" and torch.equal(x, y)
