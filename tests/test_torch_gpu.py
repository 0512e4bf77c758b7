"""The port on the card: each CUDA kernel (Block-ELL SpMM, grouped matmul,
flash attention) against its plain version, two launches bitwise equal
and the launch counter rising, a small session end to end against the
float64 oracle, the single-shard entry points, and the serving engine
bitwise its direct solves.

Marked ``gpu``; each test asks a fixture for the card and skips without
one. The file imports no JAX, so it also runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import STEPPERS, Topology, distribute
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
from repro_torch.serve import SparseServeEngine, Status
from repro_torch.sparse.bell import pack_bell, tile_counts
from repro_torch.sparse.formats import COO
from repro_torch.sparse.generate import banded_coo, random_coo

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


def _simt(bt, x):
    """The simt kernel by its C entry point, on the same inputs."""
    from repro_torch.kernels.spmv.ops import _library

    u_n, t_n, bm, bn = bt.tiles.shape
    b = x.shape[3]
    out = torch.empty((u_n, bt.nrb, bm, b), dtype=torch.float32, device=x.device)
    name = "f16" if bt.tiles.dtype == torch.float16 else "f32"
    ustride = 0 if x.shape[0] == 1 else x.shape[1] * bn * b
    rc = getattr(_library(), f"bell_spmm_simt_{name}")(
        bt.tiles.data_ptr(), bt.row_ptr.data_ptr(), bt.tile_src.data_ptr(), x.data_ptr(),
        out.data_ptr(), u_n, t_n, bt.nrb, bm, bn, b, ustride,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


@pytest.mark.parametrize("bm,bn", [(8, 8), (8, 16), (16, 16), (32, 32), (8, 128), (128, 128)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float16, 2e-2)])
@pytest.mark.parametrize("b", [1, 3, 8, 64])
def test_kernel_matches_plain_and_is_column_stable(cuda, bm, bn, dtype, tol, b):
    rng = np.random.default_rng(bm * 1000 + bn)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, bm, bn)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda).to(dtype), rows, src, counts, nrb)
    x = torch.as_tensor(rng.standard_normal((3, nsrc, bn, b)).astype(np.float32),
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
    assert torch.equal(y, _simt(bt, x))


def test_kernel_refuses_misaligned_sources(cuda):
    rng = np.random.default_rng(4)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, 16, 16)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda), rows, src, counts, nrb)
    flat = torch.zeros(3 * nsrc * 16 * 8 + 1, device=cuda)
    x = flat[1:].view(3, nsrc, 16, 8)  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        bell_spmm(bt, x)


# Tile shapes off the kernel's sweep grid: (24, 16) reaches stream (a new
# bm), the others simt.
@pytest.mark.parametrize("bm,bn", [(24, 16), (16, 24), (12, 12), (4, 4), (16, 12)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float16, 2e-2)])
@pytest.mark.parametrize("b", [1, 8])
def test_kernel_takes_any_tile_shape(cuda, bm, bn, dtype, tol, b):
    rng = np.random.default_rng(bm * 100 + bn)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, bm, bn)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda).to(dtype), rows, src, counts, nrb)
    x = torch.as_tensor(rng.standard_normal((3, nsrc, bn, b)).astype(np.float32),
                        device=cuda).to(dtype)
    variant = spmm_variant(dtype, bm, bn, b)
    assert variant == ("stream" if (bm, bn) == (24, 16) else "simt")
    before = bell_spmm.variant_launches[variant]
    y = bell_spmm(bt, x)
    assert bell_spmm.variant_launches[variant] == before + 1
    y_plain = bell_spmm_plain(bt.tiles, bt.tile_row, bt.tile_src, bt.counts, x, nrb)
    assert float((y - y_plain).abs().max() / y_plain.abs().max()) <= tol
    for j in range(b):
        assert torch.equal(y[..., j:j + 1], bell_spmm(bt, x[..., j:j + 1].contiguous()))
    assert torch.equal(y, _simt(bt, x))


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


# The reference tests' tolerances (tests/test_kernels_gmm.py and
# tests/test_kernels_attn.py), as rtol and atol.
GMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


# The reference tests' shapes (simt), then shapes of the wgmma (bf16) and
# regblock (float32) variants: N not a multiple of 256, 64-row blocks with a
# ragged N, the granite widths, K not a multiple of 64.
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
# (True, 4), (256, 64, 64, 64) with (True, 8). D 24 runs both types on the
# simt variant; float32 takes regblock at 64-multiple tiles.
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8), (True, 32),
                                           (False, 16), (False, 8), (True, 4)])
@pytest.mark.parametrize("s,t,bq,bkv", [(64, 64, 16, 16), (128, 128, 32, 16),
                                        (256, 256, 128, 128), (128, 256, 64, 32),
                                        (128, 32, 32, 16), (64, 32, 16, 16), (128, 32, 16, 16),
                                        (256, 64, 64, 64), (128, 128, 64, 64)])
@pytest.mark.parametrize("d", [16, 24, 64, 80, 128])
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
