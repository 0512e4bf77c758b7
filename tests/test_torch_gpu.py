"""The port on the card: the CUDA Block-ELL SpMM kernel against its plain
version, and a small session end to end against the float64 oracle.

Marked ``gpu``; each test asks a fixture for the card and skips without
one. The file imports no JAX, so it also runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import Topology, distribute
from repro_torch.kernels.spmv import bell_spmm, bell_spmm_plain, bell_tiles
from repro_torch.sparse.generate import banded_coo

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


@pytest.mark.parametrize("bm,bn", [(8, 8), (8, 16), (16, 16), (8, 128), (128, 128)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float16, 2e-2)])
def test_kernel_matches_plain_and_is_column_stable(cuda, bm, bn, dtype, tol):
    rng = np.random.default_rng(bm * 1000 + bn)
    tiles, rows, src, counts, nrb, nsrc = _tile_set(rng, bm, bn)
    bt = bell_tiles(torch.as_tensor(tiles, device=cuda).to(dtype), rows, src, counts, nrb)
    x = torch.as_tensor(rng.standard_normal((3, nsrc, bn, 8)).astype(np.float32),
                        device=cuda).to(dtype)
    before = bell_spmm.launches
    y = bell_spmm(bt, x)
    assert bell_spmm.launches == before + 1
    y_plain = bell_spmm_plain(bt.tiles, bt.tile_row, bt.tile_src, bt.counts, x, nrb)
    # Relative to the result's scale: FMA and separate multiply-add round apart.
    assert float((y - y_plain).abs().max() / y_plain.abs().max()) <= tol
    assert torch.equal(y, bell_spmm(bt, x))
    for j in range(8):
        assert torch.equal(y[..., j:j + 1], bell_spmm(bt, x[..., j:j + 1].contiguous()))


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
