"""CG's vector update (``repro_torch/kernels/spmv/cg_update.py``) on the
CPU: a CPU session's device loop takes the plain update and launches no
kernel; the grid follows from N, B and the SM count alone; the buffers
and the update refuse what they do not take; a broken-down row stays as
it was. The device loop's bookkeeping (the residual buffer, the
breakdown read, the ``tol`` stop) is held against the host loop on the
same session. The kernels themselves are checked on the card
(``tests/test_torch_gpu.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.api import Topology, distribute
from repro_torch.kernels.spmv.cg_update import (
    CG_MIN_PER_THREAD,
    CG_THREADS,
    cg_buffers,
    cg_grid,
    cg_update,
)
from repro_torch.sparse.formats import COO
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

N = 96


def _spd(n=N, seed=5):
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((n, n)) < 0.08, rng.standard_normal((n, n)), 0.0)
    d = (m @ m.T + n * np.eye(n)).astype(np.float32)
    row, col = np.nonzero(d)
    return COO(d.shape, row.astype(np.int32), col.astype(np.int32), d[row, col])


@pytest.fixture(scope="module")
def session():
    return distribute(_spd(), topology=Topology(2, 2), combo="NL-HC", exchange="selective",
                      block=8, device="cpu")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable()
    trace.disable()
    yield
    trace.enable()
    trace.disable()


def _rhs(batch):
    b = np.random.default_rng(11).standard_normal((max(batch, 1), N)).astype(np.float32)
    return b if batch else b[0]


@pytest.mark.parametrize("batch", [0, 1, 3])
def test_a_cpu_session_takes_the_plain_update(session, batch):
    before = cg_update.launches
    res = session.solve("cg", b=_rhs(batch), iters=6, tol=0.0, device_loop=True)
    assert res.iters_run == 6
    assert cg_update.launches == before


@pytest.mark.parametrize("n,batch,sms,grid", [
    (262144, 1, 132, 256),  # HPCG 64^3, one right-hand side: 4 elements a thread
    (262144, 8, 132, 33),  # two blocks an SM over the rows
    (32768, 1, 132, 32),
    (4096, 3, 132, 4),
    (10, 8, 132, 1),
    (262144, 1000, 132, 1),
    (1, 1, 1, 1),
])
def test_the_grid_follows_n_batch_and_sms(n, batch, sms, grid):
    assert cg_grid(n, batch, sms) == grid
    assert grid == 1 or n >= grid * CG_THREADS * CG_MIN_PER_THREAD  # enough work a thread


def test_the_buffers_refuse_what_the_kernel_does_not_take():
    z = torch.zeros(2, 8)
    rs = torch.zeros(2, dtype=torch.float64)
    meta = z.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        cg_buffers(meta, meta, meta, rs.to("meta"), 4)
    with pytest.raises(ValueError, match="one device"):
        cg_buffers(z, meta, z.clone(), rs, 4)
    on_meta = dataclasses.replace(cg_buffers(z, z.clone(), z.clone(), rs, 4), p=meta)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        cg_update(on_meta, meta, 1)
    with pytest.raises(TypeError):
        cg_buffers(z.double(), z.double(), z.double(), rs, 4)
    with pytest.raises(ValueError, match="shape"):
        cg_buffers(z, z[:1].clone(), z.clone(), rs, 4)


def test_the_plain_update_freezes_a_broken_down_row():
    rng = np.random.default_rng(3)
    z, r, p, ap = (torch.as_tensor(rng.standard_normal((3, 16)).astype(np.float32))
                   for _ in range(4))
    p[1] = 0.0  # pᵀAp = 0: row 1 breaks down
    rs = (r.double() ** 2).sum(-1)
    buf = cg_buffers(z.clone(), r.clone(), p.clone(), rs, 1)
    assert buf.grid == 1
    before = cg_update.launches
    cg_update(buf, ap, 1)
    assert cg_update.launches == before
    assert buf.ok.tolist() == [1, 0, 1]
    for new, old in ((buf.z, z), (buf.r, r), (buf.p, p)):
        assert torch.equal(new[1], old[1]) and not torch.equal(new[0], old[0])
        assert new.dtype == torch.float32
    assert buf.rs[1, 1] == rs[1] and buf.rs.dtype == torch.float64
    assert buf.resid[0] == buf.rs[1].sqrt().max()


@pytest.mark.parametrize("case", ["batched", "single", "zero_single", "zero_row", "tol"])
def test_the_fused_loop_keeps_the_plain_loops_bookkeeping(session, case):
    """The device loop against the host loop on the same session: the same
    iterations, verdict and residual count, the residuals within 1e-5
    and x within 1e-6."""
    b = _rhs(0 if case in ("single", "zero_single", "tol") else 3)
    iters, tol = 8, 0.0
    if case == "zero_single":
        b = np.zeros(N, np.float32)
    elif case == "zero_row":
        b[1] = 0.0
    elif case == "tol":
        iters, tol = 200, 1e-3
    host = session.solve("cg", b=b, iters=iters, tol=tol)
    dev = session.solve("cg", b=b, iters=iters, tol=tol, device_loop=True)
    assert dev.iters_run == host.iters_run and dev.converged == host.converged
    assert len(dev.residuals) == len(host.residuals)
    np.testing.assert_allclose(dev.residuals, host.residuals, rtol=1e-5)
    assert dev.value == pytest.approx(host.value, rel=1e-5)
    assert dev.x.shape == b.shape and np.abs(dev.x - host.x).max() <= 1e-6
    if case == "zero_single":
        assert dev.iters_run == 1 and dev.residuals == [0.0]
    if case == "zero_row":
        assert not dev.x[1].any()
    if case == "tol":
        assert dev.converged and dev.iters_run < iters
