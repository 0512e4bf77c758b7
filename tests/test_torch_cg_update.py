"""CG's fused vector update (``repro_torch/kernels/spmv/cg_update.py``) on
the CPU: a CPU session's device loop takes the plain update and counts no
fused iteration; the grid follows from N, B and the SM count alone; the
buffers refuse what the kernel does not take; a broken-down row stays as
it was. The fused loop's bookkeeping (the residual buffer, the breakdown
read, the ``tol`` stop) runs here over an emulation of the kernel made
of the plain update, and must give the plain loop's result bitwise. The
kernel itself is checked on the card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

import repro_torch.api.solvers as solvers
from repro_torch import trace
from repro_torch.api import Topology, distribute
from repro_torch.kernels.spmv.cg_update import (
    CG_MIN_PER_THREAD,
    CG_THREADS,
    CgBuffers,
    cg_buffers,
    cg_grid,
    cg_update_plain,
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
def test_a_cpu_session_takes_the_plain_update(session, monkeypatch, batch):
    def refuse(*args, **kw):
        raise AssertionError("the fused loop ran on a CPU session")

    monkeypatch.setattr(solvers, "_cg_loop_fused", refuse)
    trace.enable()
    res = session.solve("cg", b=_rhs(batch), iters=6, tol=0.0, device_loop=True)
    trace.disable()
    assert res.iters_run == 6
    assert trace.counters().get("cg.fused_iters", 0) == 0


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
    with pytest.raises(ValueError, match="CUDA"):
        cg_buffers(z, z.clone(), z.clone(), rs, 4)
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
    z2, r2, p2, rs2, ok = cg_update_plain(z, r, p, ap, rs)
    assert ok.tolist() == [True, False, True]
    for new, old in ((z2, z), (r2, r), (p2, p)):
        assert torch.equal(new[1], old[1]) and not torch.equal(new[0], old[0])
        assert new.dtype == torch.float32
    assert rs2[1] == rs[1] and rs2.dtype == torch.float64


def _emulated_buffers(z, r, p, rs, iters):
    batch = 1 if z.dim() == 1 else z.shape[0]
    return CgBuffers(z=z.contiguous(), r=r.contiguous(), p=p.contiguous(),
                     rs=rs.reshape(1, batch).repeat(2, 1), ok=torch.zeros(batch, dtype=torch.int32),
                     dots=torch.zeros(batch, 1, dtype=torch.float64),
                     part=torch.zeros(batch, 1, dtype=torch.float64),
                     resid=torch.full((iters,), float("nan"), dtype=torch.float64), grid=1)


def _emulated_update(buf, ap, k):
    """What the kernel's three launches do, in the plain update's arithmetic."""
    rs = buf.rs[(k - 1) % 2]
    z, r, p, rs_new, ok = cg_update_plain(buf.z, buf.r, buf.p, ap,
                                          rs[0] if buf.z.dim() == 1 else rs)
    buf.z.copy_(z)
    buf.r.copy_(r)
    buf.p.copy_(p)
    buf.rs[k % 2] = rs_new
    buf.ok.copy_(ok.reshape(-1))
    buf.resid[k - 1] = buf.rs[k % 2].sqrt().max()


@pytest.mark.parametrize("case", ["batched", "single", "zero_single", "zero_row", "tol"])
def test_the_fused_loop_keeps_the_plain_loops_bookkeeping(session, monkeypatch, case):
    b = _rhs(0 if case in ("single", "zero_single", "tol") else 3)
    iters, tol = 8, 0.0
    if case == "zero_single":
        b = np.zeros(N, np.float32)
    elif case == "zero_row":
        b[1] = 0.0
    elif case == "tol":
        iters, tol = 200, 1e-3
    plain = session.solve("cg", b=b, iters=iters, tol=tol, device_loop=True)
    monkeypatch.setattr(solvers, "cg_buffers", _emulated_buffers)
    monkeypatch.setattr(solvers, "cg_update", _emulated_update)
    monkeypatch.setattr(solvers, "_cg_loop_plain", solvers._cg_loop_fused)
    trace.enable()
    fused = session.solve("cg", b=b, iters=iters, tol=tol, device_loop=True)
    trace.disable()
    assert trace.counters()["cg.fused_iters"] == fused.iters_run
    assert fused.iters_run == plain.iters_run and fused.converged == plain.converged
    assert fused.residuals == plain.residuals and fused.value == plain.value
    assert np.array_equal(fused.x, plain.x) and fused.x.shape == b.shape
    if case == "zero_single":
        assert fused.iters_run == 1 and fused.residuals == [0.0]
    if case == "zero_row":
        assert not fused.x[1].any()
    if case == "tol":
        assert fused.converged and fused.iters_run < iters
