"""The serving engine's batch steppers in the port, on CPU tensors.

* Each stepper against the JAX package's for the same graph, payloads
  and active masks — slots loaded mid-stream and frozen — on the
  replicated, selective and ``overlap:2`` exchanges: the same state
  arrays under the same names, within 1e-5 relative.
* ``solve_batch`` ≡ direct batched-of-1 ``solve``, bitwise, within the
  port.
* A snapshot taken from either package's stepper in mid-run restores
  into the other's and continues to the other package's result within
  1e-5.
* ``register_stepper``: a user stepper rides ``solve_batch`` and the
  engine like the built-ins.
"""
import numpy as np
import pytest

import repro.api as jx_api
from repro.sparse.formats import COO as JxCOO
from repro_torch.api import STEPPERS, BatchStepper, Topology, distribute, register_stepper
from repro_torch.serve import SparseServeEngine, Status
from repro_torch.sparse.formats import COO

N = 96
SLOTS = 4
EXCHANGES = ("replicated", "selective", "overlap:2")
SOLVERS = ("cg", "jacobi", "pagerank", "spmv")


def _sym_coo(seed, n=N, nnz=350):
    """Random symmetric COO with a dominant diagonal: SPD, so every
    stepper (CG included) has a meaningful run on it."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz)
    col = rng.integers(0, n, nnz)
    val = rng.standard_normal(nnz)
    d = np.arange(n)
    key = np.concatenate([row * n + col, col * n + row, d * n + d])
    vals = np.concatenate([val, val, np.full(n, 12.0)])
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.bincount(inv, weights=vals)
    return COO((n, n), (uniq // n).astype(np.int32), (uniq % n).astype(np.int32),
               summed.astype(np.float32))


A = _sym_coo(5)


@pytest.fixture(scope="module", params=EXCHANGES)
def pair(request):
    """(JAX session, port session) for the same matrix and exchange."""
    jx = jx_api.distribute(JxCOO(A.shape, A.row, A.col, A.val), topology=jx_api.Topology(2, 2),
                           block=16, exchange=request.param)
    pt = distribute(A, topology=Topology(2, 2), block=16, exchange=request.param,
                    device="cpu")
    return jx, pt


def _payload(solver, rng):
    v = rng.random(N).astype(np.float32)
    return {"pagerank": {"seeds": v}, "spmv": {"x": v}}.get(solver, {"b": v})


# Per step: which slots are active. Slot 2 is loaded after step 2, slot 0
# freezes after step 4.
MASKS = [np.array(m, bool) for m in (
    [1, 1, 0, 1], [1, 1, 0, 1], [1, 1, 1, 1], [1, 1, 1, 1], [0, 1, 1, 1], [0, 1, 1, 1],
)]


def _run(stepper, payloads, masks, peaks):
    """Load the schedule's payloads (slot 2 before step 2) and step under
    ``masks``; returns the residuals of the active slots, and keeps in
    ``peaks`` each state array's largest magnitude over the run."""
    out = []
    for k, mask in enumerate(masks):
        if k == 0:
            for slot in (0, 1, 3):
                stepper.load(slot, **payloads[slot])
        if k == 2:
            stepper.load(2, **payloads[2])
        out.append(np.asarray(stepper.step(mask))[mask])
        _track(stepper, peaks)
    return np.concatenate(out)


def _track(stepper, peaks):
    for k, v in stepper.snapshot().items():
        peaks[k] = max(peaks.get(k, 0.0), float(np.abs(v).max()))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _same_state(got: dict, ref: dict, peaks: dict):
    """The same ndarray attributes (the JAX package's names, shapes and
    types), each within 1e-5 of its largest magnitude over the run:
    residual-like arrays (Jacobi's and CG's r, p, rs) shrink by
    cancellation as a solve converges, so they are held to the scale the
    solve started from, not to their own."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        diff = np.abs(got[k].astype(np.float64) - ref[k].astype(np.float64)).max()
        assert diff <= 1e-5 * max(peaks.get(k, 0.0), float(np.abs(ref[k]).max())), k


@pytest.mark.parametrize("solver", SOLVERS)
def test_stepper_matches_jax(pair, solver):
    jx, pt = pair
    rng = np.random.default_rng(7)
    payloads = [_payload(solver, rng) for _ in range(SLOTS)]
    s_jx = jx.batch_stepper(solver, SLOTS)
    s_pt = pt.batch_stepper(solver, SLOTS)
    assert isinstance(s_pt, BatchStepper) and s_pt.fixed_iters == s_jx.fixed_iters
    peaks = {}
    _track(s_jx, peaks)
    _same_state(s_pt.snapshot(), s_jx.snapshot(), peaks)
    res_jx = _run(s_jx, payloads, MASKS, peaks)
    res_pt = _run(s_pt, payloads, MASKS, {})
    assert _rel(res_pt, res_jx) <= 1e-5 if solver != "spmv" else not res_pt.any()
    _same_state(s_pt.snapshot(), s_jx.snapshot(), peaks)
    for slot in range(SLOTS):
        assert _rel(s_pt.extract(slot), s_jx.extract(slot)) <= 1e-5


def _direct(sess, solver, payload, **kw):
    if solver == "spmv":
        return sess.spmv(payload["x"][None])[0]
    return sess.solve(solver, **kw, **{k: v[None] for k, v in payload.items()})


@pytest.mark.parametrize("solver,tol", [("pagerank", 2e-3), ("jacobi", 1e-3), ("cg", 1e-4),
                                        ("spmv", 0.0), ("pagerank", 0.0)])
def test_solve_batch_is_direct_solve_bitwise(pair, solver, tol):
    _, pt = pair
    rng = np.random.default_rng(8)
    payloads = [_payload(solver, rng) for _ in range(3)]
    got = pt.solve_batch(solver, payloads, iters=12, tol=tol)
    for res, payload in zip(got, payloads, strict=True):
        ref = _direct(pt, solver, payload, iters=12, tol=tol)
        if solver == "spmv":
            assert np.array_equal(res.x, ref) and res.iters_run == 1
            continue
        assert np.array_equal(res.x, ref.x[0])
        assert res.residuals == ref.residuals
        assert (res.iters_run, res.converged, res.value) == (
            ref.iters_run, ref.converged, ref.value)
    if tol and solver != "spmv":
        assert any(r.converged and r.iters_run < 12 for r in got)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_snapshot_restores_across_packages(pair, solver, direction):
    """Run three steps in one package, carry the snapshot (a dict of numpy
    arrays under the same names) into a fresh stepper of the other, and
    continue there: the result is the first package's own continuation
    within 1e-5."""
    jx, pt = pair
    rng = np.random.default_rng(9)
    payloads = [_payload(solver, rng) for _ in range(SLOTS)]
    src, dst = (jx, pt) if direction == "jax_to_port" else (pt, jx)
    s_src = src.batch_stepper(solver, SLOTS)
    peaks = {}
    _run(s_src, payloads, MASKS[:3], peaks)
    snap = s_src.snapshot()
    assert all(isinstance(v, np.ndarray) for v in snap.values())
    s_dst = dst.batch_stepper(solver, SLOTS)
    s_dst.restore(snap)
    for mask in MASKS[3:]:
        s_src.step(mask)
        s_dst.step(mask)
        _track(s_src, peaks)
    _same_state(s_dst.snapshot(), s_src.snapshot(), peaks)


class _PowerStepStepper(BatchStepper):
    """A user stepper: y ← A·y / ‖A·y‖ per row (a per-row normalized
    power step), residual ‖y_new − y‖."""

    solver = "power_rows"

    def __init__(self, session, slots, *, scale=1.0):
        super().__init__(session, slots)
        self.scale = float(scale)
        self.y = np.zeros((self.slots, self.n), np.float32)

    def load(self, slot, *, x):
        self.y[slot] = np.asarray(x, np.float32)

    def step(self, active):
        y = self.session.spmv(self.y) * np.float32(self.scale)
        y = (y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-30)).astype(
            np.float32)
        res = np.linalg.norm(y - self.y, axis=-1)
        self.y = np.where(active[:, None], y, self.y)
        return res

    def extract(self, slot):
        return self.y[slot].copy()


def test_register_stepper_user_entry(pair, monkeypatch):
    _, pt = pair
    monkeypatch.setattr(STEPPERS, "_entries", dict(STEPPERS._entries))  # restored after
    register_stepper("power_rows")(lambda sess, slots, **cfg: _PowerStepStepper(sess, slots, **cfg))
    with pytest.raises(ValueError, match="already registered"):
        register_stepper("power_rows", _PowerStepStepper)
    rng = np.random.default_rng(10)
    xs = [rng.random(N).astype(np.float32) for _ in range(3)]
    batch = pt.solve_batch("power_rows", [{"x": x} for x in xs], iters=5, scale=2.0)
    eng = SparseServeEngine(batch_slots=2, default_iters=5)
    eng.register_graph("g", pt)
    tickets = [eng.submit("g", "power_rows", payload={"x": x}, scale=2.0) for x in xs]
    eng.run_until_drained()
    for x, res, t in zip(xs, batch, tickets, strict=True):
        y = x[None]
        for _ in range(5):  # the direct loop, one row
            y = pt.spmv(y) * np.float32(2.0)
            y = (y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-30)).astype(
                np.float32)
        assert np.array_equal(res.x, y[0]) and res.iters_run == 5
        assert t.status is Status.DONE and np.array_equal(t.result.x, y[0])
