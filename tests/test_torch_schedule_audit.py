"""The schedule audit of the port (:mod:`repro_torch.analysis.schedule_audit`):
golden schedule pins per combo × exchange, on the CPU.

The counterparts of ``tests/test_jaxpr_audit.py``. Every pin runs the
real ``shard_map`` step (:func:`repro_torch.pmvc.dist.make_pmvc_step`)
once over a recording communicator that emulates one rank — no process
group, no card. The golden strings are the JAX package's, compared
directly: ``golden_signature`` computes them without tracing, so the
pins hold although the JAX package's own traced pins fail on this JAX.
The overlap pins are the load-bearing ones: all K all_to_alls are
issued before the first contraction.
"""
import pytest
import torch

from repro.analysis.jaxpr_audit import golden_signature as jx_golden_signature
from repro_torch.analysis import (
    audit_schedule,
    audit_session,
    golden_signature,
    schedule_signature,
    trace_pmvc_step,
)
from repro_torch.api import Topology, distribute
from repro_torch.pmvc.dist import Event, LocalCommunicator, make_pmvc_step, make_unit_mesh
from repro_torch.sparse.generate import PAPER_SUITE, generate, random_coo
from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

TOPO = Topology(nodes=2, cores=2)
COMBOS = ("NL-HL", "NL-HC", "NC-HL", "NC-HC")


def _session(exchange, combo="NL-HL"):
    a = generate(PAPER_SUITE["bcsstm09"], seed=0)
    return distribute(a, topology=TOPO, combo=combo, exchange=exchange, device="cpu")


@pytest.mark.parametrize("exchange", [None, "replicated", "selective", "overlap",
                                      "overlap:1", "overlap:2", "overlap:3"])
@pytest.mark.parametrize("waves", [1, 2, 3])
def test_golden_signature_is_the_jax_one(exchange, waves):
    assert golden_signature(exchange, waves) == jx_golden_signature(exchange, waves)


def test_golden_signature_shape():
    assert golden_signature(None) == "dot psum"
    assert golden_signature("selective") == "a2a dot psum"
    assert golden_signature("overlap", 2) == "a2a a2a dot dot dot psum"
    with pytest.raises(ValueError):
        golden_signature("carrier-pigeon")


@pytest.mark.parametrize("combo", COMBOS)
@pytest.mark.parametrize("waves", [1, 2])
def test_overlap_pins_all_combos(combo, waves):
    rep = audit_session(_session(f"overlap:{waves}", combo))
    assert rep.ok, str(rep)
    assert rep.exchange == "overlap" and rep.waves == waves
    assert rep.signature == golden_signature("overlap", waves)


@pytest.mark.parametrize("exchange", ["replicated", "selective"])
def test_flat_exchange_pins(exchange):
    rep = audit_session(_session(exchange))
    assert rep.ok, str(rep)
    assert rep.signature == golden_signature(exchange)


def test_batched_trace_keeps_schedule():
    """One collective carries all B vectors: the batched step's schedule
    is the single vector's, contractions included."""
    sess = _session("overlap:2")
    events = trace_pmvc_step(sess.device_plan, sess.selective, batch=4, device="cpu")
    assert schedule_signature(events) == golden_signature("overlap", 2)
    assert all(e.dtypes == (torch.float32, torch.float32) for e in events if e.op == "dot")


def test_overlap_plan_run_blocking():
    """``overlap=False`` runs an overlap plan's selective schedule, as
    the JAX package's ``make_pmvc_step`` does."""
    sess = _session("overlap:2")
    comm = LocalCommunicator(log=[])
    dp = sess.device_plan
    step = make_pmvc_step(dp, make_unit_mesh(dp.num_units, comm=comm),
                          selective=sess.selective, overlap=False, device="cpu")
    step(torch.zeros((dp.num_col_blocks, dp.bn)))
    assert schedule_signature(comm.log) == golden_signature("selective")


def test_sixty_four_units_on_one_cpu():
    """A 64-unit schedule, audited in this process with no group."""
    a = random_coo(1024, 12000, seed=3)
    for exchange in ("selective", "overlap:2"):
        sess = distribute(a, topology=Topology(8, 8), exchange=exchange, device="cpu")
        assert sess.device_plan.num_units == 64
        rep = audit_session(sess)
        assert rep.ok, str(rep)


def test_wrong_wave_count_is_flagged():
    sess = _session("overlap:2")
    events = trace_pmvc_step(sess.device_plan, sess.selective, device="cpu")
    findings = audit_schedule(events, expect_waves=3)
    assert any(f.pass_name == "schedule/collective-order" for f in findings)
    assert not audit_schedule(events, expect_waves=2)


def test_hygiene_negatives():
    """A contraction on float16 operands, and a collective issued after
    a contraction, are flagged; a clean log has no finding."""
    f32, f16 = torch.float32, torch.float16
    clean = [Event("a2a"), Event("dot", (f32, f32)), Event("dot", (f32, f32)), Event("psum")]
    assert audit_schedule(clean, expect_waves=1) == []
    half = [Event("dot", (f16, f32)), Event("psum")]
    assert [f.pass_name for f in audit_schedule(half)] == ["schedule/float32"]
    late = [Event("dot", (f32, f32)), Event("a2a"), Event("dot", (f32, f32)), Event("psum")]
    assert {f.pass_name for f in audit_schedule(late, expect_waves=1)} == {
        "schedule/collective-order"}
