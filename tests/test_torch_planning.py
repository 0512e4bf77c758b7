"""The port's copied planners against the JAX package's: the same matrix,
topology, combo and seed give bit-identical partitions, device plans,
selective and overlap plans, the same auto-locality winner, and exactly
equal phase costs."""
import dataclasses

import numpy as np
import pytest

import repro.api as jx
import repro_torch.api as pt
from repro.api.exchange import resolve_exchange as jx_resolve_exchange
from repro.pmvc.dist import phase_costs as jx_phase_costs
from repro.sparse.generate import PAPER_SUITE, generate
from repro_torch.pmvc.dist import phase_costs as pt_phase_costs
from repro_torch.sparse.formats import COO as PtCOO
from repro_torch.sparse.generate import PAPER_SUITE as PT_SUITE
from repro_torch.sparse.generate import generate as pt_generate

COMBOS = ("NL-HL", "NL-HC", "NC-HL", "NC-HC")
MATRICES = ("bcsstm09", "t2dal", "thermal")
TOPO = (2, 2)


def _port_coo(a):
    return PtCOO(a.shape, a.row, a.col, a.val)


def _assert_dataclass_equal(x, y, path="plan"):
    assert type(x).__name__ == type(y).__name__, path
    for f in dataclasses.fields(x):
        vx, vy = getattr(x, f.name), getattr(y, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(vx):
            _assert_dataclass_equal(vx, vy, where)
        elif isinstance(vx, np.ndarray):
            assert vx.dtype == vy.dtype, where
            np.testing.assert_array_equal(vx, vy, err_msg=where)
        else:
            assert vx == vy, where


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("combo", COMBOS)
def test_generators_and_plans_bit_identical(name, combo):
    a = generate(PAPER_SUITE[name], seed=0)
    a_pt = pt_generate(PT_SUITE[name], seed=0)
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(a_pt, f), getattr(a, f))

    j = jx.distribute(a, topology=jx.Topology(*TOPO), combo=combo,
                      exchange="selective")
    p = pt.distribute(a_pt, topology=pt.Topology(*TOPO), combo=combo,
                      exchange="selective", device="cpu")
    np.testing.assert_array_equal(p.partition.elem_unit, j.partition.elem_unit)
    _assert_dataclass_equal(p.device_plan, j.device_plan, "device_plan")
    _assert_dataclass_equal(p.selective, j.selective, "selective")
    for waves in (1, 2):
        ex = f"overlap:{waves}"
        _assert_dataclass_equal(
            pt.resolve_exchange(ex)(p.device_plan),
            jx_resolve_exchange(ex)(j.device_plan),
            ex,
        )
    jc, pc = j.costs(batch=8), p.costs(batch=8)
    assert jc.keys() == pc.keys()
    for k in jc:
        assert pc[k] == jc[k], k


@pytest.mark.parametrize("combo", COMBOS)
def test_auto_locality_sweep_picks_the_same_plan(combo):
    a = generate(PAPER_SUITE["t2dal"], seed=0)
    j = jx.distribute(a, topology=jx.Topology(*TOPO), combo=combo,
                      exchange="overlap:2")
    p = pt.distribute(_port_coo(a), topology=pt.Topology(*TOPO), combo=combo,
                      exchange="overlap:2", device="cpu")
    np.testing.assert_array_equal(p.partition.elem_unit, j.partition.elem_unit)
    _assert_dataclass_equal(p.device_plan, j.device_plan, "device_plan")
    _assert_dataclass_equal(p.selective, j.selective, "overlap")


@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap", "overlap:3"])
@pytest.mark.parametrize("batch", [1, 8])
def test_phase_costs_equal_exactly(exchange, batch):
    a = generate(PAPER_SUITE["t2dal"], seed=0)
    j = jx.distribute(a, topology=jx.Topology(2, 2), combo="NL-HC",
                      exchange=exchange)
    p = pt.distribute(_port_coo(a), topology=pt.Topology(2, 2), combo="NL-HC",
                      exchange=exchange, device="cpu")
    assert pt_phase_costs(p.device_plan, p.selective, batch=batch) == jx_phase_costs(
        j.device_plan, j.selective, batch=batch
    )
    kw = {"link_bytes_per_s": 3e9, "unit_flops_per_s": 1e11}
    assert pt_phase_costs(p.device_plan, p.selective, **kw) == jx_phase_costs(
        j.device_plan, j.selective, **kw
    )
