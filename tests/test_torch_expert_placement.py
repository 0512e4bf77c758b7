"""The port's MoE expert placement: every case of
``tests/test_expert_placement.py`` on the port, and the same routing
samples placed by both packages — identical permutations, loads, balance
and cuts (the port keeps its own copy of the planners)."""
import numpy as np
import pytest
import torch

from repro.core.expert_placement import plan_placement as ref_plan_placement
from repro_torch.core.expert_placement import (
    apply_placement,
    coactivation_hypergraph,
    plan_placement,
)


def _skewed_routing(t=2000, e=16, k=2, seed=0):
    """Co-activation structure: experts 2i and 2i+1 fire together."""
    rng = np.random.default_rng(seed)
    pair = rng.integers(0, e // 2, size=t)
    jitter = rng.integers(0, 2, size=t)
    return np.stack([2 * pair, 2 * pair + (1 - jitter) * 1], axis=1) % e


@pytest.mark.parametrize("mode", ["nezgt", "hyper"])
def test_equal_experts_per_device(mode):
    eot = _skewed_routing()
    res = plan_placement(eot, 16, 4, mode=mode)
    counts = np.bincount(res.device_of_expert, minlength=4)
    assert (counts == 4).all()
    assert sorted(res.perm.tolist()) == list(range(16))


def test_hyper_placement_cuts_coactivation():
    """Hypergraph placement must beat the naive contiguous placement on
    co-activation cut (fewer duplicate token sends — paper C_Xk)."""
    eot = _skewed_routing(seed=1)
    res = plan_placement(eot, 16, 4, mode="hyper")
    assert res.cut <= res.cut_naive


def test_nezgt_placement_balances_load():
    rng = np.random.default_rng(2)
    # Zipf-ish expert popularity.
    p = 1.0 / np.arange(1, 17) ** 1.2
    p /= p.sum()
    eot = rng.choice(16, size=(4000, 2), p=p)
    res = plan_placement(eot, 16, 4, mode="nezgt")
    naive_loads = np.bincount(np.arange(16) // 4, weights=np.bincount(eot.reshape(-1), minlength=16), minlength=4)
    naive_lb = naive_loads.max() / naive_loads.mean()
    assert res.lb <= naive_lb + 1e-9


@pytest.mark.parametrize("as_tensor", [False, True])
def test_apply_placement_permutes_consistently(as_tensor):
    e, d, f = 8, 4, 6
    params = {
        "router": np.arange(d * e, dtype=np.float32).reshape(d, e),
        "w_gate": np.arange(e * d * f, dtype=np.float32).reshape(e, d, f),
        "w_up": np.ones((e, d, f), np.float32),
        "w_down": np.ones((e, f, d), np.float32),
    }
    if as_tensor:
        params = {k: torch.tensor(v) for k, v in params.items()}
    perm = np.array([3, 1, 0, 2, 7, 6, 5, 4], dtype=np.int32)
    out = apply_placement(params, perm)
    # Routing to permuted slot j must hit old expert perm[j].
    np.testing.assert_array_equal(np.asarray(out["w_gate"][0]), np.asarray(params["w_gate"][3]))
    np.testing.assert_array_equal(np.asarray(out["router"][:, 0]), np.asarray(params["router"][:, 3]))


def test_coactivation_hypergraph_structure():
    eot = np.array([[0, 1], [0, 1], [2, 3]])
    hg = coactivation_hypergraph(eot, 4)
    assert hg.num_vertices == 4
    assert hg.num_nets == 3
    # expert 0 participates in tokens 0,1
    assert (hg.v_ptr[1] - hg.v_ptr[0]) == 2


@pytest.mark.parametrize("mode", ["nezgt", "hyper"])
@pytest.mark.parametrize("seed,e,ranks,k", [(0, 16, 4, 2), (3, 32, 8, 8), (5, 64, 4, 6)])
def test_placement_equals_the_reference(mode, seed, e, ranks, k):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, e + 1) ** 1.1
    eot = np.stack([rng.choice(e, size=k, replace=False, p=p / p.sum())
                    for _ in range(1500)])
    mine = plan_placement(eot, e, ranks, mode=mode, seed=seed)
    ref = ref_plan_placement(eot, e, ranks, mode=mode, seed=seed)
    for field in ("perm", "device_of_expert", "loads"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(ref, field), err_msg=field)
    assert (mine.lb, mine.cut, mine.cut_naive) == (ref.lb, ref.cut, ref.cut_naive)
