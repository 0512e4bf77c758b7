"""The roofline counts against hand-worked cases, and the spmv's bound
free of the plan."""
import numpy as np
import pytest

from portbench.harness import plan
from portbench.matrices import Matrix, make_graphs
from portbench.roofline import (PEAK_BYTES_PER_S, PEAK_F32_FLOPS, bell_spmm_counts, bound_s,
                                csr_spmv_counts)


def test_csr_counts_by_hand():
    # 3 x 3 with 5 non-zeros at B = 2: values and columns 5 * 8, row
    # pointers 4 * 4, x 3 * 2 * 4, y 3 * 2 * 4; 2 * 5 * 2 operations.
    assert csr_spmv_counts(5, 3, 3, 2) == (40 + 16 + 24 + 24, 20.0)


def test_bell_counts_by_hand():
    # 10 real 2 x 4 tiles, 3 units of 5 block-rows, 7 source blocks, B = 3.
    b, f = bell_spmm_counts(10, 2, 4, 3, 5, 7, 3)
    assert b == 10 * 8 * 4 + 10 * 4 + 3 * 6 * 4 + 7 * 4 * 3 * 4 + 3 * 5 * 2 * 3 * 4
    assert f == 2.0 * 10 * 8 * 3


def test_bound_is_the_larger_term():
    assert bound_s(PEAK_BYTES_PER_S, 1.0) == pytest.approx(1.0)
    assert bound_s(1.0, 2 * PEAK_F32_FLOPS) == pytest.approx(2.0)


@pytest.mark.parametrize("batch", [1, 8])
def test_spmv_bound_does_not_move_with_the_plans_block(batch):
    cfg = {"generator": "stencil27", "nx": 9, "ny": 10, "nz": 11,
           "plan": {"nodes": 2, "cores": 2, "combo": "NL-HC", "exchange": "selective",
                    "seed": 0, "executor": "simulate"}}
    graphs = {"a": make_graphs(cfg, 3)["a"]}
    bounds, tiles = [], []
    for block in (8, 16):
        cfg["plan"]["block"] = block
        _, _, facts = plan(cfg, graphs, "cpu")
        f = facts["a"]
        bounds.append(bound_s(*csr_spmv_counts(f["nnz"], f["n"], f["n"], batch)))
        tiles.append(bound_s(*bell_spmm_counts(f["real_tiles"], f["bm"], f["bn"], f["units"],
                                               f["nrb"], f["xsrc_blocks"], batch)))
    assert bounds[0] == bounds[1]
    assert tiles[0] != tiles[1]


def test_plan_facts_of_a_small_matrix():
    m = Matrix(4, np.array([0, 1, 2, 3, 0], np.int32), np.array([0, 1, 2, 3, 3], np.int32),
               np.ones(5, np.float32))
    cfg = {"plan": {"nodes": 1, "cores": 2, "combo": "NL-HC", "exchange": "replicated",
                    "block": 2, "seed": 0, "executor": "simulate"}}
    _, seconds, facts = plan(cfg, {"a": m}, "cpu")
    f = facts["a"]
    assert seconds > 0 and f["nnz"] == 5 and f["n"] == 4 and f["units"] == 2
    assert f["xsrc_blocks"] == f["ncb"] == 2 and f["real_tiles"] >= 2
