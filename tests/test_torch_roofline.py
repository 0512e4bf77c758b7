"""The port's roofline analysis against the JAX package's
(``tests/test_roofline.py``), and its own cost counter.

* ``parse_collectives`` on the reference test's HLO text gives the
  reference's bytes and counts;
* ``roofline_terms`` gives the reference's terms, ``dominant`` and
  ``mfu`` once the reference's TPU rates are passed in;
* ``model_flops`` is the reference's for every arch × shape;
* ``step_costs`` counts a known product exactly (FLOPs and bytes), an
  ``all_reduce`` on a fake group of 4 ranks at the wire model's 2×, and
  a DTensor product per device: a quarter of ``FlopCounterMode``'s
  global count on a ``(2, 2)`` mesh.
"""
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro import roofline as J
from repro.config import SHAPES as J_SHAPES
from repro.config import get_arch as j_get_arch
from repro.configs import ARCH_IDS
from repro_torch.config import SHAPES, get_arch
from repro_torch.roofline import (
    CHIP,
    HBM_BW,
    ICI_BW,
    LINK_BW,
    PEAK_FLOPS_BF16,
    model_flops,
    parse_collectives,
    roofline_terms,
    step_costs,
)
from test_roofline import _FAKE_HLO

_TUPLE_HLO = """
  %ars = (f32[8,8]{1,0}, f32[8,8]{1,0}) all-reduce-start(%a, %b), to_apply=%add
  %ags = bf16[4,256]{1,0} all-gather-start(%c), dimensions={1}
  %cps = u32[2]{0} collective-permute-start(%d), source_target_pairs={{0,1}}
  %dot = f32[16,16]{1,0} dot(%cp, %cp)
"""


@pytest.mark.parametrize("hlo", [_FAKE_HLO, _TUPLE_HLO, "%dot = f32[8,8]{1,0} dot(%a, %b)"],
                         ids=["reference", "async-tuples", "no-collective"])
def test_parse_collectives_matches_the_reference(hlo):
    got, ref = parse_collectives(hlo), J.parse_collectives(hlo)
    assert got.bytes_by_op == ref.bytes_by_op
    assert got.count_by_op == ref.count_by_op
    assert got.wire_bytes == ref.wire_bytes and got.total_count == ref.total_count


def test_card_constants():
    assert PEAK_FLOPS_BF16 == 989e12 and HBM_BW == 3.35e12 and LINK_BW == 450e9
    assert ICI_BW == LINK_BW
    assert set(CHIP) >= {"peak_flops_bf16", "hbm_bw", "link_bw", "hbm_bytes"}
    assert CHIP["hbm_bytes"] == 80 * 2**30 and CHIP["smem_bytes"] == 228 * 2**10


@pytest.mark.parametrize("terms", [
    dict(hlo_flops=197e12, hlo_bytes=819e9 / 2, collective_bytes=50e9 / 4, chips=1,
         mflops=197e12 * 0.5),
    dict(hlo_flops=1e12, hlo_bytes=819e9 * 3, collective_bytes=50e9, chips=4, mflops=2e12),
    dict(hlo_flops=1e9, hlo_bytes=1e9, collective_bytes=50e9 * 9, chips=2, mflops=1e9),
], ids=["compute", "memory", "collective"])
def test_roofline_terms_match_the_reference(terms):
    ref = J.roofline_terms(**terms)
    tpu = roofline_terms(**terms, peak_flops=J.PEAK_FLOPS_BF16, hbm_bw=J.HBM_BW,
                         link_bw=J.ICI_BW)
    for field in ("compute_s", "memory_s", "collective_s", "step_time_s", "useful_flop_ratio",
                  "mfu"):
        assert getattr(tpu, field) == pytest.approx(getattr(ref, field), rel=1e-12), field
    assert tpu.dominant == ref.dominant
    card = roofline_terms(**terms)
    assert card.compute_s == terms["hlo_flops"] / (terms["chips"] * PEAK_FLOPS_BF16)
    assert card.memory_s == terms["hlo_bytes"] / (terms["chips"] * HBM_BW)
    assert card.collective_s == terms["collective_bytes"] / (terms["chips"] * LINK_BW)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_matches_the_reference(arch):
    for shape in SHAPES:
        assert model_flops(get_arch(arch), SHAPES[shape]) == J.model_flops(
            j_get_arch(arch), J_SHAPES[shape])


def test_step_costs_of_a_product():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    costs, coll, out = step_costs(lambda x, y: torch.relu(x @ y), a, b)
    assert costs["flops"] == 2 * 64 * 32 * 16
    # mm reads a and b and writes 64 × 16; relu reads and writes 64 × 16.
    assert costs["bytes accessed"] == 4 * (64 * 32 + 32 * 16 + 64 * 16 + 2 * 64 * 16)
    assert coll.total_count == 0 and out.shape == (64, 16)


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_step_costs_of_an_all_reduce(fake_group):
    t = torch.ones(256, 128)
    costs, coll, _ = step_costs(lambda x: funcol.all_reduce(x, "sum", dist.group.WORLD).wait(), t)
    assert coll.count_by_op == {"all-reduce": 1}
    assert coll.bytes_by_op == {"all-reduce": 256 * 128 * 4}
    assert coll.wire_bytes == 2 * 256 * 128 * 4
    assert costs["flops"] == 0


def test_step_costs_count_local_shards(fake_group):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0), Replicate()], src_data_rank=None)
    w = distribute_tensor(torch.randn(32, 16), mesh, [Replicate(), Shard(1)], src_data_rank=None)
    costs, coll, out = step_costs(torch.matmul, x, w)
    with FlopCounterMode(display=False) as counter:
        torch.matmul(x, w)
    assert counter.get_total_flops() == 2 * 64 * 32 * 16  # global shapes
    assert costs["flops"] == 2 * 64 * 32 * 16 / 4  # this rank's shards
    assert coll.total_count == 0 and tuple(out.to_local().shape) == (32, 8)
