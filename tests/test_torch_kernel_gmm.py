"""The grouped-matmul entry point on CPU tensors (the plain version) against
the JAX package's Pallas ``gmm`` run in interpret mode — every case of
``tests/test_kernels_gmm.py`` — plus ``plan_groups`` bit-identical to the
reference's, the dispatch round trip, and the wrapper's checks.

Tolerances are the reference tests': 2e-4 for float32 and 8e-2 for
bfloat16 (rtol and atol), since both sides sum in float32 in different
orders and bf16 outputs round apart by up to one bf16 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmm import grouped_matmul as jx_grouped_matmul
from repro.kernels.gmm import plan_groups as jx_plan_groups
from repro_torch.kernels.gmm import gmm, gmm_plain, gmm_variant, grouped_matmul, plan_groups

TOL = {"float32": 2e-4, "bfloat16": 8e-2}
JX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(x, w, gid, dtype, out_dtype, **tiles):
    """The Pallas kernel (interpret mode) and the port on the same numpy
    inputs, both as float32 numpy."""
    y_jx = jx_grouped_matmul(jnp.asarray(x, JX[dtype]), jnp.asarray(w, JX[dtype]),
                             jnp.asarray(gid), out_dtype=JX[out_dtype], interpret=True,
                             **tiles)
    y_pt = grouped_matmul(torch.as_tensor(x).to(PT[dtype]), torch.as_tensor(w).to(PT[dtype]),
                          torch.as_tensor(gid), out_dtype=PT[out_dtype], **tiles)
    assert y_pt.dtype == PT[out_dtype]
    return np.asarray(y_jx, np.float32), y_pt.float().numpy()


@pytest.mark.parametrize("e,k,n,bm,bk,bn", [
    (4, 32, 64, 8, 16, 32),
    (8, 64, 128, 16, 32, 64),
    (2, 16, 16, 8, 8, 8),
])
def test_gmm_matches_pallas(e, k, n, bm, bk, bn):
    rng = np.random.default_rng(0)
    m_tiles = 2 * e
    x = rng.standard_normal((m_tiles * bm, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    gid = rng.integers(0, e, size=m_tiles).astype(np.int32)
    y_jx, y_pt = _both(x, w, gid, "float32", "float32", bm=bm, bk=bk, bn=bn)
    np.testing.assert_allclose(y_pt, y_jx, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_gmm_dtypes_match_pallas(dtype, out_dtype):
    rng = np.random.default_rng(1)
    e, k, n, bm = 4, 16, 32, 8
    m = 8 * bm
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    gid = rng.integers(0, e, size=m // bm).astype(np.int32)
    y_jx, y_pt = _both(x, w, gid, dtype, out_dtype, bm=bm, bk=16, bn=32)
    tol = max(TOL[dtype], TOL[out_dtype])
    np.testing.assert_allclose(y_pt, y_jx, rtol=tol, atol=tol)


@pytest.mark.parametrize("seed,e,bm,tokens", [
    (0, 6, 8, 100), (1, 32, 128, 3000), (2, 4, 16, 7), (3, 8, 8, 0), (4, 5, 8, 64),
])
def test_plan_groups_bit_identical(seed, e, bm, tokens):
    rng = np.random.default_rng(seed)
    expert_of_token = rng.integers(0, e - 1, size=tokens)  # expert e-1 gets no token
    if tokens > 10:
        expert_of_token[:10] = 0  # a skewed group
    ours = plan_groups(expert_of_token, e, bm)
    ref = jx_plan_groups(expert_of_token, e, bm)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    order, gid, padded = ours
    assert padded[e - 1] == bm  # every expert gets at least one tile
    assert (order[-bm:] == -1).all()  # ...of padding rows


def test_plan_groups_invariants():
    rng = np.random.default_rng(2)
    e, bm = 6, 8
    expert_of_token = rng.integers(0, e, size=100)
    order, gid, padded = plan_groups(expert_of_token, e, bm)
    assert padded.sum() == len(order)
    assert (padded % bm == 0).all()
    assert gid.shape[0] == len(order) // bm
    assert sorted(order[order >= 0].tolist()) == list(range(100))
    offsets = np.concatenate([[0], np.cumsum(padded)])
    for pos, tok in enumerate(order):
        if tok >= 0:
            eid = expert_of_token[tok]
            assert offsets[eid] <= pos < offsets[eid + 1]
            assert gid[pos // bm] == eid


def test_gmm_end_to_end_dispatch():
    """plan_groups + grouped_matmul == per-token dense matmul with its
    expert, and == the Pallas kernel on the same dispatch."""
    rng = np.random.default_rng(3)
    e, k, n, bm = 4, 16, 24, 8
    expert_of_token = rng.integers(0, e, size=37)
    order, gid, _ = plan_groups(expert_of_token, e, bm)
    x_tok = rng.standard_normal((37, k)).astype(np.float32)
    xs = np.zeros((len(order), k), np.float32)
    valid = order >= 0
    xs[valid] = x_tok[order[valid]]
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    y_jx, y = _both(xs, w, gid, "float32", "float32", bm=bm, bk=16, bn=8)
    np.testing.assert_allclose(y, y_jx, rtol=2e-4, atol=2e-4)
    for tok in range(37):
        pos = int(np.nonzero(order == tok)[0][0])
        np.testing.assert_allclose(y[pos], x_tok[tok] @ w[expert_of_token[tok]],
                                   rtol=2e-4, atol=2e-4)
    assert not y[~valid].any()  # padding rows are zero in, zero out


# Every shape the card runs (chip_smoke.py's sweep and [lm kernels],
# tests/test_torch_gpu.py) as (e, k, n, bm), with the variant each input
# type must take: (bm, k, n, bf16 variant, float32 variant).
VARIANT_CASES = [
    (8, 32, 64, "simt", "simt"),  # the reference tests' shapes
    (16, 64, 128, "simt", "simt"),
    (8, 16, 16, "simt", "simt"),
    (128, 256, 384, "wgmma", "regblock"),  # N not a multiple of 256
    (64, 512, 192, "wgmma", "regblock"),  # 64-row blocks, ragged N
    (128, 1024, 512, "wgmma", "regblock"),  # granite gate and up
    (128, 512, 1024, "wgmma", "regblock"),  # granite down
    (128, 80, 256, "wgmma", "regblock"),  # K not a multiple of 64
    (128, 256, 320, "wgmma", "regblock"),
    (16, 64, 96, "simt", "simt"),
    (192, 64, 64, "wgmma", "regblock"),  # bm = 3 x 64
    (96, 64, 64, "simt", "simt"),  # bm not a multiple of 64
    (128, 84, 64, "simt", "regblock"),  # K not a multiple of 8
    (128, 64, 90, "simt", "simt"),  # N neither
]


@pytest.mark.parametrize("bm,k,n,bf16,f32", VARIANT_CASES)
def test_gmm_variant(bm, k, n, bf16, f32):
    assert gmm_variant(torch.bfloat16, bm, k, n) == bf16
    assert gmm_variant(torch.float32, bm, k, n) == f32


def test_gmm_is_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((32, 16)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((3, 16, 16)).astype(np.float32))
    gid = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    before = grouped_matmul.launches
    y = gmm(x, w, gid, bm=8, bk=8, bn=8)
    assert grouped_matmul.launches == before  # no kernel launched on the CPU
    assert torch.equal(y, gmm_plain(x, w, gid, bm=8))


def _args(m=32, k=16, n=16, e=3, bm=8):
    x = torch.zeros((m, k))
    w = torch.zeros((e, k, n))
    gid = torch.zeros(m // bm, dtype=torch.int32)
    return x, w, gid


@pytest.mark.parametrize("case", [
    "m_not_multiple_of_bm", "k_mismatch", "k_not_multiple_of_bk", "n_not_multiple_of_bn",
    "bm_not_multiple_of_8", "gid_length", "x_not_2d",
])
def test_gmm_refuses_bad_shapes(case):
    x, w, gid = _args()
    kw = {"bm": 8, "bk": 8, "bn": 8}
    if case == "m_not_multiple_of_bm":
        x = torch.zeros((36, 16))
    elif case == "k_mismatch":
        w = torch.zeros((3, 24, 16))
    elif case == "k_not_multiple_of_bk":
        kw["bk"] = 12
    elif case == "n_not_multiple_of_bn":
        kw["bn"] = 12
    elif case == "bm_not_multiple_of_8":
        kw["bm"] = 4
        gid = torch.zeros(8, dtype=torch.int32)
    elif case == "gid_length":
        gid = torch.zeros(5, dtype=torch.int32)
    elif case == "x_not_2d":
        x = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError):
        grouped_matmul(x, w, gid, **kw)


@pytest.mark.parametrize("bad", [-1, 3, 100])
def test_gmm_refuses_out_of_range_group_ids(bad):
    x, w, gid = _args()
    gid[2] = bad
    with pytest.raises(ValueError, match="outside"):
        grouped_matmul(x, w, gid, bm=8, bk=8, bn=8)


def test_gmm_refuses_mixed_devices_and_types():
    x, w, gid = _args()
    with pytest.raises(ValueError, match="one device"):
        grouped_matmul(x, w.to("meta"), gid, bm=8, bk=8, bn=8)
    with pytest.raises(ValueError, match="one device"):
        grouped_matmul(x, w, gid.to("meta"), bm=8, bk=8, bn=8)
    with pytest.raises(TypeError):
        grouped_matmul(x, w.bfloat16(), gid, bm=8, bk=8, bn=8)
    with pytest.raises(TypeError):
        grouped_matmul(x.half(), w.half(), gid, bm=8, bk=8, bn=8)
    with pytest.raises(TypeError):
        grouped_matmul(x, w, gid, bm=8, bk=8, bn=8, out_dtype=torch.float16)
    with pytest.raises(TypeError):
        grouped_matmul(x, w, gid.float(), bm=8, bk=8, bn=8)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        grouped_matmul(x.to("meta"), w.to("meta"), gid.to("meta"), bm=8, bk=8, bn=8)
