"""The plain reference against the program on the CPU at a tiny size,
and its control (TF32) failing the cell's limit."""
import numpy as np
import pytest
import torch

from portbench import reference
from portbench.harness import ROOT, read_json, plan
from portbench.matrices import make_graphs
from portbench.reference import Operator, round_tf32

CFG = {"generator": "stencil27", "nx": 6, "ny": 5, "nz": 7,
       "plan": {"nodes": 2, "cores": 2, "combo": "NL-HC", "exchange": "selective", "block": 16,
                "seed": 0, "executor": "simulate"}}


@pytest.fixture(scope="module")
def planned():
    graphs = make_graphs(CFG, 0)
    sessions, _, _ = plan(CFG, graphs, "cpu")
    return graphs["a"], sessions["a"]


def rel(x, ref):
    return float((np.abs(x - ref).max(axis=-1) / np.abs(ref).max(axis=-1)).max())


def payload(n, rows=3):
    return np.random.default_rng(5).standard_normal((rows, n)).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("device_loop", [False, True])
def test_cg_agrees_with_the_program(planned, rows, device_loop):
    m, sess = planned
    b = payload(m.n, rows)
    x = sess.solve("cg", iters=50, tol=0.0, device_loop=device_loop, b=b).x
    assert rel(x, reference.solve("cg", m, b, 50, "float64", "cpu")) < 1e-5


def test_operator_agrees_with_the_programs_product(planned):
    m, sess = planned
    x = payload(m.n)
    ref = Operator(m, "float64", "cpu")(torch.as_tensor(x)).numpy()
    assert rel(sess.spmv(x), ref) < 1e-6


def test_the_control_fails_the_cells_limit():
    """The reference in TF32, in the program's place, reads above the
    cell's limit on ``x_err``, at the cell's 50 iterations."""
    limit = read_json(f"{ROOT}/portbench/cells/hpcg64-cg-b1.json")["limits"]["x_err"]
    m = make_graphs({"generator": "stencil27", "nx": 8, "ny": 8, "nz": 8}, 0)["a"]
    b = payload(m.n)
    ref = reference.solve("cg", m, b, 50, "float64", "cpu")
    ctrl = reference.solve("cg", m, b, 50, "tf32", "cpu")
    assert rel(ctrl, ref) > limit


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -3.14159, 0.0, 2**-20])
    y = round_tf32(x)
    assert y.tolist()[:3] == [1.0, 1.0, 1 + 2**-9]
    bits = y.view(torch.int32) & 0x1FFF
    assert torch.all(bits == 0) and torch.all((y - x).abs() <= x.abs() * 2**-11)


def test_operator_precisions(planned):
    m, _ = planned
    x = torch.as_tensor(payload(m.n))
    y64, y32 = Operator(m, "float64", "cpu")(x), Operator(m, "tf32", "cpu")(x)
    assert y64.dtype == torch.float64 and y32.dtype == torch.float32
    gap = float(((y32.double() - y64).abs().max() / y64.abs().max()))
    assert 1e-5 < gap < 1e-2
    with pytest.raises(ValueError):
        Operator(m, "bfloat16", "cpu")


def test_a_reference_is_found_in_the_checkout(tmp_path, planned):
    """``reference/<solver>.py`` of the cell's checkout, as a later PR adds
    one; the package's where the checkout has none."""
    m, _ = planned
    (tmp_path / "portbench" / "reference").mkdir(parents=True)
    (tmp_path / "portbench" / "reference" / "echo_test.py").write_text(
        "def solve(m, x, iters, precision):\n    return x * iters\n")
    b = payload(m.n)
    assert np.array_equal(reference.solve("echo_test", m, b, 2, "float64", "cpu", tmp_path), 2 * b)
    package = reference.solve("cg", m, b, 5, "float64", "cpu")
    assert np.array_equal(reference.solve("cg", m, b, 5, "float64", "cpu", str(tmp_path)), package)
    with pytest.raises(FileNotFoundError):
        reference.solve("echo_test", m, b, 2, "float64", "cpu")
