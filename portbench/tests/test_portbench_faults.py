"""The comparison catches a broken timed path: each cell driven end to
end on the CPU with one fault planted in the program underneath, and
``correct`` must come out false."""
import numpy as np
import pytest
import torch

import repro_torch.pmvc.dist as dist_mod
import repro_torch.api.solvers as solvers_mod
from repro_torch.api.session import SparseSession

from portbench.tests.pb_tiny import fault_cases, run


def _operator_fault(monkeypatch, broken):
    orig = SparseSession.device_spmm

    def device_spmm(self):
        mv = orig(self)
        return lambda x: broken(mv, x)

    monkeypatch.setattr(SparseSession, "device_spmm", device_spmm)


def state_unchanged(monkeypatch):
    """The step hands back its input: the operator leaves x unchanged."""
    _operator_fault(monkeypatch, lambda mv, x: x.clone())


def half_batch(monkeypatch):
    """Half of the batch left out: rows past the first half come back 0."""
    def broken(mv, x):
        y = mv(x)
        if y.dim() == 2 and y.shape[0] > 1:
            y = y.clone()
            y[y.shape[0] // 2:] = 0.0
        return y

    _operator_fault(monkeypatch, broken)


def no_exchange(monkeypatch):
    """The exchange left out: every unit's halo workspace stays zero."""
    orig = dist_mod._workspace
    monkeypatch.setattr(dist_mod, "_workspace", lambda *a: torch.zeros_like(orig(*a)))


def answer_altered(monkeypatch):
    """An answer altered where it is produced: its largest entry 1 % off."""
    def alter(x):
        x = np.array(x, dtype=np.float32, copy=True)
        flat = x.reshape(-1)
        flat[np.argmax(np.abs(flat))] *= 1.01
        return x

    orig_result = solvers_mod._result
    monkeypatch.setattr(solvers_mod, "_result",
                        lambda solver, x, *a: orig_result(solver, alter(np.asarray(x)), *a))


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "answer_altered": answer_altered}
CASES = fault_cases(FAULTS)


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_makes_the_run_incorrect(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    out = run(workload, seconds=0.4)
    assert out["correct"] is False, (fault, out["checks"])
