"""The traffic generator: reproducible from the seed, the same sizes
for every seed."""
import json
import os

import numpy as np
import pytest

from portbench import loops, reference
from portbench.harness import HERE
from portbench.traffic import PAYLOADS, Reservoir, payloads


def test_payloads():
    a = payloads({"payload": "normal"}, 100, 2, 8, 2**31 + 1, salt=1)
    assert a.shape == (2, 8, 100) and a.dtype == np.float32 and abs(float(a.std()) - 1.0) < 0.1
    assert np.array_equal(a, payloads({"payload": "normal"}, 100, 2, 8, 2**31 + 1, salt=1))
    assert not np.array_equal(a, payloads({"payload": "normal"}, 100, 2, 8, 2**31 + 2, salt=1))
    with pytest.raises(ValueError):
        payloads({"payload": "bursty"}, 10, 1, 1, 0, salt=0)


def test_uniform_payloads():
    """PageRank's classic teleport: every row 1/n, the same for every seed."""
    a = payloads({"payload": "uniform"}, 1000, 3, 2, 2**31 + 1, salt=0)
    assert a.shape == (3, 2, 1000) and a.dtype == np.float32
    assert np.all(a == np.float32(1.0 / 1000))
    assert np.allclose(a.sum(axis=-1, dtype=np.float64), 1.0, rtol=1e-6)
    assert np.array_equal(a, payloads({"payload": "uniform"}, 1000, 3, 2, 7, salt=5))


def test_every_traffic_file_names_its_loop_and_solver():
    folder = os.path.join(HERE, "traffic")
    for name in os.listdir(folder):
        tr = json.load(open(os.path.join(folder, name)))
        assert callable(loops.find(tr["loop"]).run)
        assert os.path.exists(os.path.join(os.path.dirname(reference.__file__),
                                           f"{tr['solver']}.py"))
        assert tr["payload"] in PAYLOADS and tr["batch"] >= 1 and tr["iters"] >= 1


def test_reservoir_keeps_a_seeded_sample():
    def kept(seed, count=50):
        r = Reservoir(4, seed)
        for i in range(count):
            r.offer(i)
        return sorted(r.items)

    assert kept(2**31 + 9) == kept(2**31 + 9) and len(set(kept(7))) == 4
    assert kept(1, count=3) == [0, 1, 2]
    firsts = [kept(s)[0] for s in range(40)]
    assert len(set(firsts)) > 3  # not always the same items
