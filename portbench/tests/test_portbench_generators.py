"""The frozen generator of HPCG's stencil."""
import numpy as np
import pytest

from portbench.matrices import make_graphs
from portbench.matrices.stencil27 import stencil27


@pytest.mark.parametrize("nx,ny,nz", [(4, 4, 4), (5, 5, 5), (3, 6, 2)])
def test_stencil_counts_and_values(nx, ny, nz):
    m = stencil27(nx, ny, nz)
    assert m.n == nx * ny * nz
    assert m.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    diag = m.row == m.col
    assert diag.sum() == m.n and np.all(m.val[diag] == 26.0) and np.all(m.val[~diag] == -1.0)
    keys = set(zip(m.row.tolist(), m.col.tolist()))
    assert len(keys) == m.nnz and all((c, r) in keys for r, c in keys)


def test_stencil_is_hpcg_numbering():
    m = stencil27(3, 3, 3)
    centre = 1 + 3 * (1 + 3 * 1)
    assert sorted(m.col[m.row == centre].tolist()) == list(range(27))
    assert np.count_nonzero(m.row == 0) == 8  # a corner has 7 neighbours


def test_stencil_does_not_depend_on_the_seed():
    cfg = {"generator": "stencil27", "nx": 4, "ny": 3, "nz": 5}
    a, b = make_graphs(cfg, 1)["a"], make_graphs(cfg, 2**31 + 7)["a"]
    assert np.array_equal(a.val, b.val) and np.array_equal(a.col, b.col)
