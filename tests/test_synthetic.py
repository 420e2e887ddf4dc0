"""Seeded LP generator (io/synthetic.py) and its HiGHS reference."""

import numpy as np
import pytest

import vanderbei_tpu as vt
from vanderbei_tpu.core.status import Status
from vanderbei_tpu.io.synthetic import highs_reference, random_lp


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("m,n", [(10, 30), (40, 20), (120, 240)])
def test_feasible_and_bounded(m, n, seed):
    """HiGHS, independent of this package, finds a finite optimum."""
    lp = random_lp(m, n, density=0.1, ub_frac=0.25, seed=seed)
    status, obj = highs_reference(lp)
    assert status == int(Status.OPTIMAL)
    assert np.isfinite(obj)


def test_shape_and_mix():
    m, n = 200, 400
    lp = random_lp(m, n, density=0.05, ub_frac=0.25, seed=3)
    assert (lp.m, lp.n) == (m, n)
    A = lp.dense_A()
    nnz_col = np.count_nonzero(A, axis=0)
    assert nnz_col.min() >= 10 and nnz_col.max() <= 11
    assert np.count_nonzero(A, axis=1).min() >= 1
    assert int((lp.r == 0.0).sum()) == 40                  # 20% equality
    assert int(np.isinf(lp.r).sum()) == 160                # <= and >=
    assert int(np.isfinite(lp.u).sum()) == 100             # 25% bounded
    mags = np.abs(A[A != 0])
    assert mags.min() >= 1e-2 * (1 - 1e-6) and mags.max() <= 1e2 * (1 + 1e-6)


def test_deterministic_per_seed():
    a = random_lp(30, 50, density=0.1, ub_frac=0.3, seed=7)
    b = random_lp(30, 50, density=0.1, ub_frac=0.3, seed=7)
    c = random_lp(30, 50, density=0.1, ub_frac=0.3, seed=8)
    for f in ("A", "iA", "kA", "b", "c", "r", "u"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.c, c.c)


def test_mps_roundtrip_is_exact(tmp_path):
    """Six significant figures fit the MPS value field: the file and the
    in-memory LP are the same problem."""
    lp = random_lp(60, 90, density=0.1, ub_frac=0.25, seed=11)
    path = str(tmp_path / "gen.mps")
    vt.write_lp(lp, path)
    back = vt.read_mps(path)
    np.testing.assert_array_equal(back.dense_A(), lp.dense_A())
    for f in ("b", "c", "r", "l", "u"):
        np.testing.assert_array_equal(getattr(back, f), getattr(lp, f))


def test_highs_reference_statuses():
    from tests.test_canonicalize import make_lp
    # x >= 2 and x <= 1
    infeas = make_lp([[1.0], [-1.0]], [2.0, -1.0], [1.0])
    assert highs_reference(infeas)[0] == int(Status.PRIMAL_INFEASIBLE)
    # max x1 + x2 s.t. x1 - x2 >= -1
    unb = make_lp([[1.0, -1.0]], [-1.0], [1.0, 1.0], maximize=True)
    assert highs_reference(unb)[0] == int(Status.PRIMAL_UNBOUNDED)
    # max 2x s.t. x <= 3 (stored negated: -x >= -3)
    st, obj = highs_reference(make_lp([[-1.0]], [-3.0], [2.0],
                                      maximize=True))
    assert st == int(Status.OPTIMAL) and obj == pytest.approx(6.0)
