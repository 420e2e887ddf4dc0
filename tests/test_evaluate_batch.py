"""Batched corpus sweep (evaluate.run_sweep_batched) and the r4 quality
gate: de-homogenized feasibility residuals + the unscaled retry ladder.

Reference semantics under test: the OPTIMAL certificate (hsd.c:155-176)
augmented with the de-homogenized primal/dual residual gate, and the
evaluate/-tree workload (SURVEY.md section 2.6) through the batched path.
"""

import os

import pytest

from vanderbei_tpu.core.config import SolverConfig
from vanderbei_tpu.core.status import Status
from vanderbei_tpu.evaluate import _make_record, run_sweep_batched
from vanderbei_tpu.io import netlib
from vanderbei_tpu.io.synthetic import highs_reference, random_lp
from vanderbei_tpu.models.registry import solve


TINY = ["AFIRO", "SC50A", "SC50B", "KB2", "ADLITTLE", "BLEND"]


@pytest.fixture
def corpus():
    if not os.path.exists(netlib.netlib_dir()):
        pytest.skip("netlib corpus absent")


def _relerr(obj, name):
    g = netlib.ondisk_objective(name)
    return abs(obj - g) / max(1.0, abs(g))


def test_batched_sweep_hsd_matches_golden(corpus):
    recs = run_sweep_batched(
        method="hsd", names=TINY, config=SolverConfig(free_vars="split"),
        granularity=128, max_batch=512, progress=False)
    assert len(recs) == len(TINY)
    for r in recs:
        assert r["status"] == int(Status.OPTIMAL), r
        assert r["relerr"] < 1e-6, r


def test_batched_sweep_pd_matches_golden(corpus):
    recs = run_sweep_batched(
        method="pd", names=TINY[:4], config=SolverConfig(free_vars="split"),
        granularity=128, max_batch=512, progress=False)
    assert len(recs) == 4
    for r in recs:
        assert r["status"] == int(Status.OPTIMAL), r
        assert r["relerr"] < 1e-6, r


def test_batched_sweep_routes_big_to_per_problem(corpus):
    # max_batch=64 forces every problem onto the per-problem path; the
    # records must be identical in structure and quality
    recs = run_sweep_batched(
        method="hsd", names=["AFIRO", "SC50A"],
        config=SolverConfig(free_vars="split"),
        granularity=128, max_batch=64, progress=False)
    assert {r["name"] for r in recs} == {"AFIRO", "SC50A"}
    assert all(r["relerr"] < 1e-6 for r in recs)


def test_batched_sweep_records_aborts(corpus):
    # CAPRI has free variables; free_vars="reject" (reference parity,
    # solve.c:79-87) must record the abort status, not drop the row
    recs = run_sweep_batched(
        method="hsd", names=["CAPRI", "AFIRO"],
        config=SolverConfig(free_vars="reject"),
        granularity=128, max_batch=512, progress=False)
    by = {r["name"]: r for r in recs}
    assert by["CAPRI"]["status"] not in (int(Status.RUNNING),
                                         int(Status.OPTIMAL))
    assert by["AFIRO"]["status"] == int(Status.OPTIMAL)


def test_make_record_fields(corpus):
    lp = netlib.load("AFIRO")
    rec = _make_record("AFIRO", lp, int(Status.OPTIMAL),
                       netlib.ondisk_objective("AFIRO"), 17, 1.23, {})
    assert rec["relerr"] < 1e-12
    assert rec["iterations"] == 17
    assert rec["seconds"] == 1.23


def test_quality_gate_feasibility_residuals():
    """An impossibly strict feas_tol must flag SUBOPTIMAL (the residual
    gate is wired through); the default gate must still certify."""
    import jax.numpy as jnp

    from vanderbei_tpu.core.canonicalize import canonicalize
    from vanderbei_tpu.models import hsd as _hsd

    lp = random_lp(20, 40, density=0.2, ub_frac=0.25, seed=0)
    canon = canonicalize(lp, pad_to=1)
    A = jnp.asarray(canon.A)
    b = jnp.asarray(canon.b)
    c = jnp.asarray(canon.c)
    st_strict, *_ = _hsd.solve_canon(A, b, c, canon.f, feas_tol=1e-300)
    assert int(st_strict) == int(Status.SUBOPTIMAL)
    st_ok, *_ = _hsd.solve_canon(A, b, c, canon.f)
    assert int(st_ok) == int(Status.OPTIMAL)
    # end-to-end: the registry certificate holds under defaults
    sol = solve(lp, method="hsd", config=SolverConfig())
    assert sol.status == int(Status.OPTIMAL)
    _, ref = highs_reference(lp)
    assert abs(sol.primal_obj - ref) / max(1.0, abs(ref)) < 1e-6
