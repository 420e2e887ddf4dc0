"""End-to-end solver tests: seeded generated LPs against scipy's HiGHS, and
small netlib instances against the published golden optima (the
reference's de-facto oracle, SURVEY.md section 4) where the corpus is
present."""

import os

import numpy as np
import pytest

import vanderbei_tpu as vt
from vanderbei_tpu.io import netlib
from vanderbei_tpu.io.synthetic import highs_reference, random_lp
from vanderbei_tpu.core.status import Status

SMALL = ["AFIRO", "SC50A", "SC50B", "ADLITTLE", "BLEND", "SHARE2B", "SC105"]
METHODS = ["intpt", "hsd", "hsdls", "pd", "twophase"]


@pytest.fixture
def corpus():
    if not os.path.exists(netlib.netlib_dir()):
        pytest.skip("netlib corpus absent")


def gen_lp(seed, m=16, n=32):
    return random_lp(m, n, density=0.25, ub_frac=0.25, seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_generated_lp(seed, method):
    lp = gen_lp(seed)
    sol = vt.solve(lp, method=method)
    h_status, h_obj = highs_reference(lp)
    assert h_status == sol.status == int(Status.OPTIMAL), (
        f"seed {seed}/{method}: status {sol.status}")
    rel = abs(sol.primal_obj - h_obj) / max(1.0, abs(h_obj))
    assert rel < 1e-6, f"seed {seed}/{method}: {sol.primal_obj} vs {h_obj}"


@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("method", METHODS)
def test_small_netlib(name, method, corpus):
    lp = netlib.load(name)
    sol = vt.solve(lp, method=method)
    golden = netlib.golden_objective(name)
    assert sol.status == int(Status.OPTIMAL), (
        f"{name}/{method}: status {sol.status}")
    rel = abs(sol.primal_obj - golden) / max(1.0, abs(golden))
    assert rel < 1e-6, f"{name}/{method}: {sol.primal_obj} vs {golden}"


@pytest.mark.parametrize("method", ["hsd", "pd", "twophase"])
def test_padding_invariance(method):
    """Padding to tile multiples must not change the answer."""
    lp = gen_lp(3)
    sol1 = vt.solve(lp, method=method, pad_to=1)
    sol2 = vt.solve(lp, method=method, pad_to=64)
    assert sol1.status == sol2.status == int(Status.OPTIMAL)
    # padding legitimately perturbs the iterate path (extra benign
    # rows/cols join mu); agreement is to the optimality tolerance
    assert sol2.primal_obj == pytest.approx(sol1.primal_obj, rel=1e-6)


def test_maximize_sense(tmp_path):
    """MAX header flips the sense end-to-end."""
    from tests.test_mps import row
    text = "\n".join([
        "MAX",
        "NAME          M",
        "ROWS",
        row("N", "obj"),
        row("L", "r1"),
        "COLUMNS",
        row("", "x", "obj", 1.0, "r1", 1.0),
        row("", "y", "obj", 2.0, "r1", 1.0),
        "RHS",
        row("", "rhs", "r1", 4.0),
        "ENDATA",
    ]) + "\n"
    p = tmp_path / "m.mps"
    p.write_text(text)
    lp = vt.read_mps(str(p))
    sol = vt.solve(lp, method="hsd")
    assert sol.status == int(Status.OPTIMAL)
    assert sol.primal_obj == pytest.approx(8.0, abs=1e-6)


def test_infeasible_detection():
    """x >= 2 and x <= 1 is primal infeasible -> hsd certificate."""
    from tests.test_canonicalize import make_lp
    lp = make_lp([[1.0], [-1.0]], [2.0, -1.0], [1.0])
    sol = vt.solve(lp, method="hsd")
    assert sol.status == int(Status.PRIMAL_INFEASIBLE)


def test_unbounded_detection():
    """max x1+x2 s.t. x1 - x2 >= -1: recession direction (1,1).

    The simplex certificate is exact (PRIMAL_UNBOUNDED).  The HSD
    certificate near phi,psi -> 0 is a sign tie-break the reference itself
    gets "wrong" on thin cases (its ipo binary reports "primal infeasible"
    for max x, x>=1), so hsd is only asserted to land in the
    infeasible/unbounded family, not OPTIMAL.
    """
    from tests.test_canonicalize import make_lp
    lp = make_lp([[1.0, -1.0]], [-1.0], [1.0, 1.0], maximize=True)
    sol = vt.solve(lp, method="hsd")
    assert sol.status in (int(Status.DUAL_INFEASIBLE),
                          int(Status.PRIMAL_INFEASIBLE),
                          int(Status.PRIMAL_UNBOUNDED))
    sol2 = vt.solve(lp, method="pd")
    assert sol2.status == int(Status.PRIMAL_UNBOUNDED)


def test_solution_vectors_feasible():
    lp = gen_lp(4)
    sol = vt.solve(lp, method="hsd")
    A = lp.dense_A()
    act = A @ sol.x
    # b <= Ax <= b+r within tolerance
    ok_lo = act >= lp.b - 1e-5 * (1 + np.abs(lp.b))
    hi = np.where(np.isfinite(lp.r), lp.b + lp.r, np.inf)
    ok_hi = act <= hi + 1e-5 * (1 + np.abs(lp.b))
    assert ok_lo.all() and ok_hi.all()
    assert (sol.x >= lp.l - 1e-6).all()


def test_write_sol(tmp_path):
    lp = gen_lp(5)
    sol = vt.solve(lp, method="hsd")
    out = tmp_path / "afiro.out"
    vt.write_sol(lp, sol, str(out))
    text = out.read_text()
    assert "COLUMNS SECTION" in text
    assert "ROWS SECTION" in text
    assert text.rstrip().endswith("ENDOUT")
    # one line per column and row
    assert len(text.splitlines()) == 2 + lp.n + 2 + lp.m + 1


@pytest.mark.parametrize("name", ["CAPRI", "VTP.BASE"])
def test_free_variable_split(name, corpus):
    """Instances the reference rejects with "dual unbounded" (free
    variables, solve.c:79-87) solve to the golden optimum with
    free_vars="split"."""
    from vanderbei_tpu.core.config import SolverConfig
    lp = netlib.load(name)
    rej = vt.solve(lp, method="hsd")
    assert rej.status == int(Status.DUAL_UNBOUNDED)   # reference parity
    sol = vt.solve(lp, method="hsd",
                   config=SolverConfig(free_vars="split"))
    golden = netlib.golden_objective(name)
    assert sol.status == int(Status.OPTIMAL)
    assert abs(sol.primal_obj - golden) / max(1, abs(golden)) < 1e-6


def test_structured_metrics_table():
    """solve_canon_metrics returns the per-iteration table from device and
    agrees with the plain solve."""
    import jax.numpy as jnp
    from vanderbei_tpu.core.canonicalize import canonicalize
    from vanderbei_tpu.models import hsd
    lp = gen_lp(6)
    canon = canonicalize(lp, pad_to=1)
    A = jnp.asarray(canon.A)
    b = jnp.asarray(canon.b)
    c = jnp.asarray(canon.c)
    (st, x, y, w, z, iters, _), rows = hsd.solve_canon_metrics(
        A, b, c, canon.f, max_iter=100)
    plain = hsd.solve_canon(A, b, c, canon.f, max_iter=100)
    assert int(st) == int(plain[0]) == int(Status.OPTIMAL)
    assert int(iters) == int(plain[5])
    valid = np.asarray(rows["valid"])
    mu = np.asarray(rows["mu"])
    k = int(iters)
    assert valid[:k].all() and not valid[k:].any()
    # mu decreases by orders of magnitude over the run and ends < 1e-12
    assert mu[0] > 1e-2 and mu[k - 1] < 1e-10
    # final trace row's objective matches the solve's objective
    pobj = np.asarray(rows["primal_obj"])[k - 1]
    obj = float(c @ x) + canon.f
    assert abs(pobj - obj) / max(1, abs(obj)) < 1e-6


def test_padding_invariance_stress():
    """Size-class auto-padding (default) adds ~200 benign rows/cols to a
    40 x 50 LP; the answer must match the exact-dims solve to optimality
    tolerance on a problem whose padded fraction is large."""
    lp = random_lp(40, 50, density=0.1, ub_frac=0.0, seed=7)
    exact = vt.solve(lp, method="hsd", pad_to=1)
    padded = vt.solve(lp, method="hsd")            # pad_to="auto"
    _, golden = highs_reference(lp)
    assert exact.status == padded.status == int(Status.OPTIMAL)
    assert abs(padded.primal_obj - exact.primal_obj) <= 1e-6 * abs(golden)
    assert abs(padded.primal_obj - golden) / abs(golden) < 1e-6
    # the padding must not leak into the reported solution vectors
    # (x in original columns; y/w over the TRUE canonical rows)
    assert padded.x.shape == (lp.n,)
    assert padded.y.shape == exact.y.shape


@pytest.mark.parametrize("name", ["BANDM", "STAIR"])
def test_hsdls_mid_scale(name, corpus):
    """The long-step linesearch variant on problems where it actually has
    to work (hundreds of rows, the STAIR staircase is a reference
    'dual unbounded' reject solved via free_vars='split')."""
    from vanderbei_tpu.core.config import SolverConfig
    lp = netlib.load(name)
    sol = vt.solve(lp, method="hsdls",
                   config=SolverConfig(free_vars="split"))
    golden = netlib.golden_objective(name)
    assert sol.status == int(Status.OPTIMAL)
    assert abs(sol.primal_obj - golden) / max(1, abs(golden)) < 1e-6


def test_free_var_with_finite_ub_falls_back_to_dense():
    """A split free variable with a finite upper bound mirrors -1 into its
    ub row (canonicalize step 6), so that tail row is not a singleton; the
    UbTail structured path must NOT engage (it would drop the mirror entry
    and enforce x+ <= u instead of x+ - x- <= u).  Regression for the
    round-2 advisor's high-severity finding."""
    from vanderbei_tpu.core.builder import LPBuilder
    from vanderbei_tpu.core.config import SolverConfig

    # min x + y  s.t.  x + y >= -2,  x free with x <= -1,  0 <= y <= 5
    # optimum: x = -2, y = 0 -> objective -2
    b = LPBuilder("freeub")
    b.var("x", lower=-np.inf, upper=-1.0, obj=1.0)
    b.var("y", lower=0.0, upper=5.0, obj=1.0)
    b.constraint("r1", {"x": 1.0, "y": 1.0}, lo=-2.0)
    lp = b.build()

    for use_struct in (True, False):
        cfg = SolverConfig(free_vars="split", use_ub_structure=use_struct)
        sol = vt.solve(lp, method="hsd", config=cfg)
        assert sol.status == int(Status.OPTIMAL), (use_struct, sol.status)
        assert sol.primal_obj == pytest.approx(-2.0, abs=1e-7), use_struct
        # the optimum is a face; assert feasibility of the returned point
        x, y = sol.x
        assert x + y >= -2.0 - 1e-6 and x <= -1.0 + 1e-6
        assert -1e-6 <= y <= 5.0 + 1e-6


@pytest.mark.skipif(bool(os.environ.get("SKIP_SLOW")),
                    reason="SKIP_SLOW set")
def test_twophase_bandm_mid_scale(corpus):
    """Backs the README claim: two-phase simplex validated at mid scale —
    BANDM (305 rows original, 610 canonical), ~1.4k pivots through the
    dense-B^-1 product-form/refresh machinery."""
    lp = netlib.load("BANDM")
    sol = vt.solve(lp, method="twophase")
    golden = netlib.golden_objective("BANDM")
    assert sol.status == int(Status.OPTIMAL)
    assert abs(sol.primal_obj - golden) / abs(golden) < 1e-6
    assert 600 < sol.iterations < 5000


def test_forplan_quality_gate_and_fallback(corpus):
    """FORPLAN's HSD trajectory collapses phi (mu < 1e-12 while the
    de-homogenized point still has a ~5e-4 relative duality gap — the
    reference hits its iteration limit here).  The quality gate must
    refuse the OPTIMAL certificate and the registry must fall back to the
    path-following solver, which solves it to the true file optimum."""
    from vanderbei_tpu.core.config import SolverConfig
    lp = netlib.load("FORPLAN")
    sol = vt.solve(lp, method="hsd", config=SolverConfig(free_vars="split"))
    golden = netlib.golden_objective("FORPLAN")
    assert sol.status == int(Status.OPTIMAL)
    assert abs(sol.primal_obj - golden) / abs(golden) < 1e-6
