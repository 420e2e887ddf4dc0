"""Reference-outcome parity: the reference's evaluate tables double as an
expected-failures contract (SURVEY.md section 4).

- 11 netlib instances contain free variables; the reference's solvelp
  rejects them with status 3 "dual unbounded" (solve.c:79-87) before any
  solver runs.  Under free_vars="reject" (the default) we must reproduce
  that status on every one of them; under free_vars="split" they become
  solvable (spot-checked against golden optima in test_solvers.py).
- The reference ipo hits its iteration limit (MAX_ITER=200, hsd.c:25) on 5
  problems — none of those terminate "dual unbounded", i.e. they
  canonicalize fine; we assert they pass canonicalization (their full
  solves are exercised by the corpus sweep, vanderbei_tpu.evaluate).
"""

import os

import pytest

import vanderbei_tpu as vt
from vanderbei_tpu.core.canonicalize import canonicalize
from vanderbei_tpu.core.status import Status
from vanderbei_tpu.io import netlib


@pytest.fixture(autouse=True)
def corpus():
    # every test here reads netlib files
    if not os.path.exists(netlib.netlib_dir()):
        pytest.skip("netlib corpus absent")


# /root/reference/evaluate/v1-cf4d5ba/netlib/ipo/README.md "dual unbounded"
DUAL_UNBOUNDED_11 = [
    "CAPRI", "CYCLE", "GREENBEB", "MODSZK1", "PEROLD", "PILOT.JA",
    "PILOT.WE", "PILOT4", "STAIR", "TUFF", "VTP.BASE",
]
# same table, "iteration limit" rows (PDS-10's file is stripped)
IPO_ITERLIM_5 = ["FORPLAN", "GREENBEA", "PDS-10", "PILOT", "PILOT87"]


@pytest.mark.parametrize("name", DUAL_UNBOUNDED_11)
def test_free_variable_instances_rejected(name):
    lp = netlib.load(name)
    canon = canonicalize(lp, free_vars="reject")
    assert canon.status == int(Status.DUAL_UNBOUNDED), name
    # end-to-end through solve(): status must surface unchanged
    sol = vt.solve(lp, method="hsd")
    assert sol.status == int(Status.DUAL_UNBOUNDED), name


@pytest.mark.parametrize("name", DUAL_UNBOUNDED_11)
def test_free_variable_instances_splittable(name):
    """free_vars='split' must produce a runnable canonical form (mirrored
    columns), the capability the reference lacks."""
    lp = netlib.load(name)
    canon = canonicalize(lp, free_vars="split")
    assert canon.status == int(Status.RUNNING), name
    assert len(canon.free_cols) > 0
    assert canon.n == canon.n_orig + len(canon.free_cols)


@pytest.mark.parametrize("name", IPO_ITERLIM_5)
def test_iterlim_problems_canonicalize(name):
    if (name not in netlib.NETLIB_GOLDEN
            or not os.path.exists(os.path.join(
                netlib.netlib_dir(), netlib.NETLIB_GOLDEN[name][0]))):
        pytest.skip(f"{name} stripped from the corpus mount")
    lp = netlib.load(name)
    canon = canonicalize(lp, free_vars="reject")
    assert canon.status == int(Status.RUNNING), name
