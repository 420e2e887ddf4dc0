"""Warm-start / pause-resume / checkpoint tests.

The reference's only warm-start notion is in-process basis persistence
across refactor calls (lueta.c:104-131); here the solver state pytree is an
explicit pause/resume surface: solve_canon(..., pause_mu=...) returns a
state that solve_canon(..., init=state) continues EXACTLY as if it never
stopped (the iteration math has no dependence on where the while_loop was
split), and utils/checkpoint round-trips it through disk.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from vanderbei_tpu.core.canonicalize import canonicalize
from vanderbei_tpu.core.config import SolverConfig
from vanderbei_tpu.core.status import Status
from vanderbei_tpu.io.synthetic import highs_reference, random_lp
from vanderbei_tpu.models import hsd, intpt
from vanderbei_tpu.utils import checkpoint
import vanderbei_tpu as vt


def _lp(seed=0, m=24, n=48):
    return random_lp(m, n, density=0.2, ub_frac=0.25, seed=seed)


def _canon_arrays(seed=0):
    canon = canonicalize(_lp(seed), pad_to=1)
    return (jnp.asarray(canon.A), jnp.asarray(canon.b),
            jnp.asarray(canon.c), canon.f)


def test_hsd_resume_equals_uninterrupted(tmp_path):
    A, b, c, f = _canon_arrays()
    full = hsd.solve_canon(A, b, c, f)
    # pause mid-flight (traced pause threshold), checkpoint, reload, resume
    paused = hsd.solve_canon(A, b, c, f, pause_mu=1e-3)[-1]
    assert int(paused.status) == int(Status.RUNNING)
    assert 0 < int(paused.iter) < int(full[5])
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, paused)
    loaded = checkpoint.load_state(path, hsd.HsdState)
    resumed = hsd.solve_canon(A, b, c, f, init=loaded)
    assert int(resumed[0]) == int(full[0]) == int(Status.OPTIMAL)
    assert int(resumed[5]) == int(full[5])          # same iteration count
    np.testing.assert_allclose(np.asarray(resumed[1]), np.asarray(full[1]),
                               rtol=1e-12, atol=1e-12)


def test_intpt_resume_equals_uninterrupted():
    A, b, c, f = _canon_arrays(1)
    full = intpt.solve_canon(A, b, c, f)
    paused = intpt.solve_canon(A, b, c, f, pause_gap=1.0)[-1]
    assert int(paused.status) == int(Status.RUNNING)
    resumed = intpt.solve_canon(A, b, c, f, init=paused)
    assert int(resumed[0]) == int(full[0]) == int(Status.OPTIMAL)
    assert int(resumed[5]) == int(full[5])
    np.testing.assert_allclose(np.asarray(resumed[1]), np.asarray(full[1]),
                               rtol=1e-12, atol=1e-12)


def test_mixed_precision_end_to_end():
    """The two-stage f32 sprint -> f64 polish reaches the same status and
    HiGHS objective as f64-direct."""
    for seed in (2, 3):
        lp = _lp(seed)
        mixed = vt.solve(lp, config=SolverConfig(precision="mixed"))
        direct = vt.solve(lp, config=SolverConfig(precision="f64"))
        _, golden = highs_reference(lp)
        assert mixed.status == direct.status == int(Status.OPTIMAL)
        assert abs(mixed.primal_obj - golden) / max(1, abs(golden)) < 1e-6
        assert abs(direct.primal_obj - golden) / max(1, abs(golden)) < 1e-6


def test_stage_cast_roundtrip():
    A, b, c, f = _canon_arrays(4)
    st = hsd.solve_canon(A, b, c, f, pause_mu=1e-2)[-1]
    st32 = hsd.cast_state(st, jnp.float32)
    st64 = hsd.cast_state(st32, jnp.float64)
    assert st64.x.dtype == jnp.float64
    assert int(st64.iter) == int(st.iter)
    np.testing.assert_allclose(np.asarray(st64.x), np.asarray(st.x),
                               rtol=1e-6)


def test_time_limit_stops_early():
    """TIMLIM semantics: the chunked driver aborts once the wall budget is
    exhausted, reporting honest partial progress (status iteration limit is
    NOT claimed; the run simply stops with status RUNNING -> mapped to
    iteration-limit only when the budget was truly iterations)."""
    lp = _lp(5)
    cfg = SolverConfig(time_limit=0.0)       # instant deadline
    sol = vt.solve(lp, config=cfg)
    # with a zero budget only the first chunk runs; the solve must return
    # quickly and not report OPTIMAL unless it genuinely converged
    assert sol.iterations <= 30
