"""KKT engine unit tests: reduced normal equations vs a dense solve of the
full quasi-definite system (reference ldlt.c semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vanderbei_tpu.ops.kkt import kkt_factor, kkt_solve


@pytest.mark.parametrize("m,n", [(5, 9), (9, 5), (7, 7)])
def test_matches_dense_solve(m, n):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n))
    E = rng.uniform(0.5, 2.0, m)
    D = rng.uniform(0.5, 2.0, n)
    ry = rng.normal(size=m)
    rx = rng.normal(size=n)
    K = np.block([[-np.diag(E), A], [A.T, np.diag(D)]])
    ref = np.linalg.solve(K, np.concatenate([ry, rx]))

    L = kkt_factor(jnp.array(A), jnp.array(E), jnp.array(D), 1e-14)
    dy, dx = kkt_solve(jnp.array(A), jnp.array(E), jnp.array(D), L,
                       jnp.array(ry), jnp.array(rx))
    np.testing.assert_allclose(np.asarray(dy), ref[:m], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(dx), ref[m:], rtol=1e-10)


def test_extreme_scaling_survives():
    """Near-convergence D/E spreads (1e-10..1e10) must not NaN the factor;
    refinement recovers accuracy (dense analogue of ldlt.c:293-306)."""
    rng = np.random.default_rng(1)
    m, n = 12, 20
    A = rng.normal(size=(m, n))
    D = 10.0 ** rng.uniform(-10, 10, n)
    E = 10.0 ** rng.uniform(-10, 10, m)
    ry = rng.normal(size=m)
    rx = rng.normal(size=n)
    L = kkt_factor(jnp.array(A), jnp.array(E), jnp.array(D), 1e-14)
    assert not np.any(np.isnan(np.asarray(L.L)))
    dy, dx = kkt_solve(jnp.array(A), jnp.array(E), jnp.array(D), L,
                       jnp.array(ry), jnp.array(rx))
    r1 = ry + E * np.asarray(dy) - A @ np.asarray(dx)
    r2 = rx - A.T @ np.asarray(dy) - D * np.asarray(dx)
    scale = max(np.max(np.abs(ry)), np.max(np.abs(rx))) + 1
    assert np.max(np.abs(np.concatenate([r1, r2]))) < 1e-6 * scale


def test_quadratic_term():
    rng = np.random.default_rng(2)
    m, n = 6, 4
    A = rng.normal(size=(m, n))
    Qh = rng.normal(size=(n, n))
    Q = Qh @ Qh.T + np.eye(n)
    E = rng.uniform(0.5, 2.0, m)
    D = rng.uniform(0.5, 2.0, n)
    ry = rng.normal(size=m)
    rx = rng.normal(size=n)
    K = np.block([[-np.diag(E), A], [A.T, np.diag(D) + Q]])
    ref = np.linalg.solve(K, np.concatenate([ry, rx]))
    L = kkt_factor(jnp.array(A), jnp.array(E), jnp.array(D), 1e-14,
                   Q=jnp.array(Q))
    dy, dx = kkt_solve(jnp.array(A), jnp.array(E), jnp.array(D), L,
                       jnp.array(ry), jnp.array(rx), Q=jnp.array(Q))
    np.testing.assert_allclose(np.asarray(dy), ref[:m], rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dx), ref[m:], rtol=1e-8)


def test_mixed_precision_f32_factor():
    """f32 factor + f64 refinement recovers f64-grade accuracy
    on a Jacobi-scaled moderately conditioned system."""
    rng = np.random.default_rng(3)
    m, n = 40, 24
    A = rng.normal(size=(m, n))
    D = 10.0 ** rng.uniform(-4, 4, n)
    E = 10.0 ** rng.uniform(-4, 4, m)
    ry = rng.normal(size=m)
    rx = rng.normal(size=n)
    fac = kkt_factor(jnp.array(A), jnp.array(E), jnp.array(D), 1e-14,
                     factor_dtype=jnp.float32)
    assert fac.L.dtype == jnp.float32
    dy, dx = kkt_solve(jnp.array(A), jnp.array(E), jnp.array(D), fac,
                       jnp.array(ry), jnp.array(rx))
    K = np.block([[-np.diag(E), A], [A.T, np.diag(D)]])
    ref = np.linalg.solve(K, np.concatenate([ry, rx]))
    err = max(np.max(np.abs(np.asarray(dy) - ref[:m])),
              np.max(np.abs(np.asarray(dx) - ref[m:])))
    assert err < 1e-8 * max(1.0, np.max(np.abs(ref)))


def test_ub_tail_schur_matches_full_dense():
    """The Schur-eliminated singleton-ub-tail path must equal the dense
    solve of the full system [[-E, Af],[Af', D]] with Af = [A1; S]."""
    from vanderbei_tpu.ops.kkt import UbTail
    rng = np.random.default_rng(7)
    m1, k, n = 9, 6, 14         # 4 real ub rows + 2 padding rows
    A1 = rng.normal(size=(m1, n))
    idx2 = np.array([1, 4, 7, 11, 0, 0], dtype=np.int32)
    w2 = np.array([1.0, 0.5, 2.0, 1.0, 0.0, 0.0])
    S = np.zeros((k, n))
    for i in range(k):
        S[i, idx2[i]] = w2[i]
    Af = np.vstack([A1, S])
    E = rng.uniform(0.5, 2.0, m1 + k)
    D = rng.uniform(0.5, 2.0, n)
    ry = rng.normal(size=m1 + k)
    rx = rng.normal(size=n)
    K = np.block([[-np.diag(E), Af], [Af.T, np.diag(D)]])
    ref = np.linalg.solve(K, np.concatenate([ry, rx]))

    ub = UbTail(jnp.asarray(idx2), jnp.asarray(w2))
    fac = kkt_factor(jnp.asarray(A1), jnp.asarray(E), jnp.asarray(D),
                     1e-14, ub=ub)
    assert fac.L.shape == (m1, m1)       # only the head is factored
    dy, dx = kkt_solve(jnp.asarray(A1), jnp.asarray(E), jnp.asarray(D),
                       fac, jnp.asarray(ry), jnp.asarray(rx), ub=ub)
    np.testing.assert_allclose(np.asarray(dy), ref[:m1 + k], rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(dx), ref[m1 + k:], rtol=1e-9,
                               atol=1e-9)


def test_ub_tail_extreme_scaling():
    """ub-tail path under near-convergence D/E spreads stays finite and
    refinement-accurate (the bounded-variable harmonic diagonal must not
    overflow/cancel)."""
    from vanderbei_tpu.ops.kkt import UbTail, tail_matvec, tail_rmatvec
    rng = np.random.default_rng(8)
    m1, k, n = 12, 10, 20
    A1 = rng.normal(size=(m1, n))
    idx2 = np.asarray(rng.choice(n, size=k, replace=False), dtype=np.int32)
    w2 = np.ones(k)
    E = 10.0 ** rng.uniform(-10, 10, m1 + k)
    D = 10.0 ** rng.uniform(-10, 10, n)
    ry = rng.normal(size=m1 + k)
    rx = rng.normal(size=n)
    ub = UbTail(jnp.asarray(idx2), jnp.asarray(w2))
    fac = kkt_factor(jnp.asarray(A1), jnp.asarray(E), jnp.asarray(D),
                     1e-14, ub=ub)
    dy, dx = kkt_solve(jnp.asarray(A1), jnp.asarray(E), jnp.asarray(D),
                       fac, jnp.asarray(ry), jnp.asarray(rx), ub=ub)
    dy = np.asarray(dy); dx = np.asarray(dx)
    Afdx = np.asarray(tail_matvec(jnp.asarray(A1), ub, jnp.asarray(dx)))
    Afty = np.asarray(tail_rmatvec(jnp.asarray(A1), ub, jnp.asarray(dy)))
    r1 = ry + E * dy - Afdx
    r2 = rx - Afty - D * dx
    scale = max(np.max(np.abs(ry)), np.max(np.abs(rx))) + 1
    assert np.max(np.abs(np.concatenate([r1, r2]))) < 1e-6 * scale


def _assembled(fac):
    """M recovered from the Jacobi-scaled factor: S M S = L L'."""
    L = np.asarray(fac.L, np.float64)
    s = np.asarray(fac.s, np.float64)
    return (L @ L.T) / np.outer(s, s)


@pytest.mark.parametrize("factor_dtype", [None, jnp.float32])
@pytest.mark.parametrize("form", ["primal", "dual", "ub_tail"])
def test_kkt_factor_assembles_normal_matrix(form, factor_dtype):
    """kkt_factor forms the primal (E + A D^-1 A'), dual (D + A' E^-1 A)
    or Schur-eliminated UbTail normal matrix, in f64 or in f32 for an f32
    factor."""
    from vanderbei_tpu.ops.kkt import UbTail
    rng = np.random.default_rng(10)
    m, n = (14, 8) if form == "dual" else (8, 14)
    A = rng.normal(size=(m, n))
    D = rng.uniform(0.5, 2.0, n)
    ub = None
    if form == "ub_tail":
        idx2 = np.array([2, 5, 11, 0], dtype=np.int32)
        w2 = np.array([1.0, 0.5, 2.0, 0.0])          # last row: padding
        E = rng.uniform(0.5, 2.0, m + len(idx2))
        Dt = 1.0 / D
        Dt[idx2[:3]] = 1.0 / (D[idx2[:3]] + w2[:3] ** 2 / E[m:m + 3])
        ref = np.diag(E[:m]) + (A * Dt) @ A.T
        ub = UbTail(jnp.asarray(idx2), jnp.asarray(w2))
    else:
        E = rng.uniform(0.5, 2.0, m)
        ref = (np.diag(E) + (A / D) @ A.T if form == "primal"
               else np.diag(D) + (A.T / E) @ A)
    fac = kkt_factor(jnp.asarray(A), jnp.asarray(E), jnp.asarray(D), 1e-14,
                     factor_dtype=factor_dtype, ub=ub)
    assert fac.L.dtype == (jnp.float32 if factor_dtype else jnp.float64)
    assert fac.L.shape == ref.shape
    tol = 1e-5 if factor_dtype else 1e-12
    np.testing.assert_allclose(_assembled(fac), ref,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_scaled_syrk(dtype):
    from vanderbei_tpu.ops.kkt import scaled_syrk
    rng = np.random.default_rng(11)
    A = rng.normal(size=(12, 30))
    s = rng.uniform(0.1, 10.0, 30)
    e = rng.uniform(0.5, 1.0, 12)
    M = scaled_syrk(jnp.asarray(A), jnp.asarray(s), jnp.asarray(e), dtype)
    assert M.dtype == dtype
    ref = (A * s) @ A.T + np.diag(e)
    tol = 1e-6 if dtype == jnp.float32 else 1e-13
    np.testing.assert_allclose(np.asarray(M, np.float64), ref,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("factor_dtype", ["f64", "f32"])
def test_kkt_solver_end_to_end(factor_dtype):
    """A whole HSD solve through the plain Cholesky path, with an f64 and
    with an f32 factor (f64 data and refinement), against HiGHS."""
    from vanderbei_tpu.core.canonicalize import canonicalize
    from vanderbei_tpu.core.status import Status
    from vanderbei_tpu.io.synthetic import highs_reference, random_lp
    from vanderbei_tpu.models import hsd

    lp = random_lp(20, 40, density=0.2, ub_frac=0.25, seed=21)
    canon = canonicalize(lp, pad_to=1)
    st, x, *_ = hsd.solve_canon(
        jnp.asarray(canon.A), jnp.asarray(canon.b), jnp.asarray(canon.c),
        canon.f, factor_dtype=factor_dtype)
    assert int(st) == int(Status.OPTIMAL)
    obj = -(float(canon.c[:canon.n] @ np.asarray(x)[:canon.n]) + canon.f)
    _, ref = highs_reference(lp)
    assert abs(obj - ref) / max(1.0, abs(ref)) < 1e-6
