"""Dense reduced-KKT engine.

The reference factors the quasi-definite augmented matrix
K = [[-E, A], [A', D]] with a sparse LDL' (src/ipo/ldlt.c:189-200, where the
internal transposed LP makes its documented K equal this one in our row/col
naming), then solves with iterative refinement (ldlt.c:327-416).

Dense redesign: instead of pointer-chasing sparse LDL', we reduce K to
SPD *normal equations*, form them with one matrix product and
Cholesky-factor them densely (cuSOLVER on the GPU):

    primal form (m <= n):  (E + A D^-1 A') dy = A D^-1 rx - ry
                           dx = D^-1 (rx - A' dy)
    dual   form (m >  n):  (D + Q + A' E^-1 A) dx = rx + A' E^-1 ry
                           dy = E^-1 (A dx - ry)

The primal-vs-dual choice mirrors the reference's ADA'-vs-A'DA fill
heuristic (ldlt.c:687-717) but here is a static shape decision.  The
epsdiag clamp mirrors ldlt.c:235-236; refinement stops at
refine_tol * (max|rhs|+1) or when the residual stops halving (ldlt.c:411),
reverting the last correction if it made things worse (ldlt.c:413-416).

Numerical failure handling mirrors the reference's epsdiag escalation
(ldlt.c:293-306): if the Cholesky factor contains NaN/Inf the matrix is
re-factored with a geometrically growing Tikhonov term.  The reference's
additional LDL' luxury — exact factorization of the augmented quasi-definite
K itself — is deliberately NOT compiled into the iteration program: a dense
O((m+n)^3) fallback branch would multiply compile time and the factor's
cost; the two-stage f32->f64 precision ladder (models/registry.py) plays
its role instead.

Q (quadratic objective) enters the dual form's n x n block exactly where the
reference adds it to K's upper-left block (ldlt.c:253-257); with the primal
form Q must be None (the reference's primal ordering likewise only pays off
for LPs).

All tolerances are TRACED scalars, not Python constants: changing a
tolerance must not trigger a recompile (compiling a solver loop is the
slowest part of a cold solve).  Only shapes, dtypes and code paths are
static.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve


def use_primal_form(m: int, n: int, has_q: bool) -> bool:
    return (m <= n) and not has_q


class UbTail(NamedTuple):
    """Structure descriptor for canonical tail rows that are SINGLETON
    upper-bound rows (w2[i] * x[idx2[i]] <= b2[i]) or benign padding
    (w2[i] = 0).

    The reference canonicalizes finite bounds into extra rows
    (solve.c:152-174) and lets its sparse LDL' absorb them; densely they
    would quadratically poison the factor (KEN-11: 14.7k real rows + 36k
    bound rows).  Their block of the normal equations is DIAGONAL, so the
    factor Schur-eliminates them analytically: the effective column weight
    becomes the harmonic combination 1/(D_j + w^2/E2_row(j)) — the
    classic bounded-variable IPM diagonal — and only the m1 x m1 system is
    ever factored.  idx2 values for padding rows are arbitrary (weight 0).
    """
    idx2: jax.Array   # (k,) int32 column index per tail row
    w2: jax.Array     # (k,) coefficient per tail row (0 = padding)


def tail_matvec(A1, ub: UbTail, x):
    """[A1; S] @ x where S are the ub/padding tail rows."""
    return jnp.concatenate([A1 @ x, ub.w2 * x[ub.idx2]])


def tail_rmatvec(A1, ub: UbTail, y):
    """[A1; S]' @ y."""
    m1 = A1.shape[0]
    out = A1.T @ y[:m1]
    return out.at[ub.idx2].add(ub.w2 * y[m1:])


class KKTFactor(NamedTuple):
    """Cholesky factor of the Jacobi-scaled normal matrix.

    L is the lower factor of Ms = S M S with S = diag(1/sqrt(diag M));
    s carries the scaling vector.  L may be a lower precision than the
    problem data (mixed-precision path) — solves cast through L.dtype and
    the refinement in kkt_solve recovers accuracy.  g2 is the diagonal of
    the Schur-eliminated ub-tail block (UbTail path), None otherwise.
    """
    L: jax.Array
    s: jax.Array
    g2: jax.Array = None
    reg: jax.Array = None    # Tikhonov level the factor ended at (see below)


def scaled_syrk(A, s, e, dtype):
    """M = A diag(s) A' + diag(e), formed in dtype.

    Under the package's "highest" matmul precision an f32 product keeps
    full f32 accuracy (no TF32)."""
    A, s, e = A.astype(dtype), s.astype(dtype), e.astype(dtype)
    return (A * s[None, :]) @ A.T + jnp.diag(e)


def kkt_factor(A, E, D, epsdiag, Q=None, factor_dtype=None,
               ub: UbTail | None = None, reg0=None):
    """Cholesky-factor the reduced normal-equations matrix.

    E, D are clamped below by epsdiag like the reference clamps K's
    diagonal (ldlt.c:235-236).  The matrix is symmetrically Jacobi-scaled
    to unit diagonal before factoring — the diagonal spread of IPM normal
    matrices is exactly what kills their conditioning, so this both
    stabilizes f64 and makes an f32 factor usable, with the
    refinement in kkt_solve recovering the remaining digits.

    Near convergence the scaled matrix can still go numerically indefinite;
    the reference escalates its diagonal perturbation 10x when the factor
    degenerates (ldlt.c:293-306).  Dense analogue: retry the Cholesky with
    a geometrically growing Tikhonov term until the factor is NaN-free.

    reg0: traced scalar seeding the escalation — the level the PREVIOUS
    iteration's factor needed (carried in the solver state, mirroring the
    reference's STICKY epsdiag escalation which persists for the rest of
    the solve).  Without it a degenerate endgame re-pays the whole
    NaN-retry ladder (up to ~7 sequential refactorizations) every
    iteration (GREENBEA class, r4).  The achieved level is returned in
    KKTFactor.reg.
    """
    m, n = A.shape
    epsdiag = jnp.asarray(epsdiag, A.dtype)
    Ec = jnp.maximum(E, epsdiag)
    Dc = jnp.maximum(D, epsdiag)
    g2 = None
    if ub is not None:
        # Schur-eliminate the singleton ub tail: factor only the m1 x m1
        # head with harmonically reduced column weights (see UbTail)
        assert Q is None, "ub tail structure requires the primal (LP) form"
        m1 = m
        E1, E2 = Ec[:m1], Ec[m1:]
        Dinv = 1.0 / Dc
        d2 = ub.w2 * ub.w2 * Dinv[ub.idx2]
        g2 = E2 + d2
        corr = d2 * Dinv[ub.idx2] / g2       # exactly 0 on padding rows
        Dt = Dinv.at[ub.idx2].add(-corr)     # = 1/(D_j + w^2/E2): harmonic
        Ec = E1
    # an f32 factor discards M's extra f64 digits anyway, so M is formed
    # in f32 too
    mdtype = (jnp.float32 if factor_dtype is not None
              and jnp.dtype(factor_dtype) == jnp.float32 else A.dtype)
    if ub is not None:
        M = scaled_syrk(A, Dt, Ec, mdtype)
    elif use_primal_form(m, n, Q is not None):
        M = scaled_syrk(A, 1.0 / Dc, Ec, mdtype)
    else:
        M = scaled_syrk(A.T, 1.0 / Ec, Dc, mdtype)
        if Q is not None:
            M = M + Q.astype(mdtype)

    # the scaling vector stays at DATA precision: solves multiply through
    # it, and truncating it would cap refinement at factor accuracy
    d = jnp.diagonal(M).astype(A.dtype)
    s = jax.lax.rsqrt(jnp.maximum(d, jnp.asarray(1e-300 if A.dtype == jnp.float64 else 1e-30, A.dtype)))
    s_m = s.astype(M.dtype)
    Ms = M * s_m[:, None] * s_m[None, :]
    if factor_dtype is not None:
        Ms = Ms.astype(factor_dtype)
    eye = jnp.eye(M.shape[0], dtype=Ms.dtype)
    floor = 1.0e-14 if Ms.dtype == jnp.float64 else 1.0e-7
    r0 = (jnp.zeros((), Ms.dtype) if reg0 is None
          else jnp.asarray(reg0, Ms.dtype))

    L0 = jnp.linalg.cholesky(Ms + r0 * eye)

    def bad(L):
        return jnp.any(jnp.isnan(L) | jnp.isinf(L))

    def cond(carry):
        reg, L = carry
        return bad(L) & (reg < 1.0e-2)

    def body(carry):
        reg, L = carry
        new_reg = jnp.where(reg == 0.0, floor, reg * 100.0).astype(Ms.dtype)
        return new_reg, jnp.linalg.cholesky(Ms + new_reg * eye)

    reg, L = jax.lax.while_loop(cond, body, (r0, L0))
    return KKTFactor(L, s, g2, reg)


def _scaled_cho_solve(fac: KKTFactor, t):
    """Solve M u = t through the scaled factor: u = S Ms^-1 S t.

    t: (m, k) — multiple right-hand sides share the one factor (and one
    triangular-solve chain), the reason the HSD step folds its f- and
    g-systems into a single call."""
    st = (fac.s[:, None] * t).astype(fac.L.dtype)
    u = cho_solve((fac.L, True), st)
    return fac.s[:, None] * u.astype(fac.s.dtype)


def _raw_solve(A, Ec, Dc, fac: KKTFactor, ry, rx, Q=None, ub=None):
    """One forward/backward pass: K [dy; dx] = [ry; rx] via the factor.

    ry: (m, k), rx: (n, k) column-stacked right-hand sides."""
    m, n = A.shape
    if ub is not None:
        # Schur path: solve the m1 head, back out the diagonal tail
        m1 = m
        Dinv = (1.0 / Dc)[:, None]
        g2 = fac.g2[:, None]
        w2 = ub.w2[:, None]
        rxD = rx * Dinv
        t2 = w2 * rxD[ub.idx2] - ry[m1:]
        # t~1 = A1 (D^-1 rx - scatter(w2 D^-1[idx] t2 / g2)) - ry1
        fold = rxD.at[ub.idx2].add(-w2 * Dinv[ub.idx2] * t2 / g2)
        t1 = A @ fold - ry[:m1]
        dy1 = _scaled_cho_solve(fac, t1)
        aty = A.T @ dy1
        dy2 = (t2 - w2 * Dinv[ub.idx2] * aty[ub.idx2]) / g2
        dx = (rx - aty - jnp.zeros_like(rx).at[ub.idx2].add(w2 * dy2)) * Dinv
        return jnp.concatenate([dy1, dy2]), dx
    if use_primal_form(m, n, Q is not None):
        t = A @ (rx / Dc[:, None]) - ry
        dy = _scaled_cho_solve(fac, t)
        dx = (rx - A.T @ dy) / Dc[:, None]
    else:
        t = rx + A.T @ (ry / Ec[:, None])
        dx = _scaled_cho_solve(fac, t)
        dy = (A @ dx - ry) / Ec[:, None]
    return dy, dx


def kkt_solve(A, E, D, L, rhs_y, rhs_x, *, Q=None,
              epsdiag=1.0e-14,
              refine_tol=1.0e-10,
              max_refine: int = 8,
              compensated: bool = False,
              ub: UbTail | None = None):
    """Solve [[-E, A], [A', D+Q]] [dy; dx] = [rhs_y; rhs_x] with refinement.

    The residuals are evaluated against the TRUE (unclamped) E, D while the
    factor uses the clamped ones, exactly like the reference's solve()
    (ldlt.c:389-398 uses the caller's Dn/Dm; inv_num clamped the diagonal).
    epsdiag / refine_tol are traced scalars; max_refine bounds the
    refinement while_loop (static — it shapes the program).

    compensated=True evaluates refinement residuals with error-free
    transforms (ops/quad.matvec2) — twice the working precision, the
    QuadPrec-mode analogue (reference -DQuadPrec rebinds these kernels,
    Quad.h:43-44) — letting refinement converge below the plain-matvec
    roundoff floor on ill-conditioned systems.
    """
    epsdiag = jnp.asarray(epsdiag, A.dtype)
    refine_tol = jnp.asarray(refine_tol, A.dtype)
    Ec = jnp.maximum(E, epsdiag)
    Dc = jnp.maximum(D, epsdiag)
    # normalize rhs to column-stacked (dim, k); restore shape on return
    single = rhs_y.ndim == 1
    if single:
        rhs_y = rhs_y[:, None]
        rhs_x = rhs_x[:, None]
    if compensated:
        from .quad import matvec2
        col_mv2 = jax.vmap(matvec2, in_axes=(None, 1), out_axes=1)
        base_mv = col_mv2
        base_mvT = lambda M, v: col_mv2(M.T, v)
    else:
        base_mv = lambda M, v: M @ v
        base_mvT = lambda M, v: M.T @ v
    if ub is not None:
        m1 = A.shape[0]
        mv = lambda M, v: jnp.concatenate([base_mv(M, v),
                                           ub.w2[:, None] * v[ub.idx2]])
        mvT = lambda M, v: base_mvT(M, v[:m1]).at[ub.idx2].add(
            ub.w2[:, None] * v[m1:])
    else:
        mv, mvT = base_mv, base_mvT

    def residual(dy, dx):
        r1 = rhs_y + E[:, None] * dy - mv(A, dx)
        if Q is None:
            r2 = rhs_x - mvT(A, dy) - D[:, None] * dx
        else:
            r2 = rhs_x - mvT(A, dy) - D[:, None] * dx - base_mv(Q, dx)
        return r1, r2

    def max_resid(dy, dx):
        r1, r2 = residual(dy, dx)
        return jnp.maximum(jnp.max(jnp.abs(r1)), jnp.max(jnp.abs(r2)))

    dy, dx = _raw_solve(A, Ec, Dc, L, rhs_y, rhs_x, Q, ub=ub)
    maxbc = jnp.maximum(jnp.max(jnp.abs(rhs_y)), jnp.max(jnp.abs(rhs_x))) + 1.0
    maxrs = max_resid(dy, dx)

    def cond(carry):
        dy, dx, ey, ex, maxrs, oldmaxrs, it = carry
        return ((maxrs > refine_tol * maxbc)
                & (maxrs < 0.5 * oldmaxrs)
                & (it < max_refine))

    def body(carry):
        dy, dx, _, _, maxrs, _, it = carry
        r1, r2 = residual(dy, dx)
        ey, ex = _raw_solve(A, Ec, Dc, L, r1, r2, Q, ub=ub)
        dy2, dx2 = dy + ey, dx + ex
        return dy2, dx2, ey, ex, max_resid(dy2, dx2), maxrs, it + 1

    init = (dy, dx, jnp.zeros_like(dy), jnp.zeros_like(dx),
            maxrs, jnp.asarray(jnp.inf, maxrs.dtype), 0)
    dy, dx, ey, ex, maxrs, oldmaxrs, it = jax.lax.while_loop(cond, body, init)

    # revert the last correction if it made the residual worse (ldlt.c:413-416)
    worse = (maxrs > oldmaxrs) & (it > 0)
    dy = jnp.where(worse, dy - ey, dy)
    dx = jnp.where(worse, dx - ex, dx)
    if single:
        dy = dy[:, 0]
        dx = dx[:, 0]
    return dy, dx


def augmented_qr_solve(A, E, D, rhs_y, rhs_x, Q=None):
    """Exact dense solve of the full quasi-definite K via Householder QR.

    The reference's factorization operates on the augmented K itself
    (ldlt.c:189-200), which is what keeps it accurate when the E/D spread
    reaches 1e13+ near convergence.  This O((m+n)^3) routine is the dense
    equivalent, through QR like ops/linalg.qr_solve; it is a standalone
    diagnostic/verification tool — NOT compiled into solver loops, where its
    cost (compile and run) is never justified.
    """
    from .linalg import qr_solve
    m, n = A.shape
    top = jnp.concatenate([-jnp.diag(E), A], axis=1)
    lower_right = jnp.diag(D) if Q is None else jnp.diag(D) + Q
    bot = jnp.concatenate([A.T, lower_right], axis=1)
    K = jnp.concatenate([top, bot], axis=0)
    sol = qr_solve(K, jnp.concatenate([rhs_y, rhs_x]))
    return sol[:m], sol[m:]
