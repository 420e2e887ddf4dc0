"""Homogeneous self-dual interior-point methods.

Two variants sharing one jitted loop skeleton:

- "hsd": the reference ipo's default METHOD (src/ipo/hsd.c:27-311) —
  alternating predictor (delta=0 on even iterations) / corrector (delta=1 on
  odd), step factor 0.95, stop at mu < 1e-12 with status decided by the sign
  of phi vs psi and the objectives (hsd.c:155-176).
- "hsdls": the long-step variant (src/ipo/hsdls.c:37-293) — beta=0.8
  neighborhood, delta = 2(1-beta), per-coordinate quadratic linesearch
  keeping every product x_j z_j inside the beta-neighborhood
  (hsdls.c:296-336), extra status 7 (suboptimal/numerical).

The embedding solves max c'x, Ax <= b, x >= 0 homogenized with (phi, psi);
each iteration does ONE KKT factorization and TWO solves (the f- and
g-systems, hsd.c:220-231) combined through the dphi formula (hsd.c:230-238).
De-homogenization divides by phi at exit (hsd.c:277-284).

Compile-economy design (compiling this loop is the slowest part of a cold
solve): every numeric knob (eps, step factor, beta, iteration limit,
pause threshold) is a TRACED scalar, so one compiled executable per
(padded shape, dtype, factor path) serves all configurations.  Solves can
PAUSE at a traced mu threshold and RESUME from a carried state pytree —
this single mechanism provides (a) the two-stage f32->f64 mixed-precision
ladder that replaces f64-everywhere solving, (b) the warm-start/checkpoint
API (reference analogue: in-process basis persistence across refactor,
lueta.c:104-131).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.status import Status
from ..ops.kkt import kkt_factor, kkt_solve, UbTail, tail_matvec, tail_rmatvec

DEFAULT_MAX_ITER = 200      # hsd.c:25
DEFAULT_MAX_ITER_LS = 600   # hsdls.c:25
STALL_LIMIT = 15            # consecutive non-improving iterations -> stop

HSD_BANNER = (
    "--------------------------------------------------------------------------\n"
    "         |           Primal          |            Dual           |       |\n"
    "  Iter   |  Obj Value       Infeas   |  Obj Value       Infeas   |  mu   |\n"
    "- - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - ")


def _trace_row(it, pobj, normr, dobj, norms, mu):
    """Host-side printer for one iteration row (hsd.c:206-208 format)."""
    print(f"{int(it):8d}   {float(pobj):14.7e}  {float(normr):8.1e}    "
          f"{float(dobj):14.7e}  {float(norms):8.1e}  {float(mu):8.1e}",
          flush=True)


class HsdState(NamedTuple):
    x: jax.Array
    z: jax.Array
    y: jax.Array
    w: jax.Array
    phi: jax.Array
    psi: jax.Array
    iter: jax.Array
    status: jax.Array
    # sticky Tikhonov level of the KKT factor (ops/kkt.kkt_factor reg0):
    # the reference's epsdiag escalation persists once triggered
    # (ldlt.c:293-306); carrying it avoids re-paying the NaN-retry ladder
    # every iteration on degenerate endgames
    reg: jax.Array = None
    # stall detector: best mu seen and consecutive non-improving
    # iterations.  A degenerate embedding (GREENBEA class) wanders for
    # 100+ iterations before going non-finite; the reference burns its
    # full 200-iteration budget there (its table rows say "iteration
    # limit").  Stopping SUBOPTIMAL after `stall_limit` non-improving
    # iterations reports the same honest outcome in a fraction of the
    # wall, and the registry's retry chain still gets its shot.
    mu_best: jax.Array = None
    stall: jax.Array = None


def _hsd_linesearch(v, dv, s, ds, beta, delta, mu):
    """Largest theta keeping (v+t*dv)(s+t*ds) >= (1-beta)*mu*(1+t(1-delta)...)

    Vectorized port of the quadratic-root logic in hsdls.c:296-336: solves
    a t^2 + b t + c = 0 elementwise with the reference's case analysis and
    returns +inf where any step is admissible.
    """
    a = dv * ds
    b = s * dv + v * ds + (1.0 - beta) * (1.0 - delta) * mu
    c = v * s - (1.0 - beta) * mu
    d = b * b - 4.0 * a * c
    sqrt_d = jnp.sqrt(jnp.maximum(d, 0.0))
    inf = jnp.asarray(jnp.inf, v.dtype)

    lin = -c / b                                    # a == 0
    stable = 2.0 * c / (-b + sqrt_d)                # root avoiding cancellation
    classic = (-b - sqrt_d) / (2.0 * a)

    pos_a = jnp.where(b < 0.0, jnp.where(d >= 0.0, stable, inf), inf)
    neg_a = jnp.where(b < 0.0, stable, classic)
    return jnp.where(a == 0.0, lin, jnp.where(a > 0.0, pos_a, neg_a))


def init_state(A, extra_rows: int = 0) -> HsdState:
    """All-ones homogeneous start (hsd.c:98-109).

    extra_rows: count of implicit ub-tail rows (UbTail path) beyond A's
    own rows — y/w span the FULL canonical row space either way.
    """
    m, n = A.shape
    m = m + extra_rows
    dtype = A.dtype
    one = jnp.ones((), dtype)
    return HsdState(jnp.ones((n,), dtype), jnp.ones((n,), dtype),
                    jnp.ones((m,), dtype), jnp.ones((m,), dtype),
                    one, one, jnp.asarray(0),
                    jnp.asarray(int(Status.RUNNING)),
                    jnp.zeros((), dtype),
                    jnp.asarray(jnp.inf, dtype), jnp.asarray(0))


def cast_state(state: HsdState, dtype) -> HsdState:
    """Promote/demote a paused state between precision stages.

    The sticky factor regularization resets to 0: it is calibrated to the
    OLD precision's unit roundoff (an f32-stage level of 1e-7 would wreck
    f64 factor accuracy).  The stall counter resets too — the new
    precision stage deserves a fresh chance to make progress."""
    return HsdState(
        *(leaf.astype(dtype) for leaf in state[:6]),
        state.iter, state.status, jnp.zeros((), dtype),
        state.mu_best.astype(dtype), jnp.asarray(0))


def make_step(A, b, c, *,
              eps=1.0e-12,
              step_factor=0.95,
              beta=0.80,
              epsdiag=1.0e-14,
              refine_tol=1.0e-10,
              gap_tol=1.0e-6,
              feas_tol=1.0e-6,
              long_step: bool = False,
              max_refine: int = 8,
              trace: bool = False,
              f=0.0,
              factor_dtype=None,
              compensated: bool = False,
              corrector: str = "mehrotra",
              ub: UbTail | None = None):
    """Build the single-iteration step function state -> state.

    This is the framework's flagship 'forward step': one KKT factorization,
    two solves, the dphi combination, the ratio test/linesearch, and the
    update — everything inside one jit-compatible function, reusable by the
    while_loop driver, vmapped batching, and the mesh dry-run.

    eps / step_factor / beta / epsdiag / refine_tol / f may be traced
    scalars; long_step / max_refine / trace / factor_dtype / corrector are
    static (they shape the program).

    corrector (short-step "hsd" only; hsdls keeps its linesearch):
      "mehrotra"  (default) — one factorization drives BOTH a predictor
        (affine) and a second-order corrector solve per iteration, with
        adaptive centering delta = (mu_aff/mu)^3.  The reference instead
        alternates delta=0 / delta=1 across ITERATIONS (hsd.c:138-142),
        paying a full factorization for each half — Mehrotra's fusion
        roughly halves the trip count at ~1.4x the per-trip cost, the
        classic IPM trade that always wins when the factor dominates.
      "reference" — the hsd.c:138-142 alternating scheme, bit-faithful to
        the reference's trajectory (for trace-parity work).
    """
    m, n = A.shape
    if ub is not None:
        m = m + ub.idx2.shape[0]     # y/w span the implicit tail rows too
    dtype = A.dtype
    if compensated:
        # QuadPrec-mode arithmetic (reference -DQuadPrec, Quad.h:43-44):
        # residuals and inner products evaluated in twice the working
        # precision via error-free transforms (ops/quad.py)
        from ..ops.quad import matvec2, dot2
        base_mv = matvec2
        base_mvT = lambda M, v: matvec2(M.T, v)
        dot = dot2
    else:
        base_mv = lambda M, v: M @ v
        base_mvT = lambda M, v: M.T @ v
        dot = lambda a, b: a @ b
    if ub is not None:
        m1 = A.shape[0]
        mv = lambda M, v: jnp.concatenate([base_mv(M, v),
                                           ub.w2 * v[ub.idx2]])
        mvT = lambda M, v: base_mvT(M, v[:m1]).at[ub.idx2].add(
            ub.w2 * v[m1:])
    else:
        mv, mvT = base_mv, base_mvT

    def body(s: HsdState):
        x, z, y, w, phi, psi = s.x, s.z, s.y, s.w, s.phi, s.psi

        mu = (dot(z, x) + dot(w, y) + phi * psi) / (n + m + 1)
        if long_step:
            delta = jnp.asarray(2.0 * (1.0 - beta), dtype)  # hsdls.c:113
        else:
            delta = jnp.where(s.iter % 2 == 0, 0.0, 1.0)    # hsd.c:138-142

        primal_obj = dot(c, x)
        dual_obj = dot(b, y)

        # infeasibilities (hsd.c:182-198); computed before stepping, in the
        # reference's order, so the trace row matches its table — and
        # before the stop test, which gates on their de-homogenized norms
        rho = mv(A, x) - b * phi + w        # (m,) incl. implicit tail rows
        sigma = -mvT(A, y) + c * phi + z

        # stopping rule (hsd.c:155-176 / hsdls.c:134-154) with an extra
        # QUALITY GATE the reference lacks: on hard instances (FORPLAN)
        # the homogenizing phi can collapse toward 0 faster than the
        # residuals, so mu < eps is met while the DE-HOMOGENIZED point
        # still carries an O(1e-4) duality gap — the reference would
        # report that point "optimal" too if its trajectory got there
        # (it happens to hit its iteration limit instead).  Gate the
        # OPTIMAL certificate on the de-homogenized relative gap; a
        # converged-but-poor point reports SUBOPTIMAL (status 7,
        # hsdls.c:151's meaning) and the registry can fall back to the
        # path-following solver.
        converged = mu < eps
        if long_step:
            opt_test = phi > eps
        else:
            opt_test = phi > psi
        scale = 1.0 + jnp.abs(primal_obj) / phi
        gap_rel = (dual_obj - primal_obj) / phi / scale
        # de-homogenized complementarity: mu < eps can be reached through
        # phi^2 shrinking alone (MODSZK1: x'z/phi^2 ~ 0.03 with a 1e-7
        # "gap" — the residuals conspire); this is the sharper signal
        comp_rel = (dot(z, x) + dot(w, y)) / (phi * phi) / scale
        # de-homogenized primal/dual feasibility: a converged embedding
        # can still carry O(1e-4) residuals at the de-homogenized point
        # (BRANDY reports "optimal" 3.5e-4 off the true optimum with gap
        # and complementarity both tiny — only ||rho||/phi betrays it).
        # Norms are relative to ||b||, ||c|| like the reference's EPSSOL
        # test normalizes by max|b|,|c| (ldlt.c:370-416 refinement target).
        pinf_rel = jnp.sqrt(dot(rho, rho)) / phi / (1.0 + jnp.sqrt(dot(b, b)))
        dinf_rel = jnp.sqrt(dot(sigma, sigma)) / phi / (1.0 + jnp.sqrt(dot(c, c)))
        # objective-sensitivity signals: a residual that passes the
        # norm-relative tests can still shift the OBJECTIVE by ~|y'rho|
        # (resp. |x'sigma|) — GREENBEB r4 certified OPTIMAL at relerr
        # 2.6e-5 exactly this way (tiny ||rho||/||b|| against large
        # duals).  These dots bound the de-homogenized objective error
        # directly, relative to the same scale as the gap test.
        perr = jnp.abs(dot(y, rho)) / (phi * phi) / scale
        derr = jnp.abs(dot(x, sigma)) / (phi * phi) / scale
        good = ((gap_rel <= gap_tol) & (comp_rel <= gap_tol)
                & (pinf_rel <= feas_tol) & (dinf_rel <= feas_tol)
                & (perr <= 10.0 * gap_tol) & (derr <= 10.0 * gap_tol))
        fallback = int(Status.SUBOPTIMAL) if long_step else int(Status.DUAL_INFEASIBLE)
        final = jnp.where(
            opt_test,
            jnp.where(good, int(Status.OPTIMAL), int(Status.SUBOPTIMAL)),
            jnp.where(dual_obj < 0.0, int(Status.PRIMAL_INFEASIBLE),
                      jnp.where(primal_obj > 0.0, int(Status.DUAL_INFEASIBLE),
                                fallback)))
        # stall detector (see HsdState.mu_best): STALL_LIMIT consecutive
        # iterations without a 10% mu improvement -> stop now instead of
        # wandering to the iteration limit / a NaN step.  A stall in the
        # NEAR-CONVERGED zone (mu within ~1e3 of the stop tolerance —
        # f64 roundoff simply cannot push mu further) takes the normal
        # quality-gated verdict `final`: the de-homogenized point is
        # often already optimal to tolerance (BNL2 stalls at relerr
        # 2.4e-7), and the gate separates those from true failures.
        improved = mu < 0.9 * s.mu_best
        stall2 = jnp.where(improved, 0, s.stall + 1)
        mu_best2 = jnp.minimum(s.mu_best, mu)
        stalled = stall2 >= STALL_LIMIT
        mu_small = mu < jnp.maximum(eps * 1.0e3, 1.0e-9)
        new_status = jnp.where(
            converged | (stalled & mu_small), final,
            jnp.where(stalled, int(Status.SUBOPTIMAL),
                      int(Status.RUNNING)))

        if trace:
            normr = jnp.sqrt(rho @ rho) / phi
            norms = jnp.sqrt(sigma @ sigma) / phi
            jax.debug.callback(
                _trace_row, s.iter, primal_obj / phi + f, normr,
                dual_obj / phi + f, norms, mu)

        def step(_):
            D = z / x
            E = w / y

            fac = kkt_factor(A, E, D, epsdiag, factor_dtype=factor_dtype,
                             ub=ub, reg0=s.reg)

            def directions(dlt, so_x, so_y, so_phi, gy, gx, fy, fx):
                """Fold a (delta, second-order) Newton system through the
                shared f/g combination (hsd.c:230-238).  so_* are the
                second-order complementarity products (0 on the predictor
                and in "reference" mode)."""
                dphi = ((dot(c, fx) - dot(b, fy)
                         + (-(1.0 - dlt) * (dual_obj - primal_obj + psi)
                            + psi - dlt * mu / phi + so_phi / phi))
                        / (dot(c, gx) - dot(b, gy) - psi / phi))
                dx = fx - gx * dphi
                dy = fy - gy * dphi
                dz = dlt * mu / x - z - D * dx - so_x / x
                dw = dlt * mu / y - w - E * dy - so_y / y
                dpsi = dlt * mu / phi - psi - (psi / phi) * dphi - so_phi / phi
                return dx, dy, dz, dw, dphi, dpsi

            def f_rhs(dlt, so_x, so_y):
                rho_rhs = -(1.0 - dlt) * rho + w - dlt * mu / y + so_y / y
                sigma_rhs = -(1.0 - dlt) * sigma + z - dlt * mu / x + so_x / x
                return rho_rhs, sigma_rhs

            zero_x = jnp.zeros_like(x)
            zero_y = jnp.zeros_like(y)
            zero_s = jnp.zeros_like(phi)

            if corrector == "mehrotra" and not long_step:
                # predictor: affine (delta=0) f-system + the g-system share
                # one 2-column solve through the factor
                r_aff, s_aff = f_rhs(0.0, zero_x, zero_y)
                sy, sx = kkt_solve(A, E, D, fac,
                                   jnp.stack([r_aff, -b], axis=1),
                                   jnp.stack([-s_aff, -c], axis=1),
                                   epsdiag=epsdiag, refine_tol=refine_tol,
                                   max_refine=max_refine,
                                   compensated=compensated, ub=ub)
                fy, gy = sy[:, 0], sy[:, 1]
                fx, gx = sx[:, 0], sx[:, 1]
                dx_a, dy_a, dz_a, dw_a, dphi_a, dpsi_a = directions(
                    0.0, zero_x, zero_y, zero_s, gy, gx, fy, fx)

                # full affine step to the boundary -> adaptive centering
                t_a = jnp.maximum(jnp.max(-dx_a / x), jnp.max(-dz_a / z))
                t_a = jnp.maximum(t_a, jnp.max(-dy_a / y))
                t_a = jnp.maximum(t_a, jnp.max(-dw_a / w))
                t_a = jnp.maximum(t_a, -dphi_a / phi)
                t_a = jnp.maximum(t_a, -dpsi_a / psi)
                th_a = jnp.where(t_a > 0.0, jnp.minimum(1.0 / t_a, 1.0), 1.0)
                mu_aff = (dot(z + th_a * dz_a, x + th_a * dx_a)
                          + dot(w + th_a * dw_a, y + th_a * dy_a)
                          + (phi + th_a * dphi_a) * (psi + th_a * dpsi_a)
                          ) / (n + m + 1)
                sig = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)

                # corrector: second-order products target the full
                # complementarity (Mehrotra's sigma*mu - dX_a dZ_a rhs)
                so_x, so_y = dx_a * dz_a, dy_a * dw_a
                so_phi = dphi_a * dpsi_a
                r_c, s_c = f_rhs(sig, so_x, so_y)
                cy, cx = kkt_solve(A, E, D, fac,
                                   r_c[:, None], -s_c[:, None],
                                   epsdiag=epsdiag, refine_tol=refine_tol,
                                   max_refine=max_refine,
                                   compensated=compensated, ub=ub)
                dx, dy, dz, dw, dphi, dpsi = directions(
                    sig, so_x, so_y, so_phi, gy, gx, cy[:, 0], cx[:, 0])
            else:
                rho_rhs, sigma_rhs = f_rhs(delta, zero_x, zero_y)
                # the f- and g-systems (hsd.c:220-231) share the factor;
                # solve them as one 2-column rhs so the blocked
                # triangular-solve chain runs once, not twice
                sy, sx = kkt_solve(A, E, D, fac,
                                   jnp.stack([rho_rhs, -b], axis=1),
                                   jnp.stack([-sigma_rhs, -c], axis=1),
                                   epsdiag=epsdiag, refine_tol=refine_tol,
                                   max_refine=max_refine,
                                   compensated=compensated, ub=ub)
                fy, gy = sy[:, 0], sy[:, 1]
                fx, gx = sx[:, 0], sx[:, 1]
                dx, dy, dz, dw, dphi, dpsi = directions(
                    delta, zero_x, zero_y, zero_s, gy, gx, fy, fx)

            if long_step:
                theta = jnp.minimum(
                    jnp.min(_hsd_linesearch(x, dx, z, dz, beta, delta, mu)),
                    jnp.min(_hsd_linesearch(y, dy, w, dw, beta, delta, mu)))
                theta = jnp.minimum(
                    theta,
                    _hsd_linesearch(phi, dphi, psi, dpsi, beta, delta, mu))
                theta = jnp.minimum(theta, 1.0)
                theta = jnp.where(theta < 1.0, theta * 0.9999, theta)
            else:
                t = jnp.maximum(jnp.max(-dx / x), jnp.max(-dz / z))
                t = jnp.maximum(t, jnp.max(-dy / y))
                t = jnp.maximum(t, jnp.max(-dw / w))
                t = jnp.maximum(t, -dphi / phi)
                t = jnp.maximum(t, -dpsi / psi)
                theta = jnp.where(t > 0.0,
                                  jnp.minimum(step_factor / t, 1.0), 1.0)

            return (x + theta * dx, z + theta * dz,
                    y + theta * dy, w + theta * dw,
                    phi + theta * dphi, psi + theta * dpsi,
                    fac.reg.astype(dtype))

        keep = new_status != int(Status.RUNNING)
        x2, z2, y2, w2, phi2, psi2, reg2 = jax.lax.cond(
            keep, lambda _: (x, z, y, w, phi, psi, s.reg), step,
            operand=None)

        # numerical-failure guard: if the step produced any non-finite
        # value, KEEP the last finite iterate and stop SUBOPTIMAL
        # (hsdls.c:151's "suboptimal/numerical" status) — an
        # iteration-limit or failure exit must report a finite objective
        # like every reference table row does (r4: 80BAU3B/PILOT carried
        # status=5 with objective=nan)
        ok = (jnp.isfinite(phi2) & jnp.isfinite(psi2)
              & jnp.all(jnp.isfinite(x2)) & jnp.all(jnp.isfinite(z2))
              & jnp.all(jnp.isfinite(y2)) & jnp.all(jnp.isfinite(w2)))

        def pick(new, old):
            return jnp.where(ok, new, old)

        return HsdState(pick(x2, x), pick(z2, z), pick(y2, y),
                        pick(w2, w), pick(phi2, phi), pick(psi2, psi),
                        s.iter + 1,
                        jnp.where(ok, new_status, int(Status.SUBOPTIMAL)),
                        reg2, mu_best2, stall2)

    return body


@functools.partial(
    jax.jit,
    static_argnames=("long_step", "max_refine", "trace", "factor_dtype",
                     "compensated", "corrector"),
)
def _hsd_loop(A, b, c, f, init: HsdState, *,
              max_iter, eps, step_factor, beta, epsdiag, refine_tol,
              pause_mu,
              gap_tol=1.0e-6,
              feas_tol=1.0e-6,
              long_step: bool = False,
              max_refine: int = 8,
              trace: bool = False,
              factor_dtype=None,
              compensated: bool = False,
              corrector: str = "mehrotra",
              ub: UbTail | None = None):
    """The jitted while_loop driver: run from `init` until status is decided,
    the iteration budget is exhausted, or mu falls below `pause_mu` (a
    traced stage boundary; 0.0 = run to convergence).

    Returns the final state, NOT de-homogenized — callers pause/resume/
    finish it (finish_state)."""
    dtype = A.dtype
    eps = jnp.asarray(eps, dtype)
    step_factor = jnp.asarray(step_factor, dtype)
    beta = jnp.asarray(beta, dtype)
    epsdiag = jnp.asarray(epsdiag, dtype)
    refine_tol = jnp.asarray(refine_tol, dtype)
    pause_mu = jnp.asarray(pause_mu, dtype)
    gap_tol = jnp.asarray(gap_tol, dtype)
    feas_tol = jnp.asarray(feas_tol, dtype)
    f = jnp.asarray(f, dtype)

    body = make_step(A, b, c, eps=eps, step_factor=step_factor,
                     beta=beta, epsdiag=epsdiag, refine_tol=refine_tol,
                     gap_tol=gap_tol, feas_tol=feas_tol,
                     long_step=long_step, max_refine=max_refine,
                     trace=trace, f=f, factor_dtype=factor_dtype,
                     compensated=compensated, corrector=corrector, ub=ub)
    m, n = A.shape
    if ub is not None:
        m = m + ub.idx2.shape[0]

    def cond(s: HsdState):
        mu = (s.z @ s.x + s.w @ s.y + s.phi * s.psi) / (n + m + 1)
        return ((s.status == int(Status.RUNNING))
                & (s.iter < max_iter)
                & (mu > pause_mu))

    return jax.lax.while_loop(cond, body, init)


def finish_state(state: HsdState, max_iter):
    """Map a final loop state to the reference's outputs: status plus the
    de-homogenized (x, y, w, z) (hsd.c:277-284)."""
    status = jnp.where(
        (state.status == int(Status.RUNNING)) & (state.iter >= max_iter),
        int(Status.ITERATION_LIMIT), state.status)
    phi = state.phi
    return (status, state.x / phi, state.y / phi, state.w / phi,
            state.z / phi, state.iter)


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "long_step", "max_refine", "factor_dtype",
                     "compensated", "corrector"),
)
def _hsd_scan_metrics(A, b, c, f, init: HsdState, *,
                      max_iter: int,
                      eps, step_factor, beta, epsdiag, refine_tol,
                      long_step: bool = False,
                      max_refine: int = 8,
                      factor_dtype=None,
                      compensated: bool = False,
                      corrector: str = "mehrotra",
                      ub: UbTail | None = None):
    """Observability variant: a fixed-length lax.scan that records one
    structured metrics row PER ITERATION on device and returns the whole
    table to the host — the device-side replacement for the reference's
    per-iteration stdout trace (hsd.c:206-209), usable for regression
    dashboards without host callbacks.

    Returns (final_state, metrics) where metrics is a dict of (max_iter,)
    arrays: mu, primal_obj, dual_obj, primal_infeas, dual_infeas, valid
    (False past convergence — converged iterations no-op).
    """
    dtype = A.dtype
    m, n = A.shape
    eps = jnp.asarray(eps, dtype)
    step_factor = jnp.asarray(step_factor, dtype)
    beta = jnp.asarray(beta, dtype)
    epsdiag = jnp.asarray(epsdiag, dtype)
    refine_tol = jnp.asarray(refine_tol, dtype)
    f = jnp.asarray(f, dtype)

    if ub is not None:
        m = m + ub.idx2.shape[0]
    body = make_step(A, b, c, eps=eps, step_factor=step_factor,
                     beta=beta, epsdiag=epsdiag, refine_tol=refine_tol,
                     long_step=long_step, max_refine=max_refine,
                     trace=False, f=f, factor_dtype=factor_dtype,
                     compensated=compensated, corrector=corrector, ub=ub)

    def scan_body(s: HsdState, _):
        running = s.status == int(Status.RUNNING)
        mu = (s.z @ s.x + s.w @ s.y + s.phi * s.psi) / (n + m + 1)
        if ub is None:
            ax, aty = A @ s.x, A.T @ s.y
        else:
            ax = tail_matvec(A, ub, s.x)
            aty = tail_rmatvec(A, ub, s.y)
        rho = ax - b * s.phi + s.w
        sigma = -aty + c * s.phi + s.z
        row = dict(
            mu=mu,
            primal_obj=(c @ s.x) / s.phi + f,
            dual_obj=(b @ s.y) / s.phi + f,
            primal_infeas=jnp.sqrt(rho @ rho) / s.phi,
            dual_infeas=jnp.sqrt(sigma @ sigma) / s.phi,
            valid=running,
        )
        s2 = jax.lax.cond(running, body, lambda x: x, s)
        return s2, row

    out, rows = jax.lax.scan(scan_body, init, None, length=max_iter)
    return out, rows


def solve_canon_metrics(A, b, c, f, *,
                        max_iter: int = DEFAULT_MAX_ITER,
                        eps: float = 1.0e-12,
                        step_factor: float = 0.95,
                        long_step: bool = False,
                        beta: float = 0.80,
                        epsdiag: float = 1.0e-14,
                        refine_tol: float = 1.0e-10,
                        max_refine: int = 8,
                        factor_dtype=None,
                        compensated: bool = False,
                        corrector: str = "mehrotra",
                        ub: UbTail | None = None,
                        init: HsdState | None = None):
    """solve_canon + the per-iteration metrics table (see _hsd_scan_metrics).

    Runs exactly max_iter scanned iterations (converged ones no-op), so it
    costs the full budget — use for observability, not the fast path.
    """
    if isinstance(factor_dtype, str):
        factor_dtype = {"f32": jnp.float32, "f64": None,
                        "none": None}[factor_dtype]
    if init is None:
        init = init_state(A, extra_rows=0 if ub is None else ub.idx2.shape[0])
    out, rows = _hsd_scan_metrics(
        A, b, c, f, init, max_iter=max_iter, eps=eps,
        step_factor=step_factor, beta=beta, epsdiag=epsdiag,
        refine_tol=refine_tol, long_step=long_step, max_refine=max_refine,
        factor_dtype=factor_dtype, compensated=compensated,
        corrector=corrector, ub=ub)
    status, x, y, w, z, iters = finish_state(out, max_iter)
    return (status, x, y, w, z, iters, out), rows


def solve_canon(A, b, c, f, *,
                max_iter: int = DEFAULT_MAX_ITER,
                eps: float = 1.0e-12,
                step_factor: float = 0.95,
                long_step: bool = False,
                beta: float = 0.80,
                epsdiag: float = 1.0e-14,
                refine_tol: float = 1.0e-10,
                gap_tol: float = 1.0e-6,
                feas_tol: float = 1.0e-6,
                max_refine: int = 8,
                trace: bool = False,
                factor_dtype=None,
                pause_mu: float = 0.0,
                compensated: bool = False,
                corrector: str = "mehrotra",
                ub: UbTail | None = None,
                init: HsdState | None = None):
    """Solve max c'x, Ax <= b, x >= 0 via the HSD embedding.

    ub: implicit singleton tail rows (ops/kkt.UbTail) — A then holds only
    the general head rows; b spans head + tail.

    factor_dtype: None = factor at A's dtype; jnp.float32/"f32" = an
    f32 factor with data-precision refinement.  pause_mu > 0 pauses the
    solve once mu <= pause_mu (status stays RUNNING) — combine with
    `init=` to resume, possibly at a different precision (see
    registry._solve_hsd for the two-stage ladder).

    Returns (status, x, y, w, z, iterations, state); x,y,w,z de-homogenized.
    """
    if isinstance(factor_dtype, str):
        factor_dtype = {"f32": jnp.float32, "f64": None,
                        "none": None}[factor_dtype]
    if init is None:
        init = init_state(A, extra_rows=0 if ub is None else ub.idx2.shape[0])
    out = _hsd_loop(A, b, c, f, init,
                    max_iter=max_iter, eps=eps, step_factor=step_factor,
                    beta=beta, epsdiag=epsdiag, refine_tol=refine_tol,
                    gap_tol=gap_tol, feas_tol=feas_tol,
                    pause_mu=pause_mu, long_step=long_step,
                    max_refine=max_refine, trace=trace,
                    factor_dtype=factor_dtype, compensated=compensated,
                    corrector=corrector, ub=ub)
    status, x, y, w, z, iters = finish_state(out, max_iter)
    return status, x, y, w, z, iters, out
