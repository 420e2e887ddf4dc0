"""Path-following primal-dual interior-point method.

Semantics of the reference's ipo METHOD=intpt solver (src/ipo/intpt.c:33-261):
max c'x s.t. Ax + w = b, x,w,y,z > 0; fixed centering delta=0.02, step factor
0.9, divergence-based infeasibility detection, EPS=1e-6, MAX_ITER=200.

Design: a single jitted `lax.while_loop` over a state pytree; the KKT
solve is the dense normal-equations Cholesky in ops/kkt.py; ratio tests are
masked reductions.  Works unchanged under vmap for instance batching and
under shard_map for mesh execution.

Like models/hsd.py, every numeric knob is a traced scalar (one compiled
program per shape/dtype/factor path), and the solve can pause at a traced
duality-gap threshold and resume from a carried state — the mechanism
behind both the two-stage f32->f64 precision ladder and the
warm-start/checkpoint API.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.status import Status
from ..ops.kkt import kkt_factor, kkt_solve

DEFAULT_MAX_ITER = 200      # intpt.c:31

INTPT_BANNER = (
    "------------------------------------------------------------------\n"
    "         |           Primal          |            Dual           |\n"
    "  Iter   |  Obj Value       Infeas   |  Obj Value       Infeas   |\n"
    "- - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - ")


def _trace_row(it, pobj, normr, dobj, norms):
    """Host-side printer for one iteration row (intpt.c:163-164 format)."""
    print(f"{int(it):8d}   {float(pobj):14.7e}  {float(normr):8.1e}    "
          f"{float(dobj):14.7e}  {float(norms):8.1e} ", flush=True)


class IntptState(NamedTuple):
    x: jax.Array
    z: jax.Array
    y: jax.Array
    w: jax.Array
    iter: jax.Array
    status: jax.Array
    normr0: jax.Array
    norms0: jax.Array
    # sticky KKT Tikhonov level (see models/hsd.HsdState.reg)
    reg: jax.Array = None


def init_state(A) -> IntptState:
    """1000-start (intpt.c:98-106)."""
    m, n = A.shape
    dtype = A.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    return IntptState(
        jnp.full((n,), 1000.0, dtype), jnp.full((n,), 1000.0, dtype),
        jnp.full((m,), 1000.0, dtype), jnp.full((m,), 1000.0, dtype),
        jnp.asarray(0), jnp.asarray(int(Status.RUNNING)), inf, inf,
        jnp.zeros((), dtype))


def cast_state(state: IntptState, dtype) -> IntptState:
    return IntptState(
        *(leaf.astype(dtype) for leaf in state[:4]),
        state.iter, state.status,
        state.normr0.astype(dtype), state.norms0.astype(dtype),
        jnp.zeros((), dtype))


def _ratio_step(x, dx, z, dz, y, dy, w, dw, r):
    """theta = min(r / max_i(-d/v), 1) over all four vectors (intpt.c:211-220)."""
    t = jnp.maximum(jnp.max(-dx / x), jnp.max(-dz / z))
    t = jnp.maximum(t, jnp.max(-dy / y))
    t = jnp.maximum(t, jnp.max(-dw / w))
    return jnp.where(t > 0.0, jnp.minimum(r / t, 1.0), 1.0)


@functools.partial(
    jax.jit,
    static_argnames=("max_refine", "trace", "factor_dtype", "has_q"),
)
def _intpt_loop(A, b, c, f, Q, init: IntptState, *,
                max_iter, eps, delta, step_factor, epsdiag, refine_tol,
                pause_gap, div_detect, gap_floor=1.0,
                max_refine: int = 8,
                trace: bool = False,
                factor_dtype=None,
                has_q: bool = False):
    """Jitted while_loop driver; returns the final state (see hsd._hsd_loop
    for the pause/resume contract)."""
    m, n = A.shape
    dtype = A.dtype
    eps = jnp.asarray(eps, dtype)
    delta = jnp.asarray(delta, dtype)
    step_factor = jnp.asarray(step_factor, dtype)
    epsdiag = jnp.asarray(epsdiag, dtype)
    refine_tol = jnp.asarray(refine_tol, dtype)
    pause_gap = jnp.asarray(pause_gap, dtype)
    gap_floor = jnp.asarray(gap_floor, dtype)
    div_detect = jnp.asarray(div_detect, bool)
    f = jnp.asarray(f, dtype)
    Qq = Q if has_q else None

    def cond(s: IntptState):
        gap = s.z @ s.x + s.y @ s.w
        return ((s.status == int(Status.RUNNING)) & (s.iter < max_iter)
                & (gap > pause_gap))

    def body(s: IntptState):
        x, z, y, w = s.x, s.z, s.y, s.w

        rho = b - A @ x - w                  # primal infeasibility
        normr = jnp.sqrt(rho @ rho)
        sigma = c - A.T @ y + z              # dual infeasibility
        if has_q:
            sigma = sigma - Qq @ x           # QP stationarity: c-Qx-A'y+z
        norms = jnp.sqrt(sigma @ sigma)
        gamma = z @ x + y @ w                # duality gap

        if trace:
            pobj = c @ x + f
            if has_q:
                pobj = pobj - 0.5 * (x @ (Qq @ x))
            jax.debug.callback(_trace_row, s.iter, pobj, normr,
                               b @ y + f, norms)

        # the reference tests ABSOLUTE residuals/gap (intpt.c:152-158),
        # which under-converges problems whose data/objective are far from
        # unit scale (and the b/c normalization in canonicalize puts
        # everything in near-unit scale deliberately).  Test residuals
        # relative to ||b||,||c|| and the gap relative to the objective
        # magnitude, floored so zero-objective problems still terminate.
        pobj_mag = jnp.abs(c @ x)
        optimal = ((normr < eps * (1.0 + jnp.sqrt(b @ b)))
                   & (norms < eps * (1.0 + jnp.sqrt(c @ c)))
                   & (gamma <= eps * jnp.maximum(gap_floor, pobj_mag)))
        # divergence-based detection the reference itself marks "(unreliable)"
        # (intpt.c:175-182); gated here by the residual still being above
        # tolerance so sub-eps jitter can't trigger a false certificate
        # div_detect gates the heuristic off entirely in the f32 sprint
        # stage, where late-stage roundoff jitter can fake a 10x jump
        p_infeas = (normr > 10.0 * s.normr0) & (normr > eps) & div_detect
        d_infeas = (norms > 10.0 * s.norms0) & (norms > eps) & div_detect
        new_status = jnp.where(
            optimal, int(Status.OPTIMAL),
            jnp.where(p_infeas, int(Status.PRIMAL_INFEASIBLE),
                      jnp.where(d_infeas, int(Status.DUAL_INFEASIBLE),
                                int(Status.RUNNING))))

        def step(_):
            mu = delta * gamma / (n + m)
            D = z / x
            E = w / y
            L = kkt_factor(A, E, D, epsdiag, Q=Qq,
                           factor_dtype=factor_dtype, reg0=s.reg)
            rhs_x = sigma - z + mu / x
            rhs_y = rho + w - mu / y
            dy, dx = kkt_solve(A, E, D, L, rhs_y, rhs_x, Q=Qq,
                               epsdiag=epsdiag, refine_tol=refine_tol,
                               max_refine=max_refine)
            dz = mu / x - z - D * dx
            dw = mu / y - w - E * dy
            theta = _ratio_step(x, dx, z, dz, y, dy, w, dw, step_factor)
            return (x + theta * dx, z + theta * dz,
                    y + theta * dy, w + theta * dw,
                    L.reg.astype(dtype))

        keep = new_status != int(Status.RUNNING)
        x2, z2, y2, w2, reg2 = jax.lax.cond(
            keep, lambda _: (x, z, y, w, s.reg), step, operand=None)

        # numerical-failure guard (see models/hsd.py): keep the last
        # finite iterate rather than propagating NaN into the verdict
        ok = (jnp.all(jnp.isfinite(x2)) & jnp.all(jnp.isfinite(z2))
              & jnp.all(jnp.isfinite(y2)) & jnp.all(jnp.isfinite(w2)))

        def pick(new, old):
            return jnp.where(ok, new, old)

        return IntptState(pick(x2, x), pick(z2, z), pick(y2, y),
                          pick(w2, w), s.iter + 1,
                          jnp.where(ok, new_status,
                                    int(Status.SUBOPTIMAL)),
                          normr, norms, reg2)

    return jax.lax.while_loop(cond, body, init)


def finish_state(state: IntptState, max_iter):
    status = jnp.where(
        (state.status == int(Status.RUNNING)) & (state.iter >= max_iter),
        int(Status.ITERATION_LIMIT), state.status)
    return status, state.x, state.y, state.w, state.z, state.iter


def solve_canon(A, b, c, f, *,
                Q=None,
                max_iter: int = DEFAULT_MAX_ITER,
                eps: float = 1.0e-6,
                delta: float = 0.02,
                step_factor: float = 0.9,
                epsdiag: float = 1.0e-14,
                refine_tol: float = 1.0e-10,
                max_refine: int = 8,
                trace: bool = False,
                factor_dtype=None,
                pause_gap: float = 0.0,
                div_detect: bool = True,
                gap_floor: float = 1.0,
                init: IntptState | None = None):
    """Solve max c'x - x'Qx/2, Ax <= b, x >= 0 (dense canonical).

    Q=None is the pure LP the reference's shipped solvers handle; a PSD Q
    is the QUADS quadratic extension — the reference parses and stores it
    (iolp.c:583-645, lp.h Q fields) and its KKT engine reserves the block
    for it (ldlt.c:253-257), but no shipped solver passes it through; here
    the same Newton system [[-E, A], [A', D+Q]] solves the QP directly.

    Returns (status, x, y, w, z, iterations, state).
    """
    if isinstance(factor_dtype, str):
        factor_dtype = {"f32": jnp.float32, "f64": None,
                        "none": None}[factor_dtype]
    if init is None:
        init = init_state(A)
    has_q = Q is not None
    Qarg = Q if has_q else jnp.zeros((), A.dtype)
    out = _intpt_loop(A, b, c, f, Qarg, init,
                      max_iter=max_iter, eps=eps, delta=delta,
                      step_factor=step_factor, epsdiag=epsdiag,
                      refine_tol=refine_tol, pause_gap=pause_gap,
                      div_detect=div_detect, gap_floor=gap_floor,
                      max_refine=max_refine, trace=trace,
                      factor_dtype=factor_dtype, has_q=has_q)
    status, x, y, w, z, iters = finish_state(out, max_iter)
    return status, x, y, w, z, iters, out
