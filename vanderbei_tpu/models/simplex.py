"""Dense revised simplex solvers (batched).

Two algorithms with the reference's exact pivot semantics:

- "pd": the parametric self-dual simplex (src/simpo/pd.c:69-464), the book's
  signature method: random perturbations xbar_B, ybar_N scaled by row/col
  norms (pd.c:179-201) define a homotopy in mu; each iteration finds the
  largest mu forcing a pivot and performs a dual- or primal-driven pivot with
  the perturbation-aware ratio test (y + mu*ybar)/dy (pd.c:530-554).
- "twophase": dual-simplex Phase I driving out negative basic primals, then
  primal-simplex Phase II (src/simpo/2phase.c:69-516).

Dense redesign of the linear algebra: the reference maintains a sparse
LU of the basis with eta-file (src/simpo/lueta.c) or Forrest/Tomlin bump
updates (src/simpo/lurefac.c) — scalar, pointer-chasing machinery.  Here the
basis inverse is kept EXPLICITLY as a dense m x m matrix updated by a rank-1
product-form pivot (one outer product), with periodic full refresh by a QR
inverse (ops/linalg.inv_qr) for numerical hygiene — the dense analogue of the
refactor() amortized-time heuristic (lueta.c:104-131).  btsolve/bsolve
become row-gather + matvec.  drand48 perturbations become jax.random keys
(deterministic per instance).

Everything is fixed-shape: basics/nonbasics are index vectors, ratio tests
are masked argmin reductions, and the whole solve is one jitted
lax.while_loop — vmap over instances gives the batched netlib sweep.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import SolverConfig
from ..core.status import Status
from ..ops.linalg import inv_qr

EPS1 = 1.0e-8       # pivot eligibility (pd.c:39)
EPS2 = 1.0e-12      # perturbation positivity floor (pd.c:40)
EPS3 = 1.0e-10      # mu optimality cutoff (pd.c:41)

SIMPLEX_BANNER = (
    "---------------------------------------------------------------------------\n"
    "          |   Primal      |        |\n"
    "  Iter    |  Obj Value    |   mu   |\n"
    "- - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - -")


def _trace_row(it, obj, mu):
    """Host printer for one pivot row (pd.c:417-418 format)."""
    print(f"{int(it):8d}   {float(obj):14.7e} {float(mu):9.2e}", flush=True)


class PdState(NamedTuple):
    Binv: jax.Array          # (m, m) explicit basis inverse
    basics: jax.Array        # (m,) int column ids in [0, N)
    nonbasics: jax.Array     # (n,) int column ids
    x_B: jax.Array           # (m,)
    xbar_B: jax.Array        # (m,)
    y_N: jax.Array           # (n,)
    ybar_N: jax.Array        # (n,)
    iter: jax.Array
    status: jax.Array


def _refresh_binv(Afull, basics):
    """Recompute Binv = B^-1 from scratch (the dense 'refactor')."""
    return inv_qr(jnp.take(Afull, basics, axis=1))


def _reduced_costs(Afull, Binv, basics, nonbasics, cvec):
    """z_N(cvec) = (cvec_B B^-1 A)_N - cvec_N at the current basis —
    what btsolve + Nt_times_y regenerate from a fresh LU in the reference
    (2phase.c:331-350)."""
    v = jnp.take(cvec, basics) @ Binv
    z_full = v @ Afull - cvec
    return jnp.take(z_full, nonbasics)


def _pivot_binv(Binv, dx_B, col_out):
    """Product-form update of B^-1 after basis column col_out is replaced
    by the entering column a_j (for which dx_B = B^-1 a_j)."""
    piv = dx_B[col_out]
    row = Binv[col_out, :] / piv
    Binv = Binv - jnp.outer(dx_B, row)
    return Binv.at[col_out, :].set(row)


def _masked_argmin(vals, mask):
    """Index of the smallest vals[i] with mask[i]; (-1, inf) if none."""
    big = jnp.asarray(jnp.inf, vals.dtype)
    masked = jnp.where(mask, vals, big)
    idx = jnp.argmin(masked)
    ok = jnp.any(mask)
    return jnp.where(ok, idx, -1), masked[idx]


def _dy_nonbasic(Afull, Binv, nonbasics, col_out):
    """dy_N = -((B^-1)_{col_out,:} A_full) gathered at nonbasic columns —
    the dense fusion of btsolve + Nt_times_y (pd.c:258-265)."""
    vrow = -Binv[col_out, :]
    y_full = vrow @ Afull
    return jnp.take(y_full, nonbasics)


def _chunked_loop(cond, body, state, refresh, refresh_every):
    """Run `body` pivots in refresh_every-sized chunks with ONE unconditional
    refactor per chunk.

    This replaces a per-pivot `lax.cond` refresh: under vmap a cond lowers
    to a select that would execute the O(m^3) refresh for every lane every
    pivot; chunking amortizes the dense 'refactor' exactly like the
    reference's amortized-time heuristic (lueta.c:104-131) while keeping
    batched execution efficient.  `body` is guarded so finished lanes
    no-op.

    `refresh` must be a TRUE refactor: besides recomputing B^-1 it
    re-derives every iterate vector (x_B, y_N, perturbations) from the
    basis and the original data.  The reference gets this for free — its
    bsolve/btsolve regenerate iterates through the fresh LU each iteration
    (lueta.c:618-698); with incremental product-form updates the iterates
    would otherwise drift over hundreds of pivots and fake an
    infeasible/unbounded verdict late in the run.
    """
    guarded = lambda s: jax.lax.cond(cond(s), body, lambda x: x, s)

    def chunk(s):
        s = jax.lax.fori_loop(0, refresh_every, lambda t, ss: guarded(ss), s)
        return jax.lax.cond(cond(s), refresh, lambda x: x, s)

    return jax.lax.while_loop(cond, chunk, state)


# ---------------------------------------------------------------------------
# parametric self-dual (pd.c)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("refresh_every", "trace"))
def _pd_loop(Afull, b, c, key, *, max_iter, refresh_every: int,
             trace: bool = False, init: PdState | None = None):
    m, N = Afull.shape
    n = N - m
    dtype = Afull.dtype
    if c.shape[0] < N:      # structural costs only: slack columns cost 0
        c = jnp.concatenate([c, jnp.zeros((N - c.shape[0],), dtype)])

    A0 = Afull[:, :n]
    # row/col 2-norms over the structural columns (pd.c:179-187)
    rscale = jnp.sqrt(jnp.sum(A0 * A0, axis=1))
    cscale = jnp.sqrt(jnp.sum(A0 * A0, axis=0))
    kx, ky = jax.random.split(key)
    xbar = jax.random.uniform(kx, (m,), dtype) + rscale
    ybar = jax.random.uniform(ky, (n,), dtype) + cscale

    # originating vectors of the homotopy iterates: x_B = B^-1 b,
    # xbar_B = B^-1 xbar0, y_N = z_N(c), ybar_N = z_N(cbar) hold at EVERY
    # basis (the incremental pivot updates preserve them) — they are what
    # the refactor recomputes exactly.  They are derived deterministically
    # from `key`, so a RESUMED launch (init != None, max_iter raised)
    # reconstructs the same homotopy and continues the identical run —
    # how solve_canon_pd splits a solve at TIMLIM deadline checks.
    xbar0 = xbar
    cbar = jnp.concatenate([-ybar, jnp.zeros((m,), dtype)])

    state = init if init is not None else PdState(
        Binv=jnp.eye(m, dtype=dtype),
        basics=jnp.arange(n, N, dtype=jnp.int32),
        nonbasics=jnp.arange(0, n, dtype=jnp.int32),
        x_B=b,
        xbar_B=xbar,
        y_N=-c[:n],
        ybar_N=ybar,
        iter=jnp.asarray(0),
        status=jnp.asarray(int(Status.RUNNING)),
    )

    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def cond(s: PdState):
        return (s.status == int(Status.RUNNING)) & (s.iter < max_iter)

    def body(s: PdState):
        if trace:
            obj = jnp.take(c, s.basics) @ s.x_B
            mu_t = jnp.maximum(
                jnp.max(jnp.where(s.ybar_N > EPS2,
                                  -s.y_N / s.ybar_N, neg_inf)),
                jnp.max(jnp.where(s.xbar_B > EPS2,
                                  -s.x_B / s.xbar_B, neg_inf)))
            jax.debug.callback(_trace_row, s.iter, obj, mu_t)

        # STEP 1: largest mu forcing a pivot (pd.c:224-247)
        cand_d = jnp.where(s.ybar_N > EPS2, -s.y_N / s.ybar_N, neg_inf)
        jd = jnp.argmax(cand_d)
        vd = cand_d[jd]
        cand_p = jnp.where(s.xbar_B > EPS2, -s.x_B / s.xbar_B, neg_inf)
        ip = jnp.argmax(cand_p)
        vp = cand_p[ip]
        mu = jnp.maximum(vd, vp)
        primal_driven = vp > vd      # strict, as in pd.c:237-241

        def finish_optimal(_):
            return s._replace(status=jnp.asarray(int(Status.OPTIMAL)),
                              iter=s.iter)

        def pivot(_):
            def leaving_known(_):
                # primal scan won: basis slot ip leaves; find the entrant by
                # the dual ratio test (pd.c:249-292)
                col_out = ip
                dy_N = _dy_nonbasic(Afull, s.Binv, s.nonbasics, col_out)
                ratios = (s.y_N + mu * s.ybar_N) / dy_N
                col_in, _ = _masked_argmin(ratios, dy_N > EPS1)
                fail = jnp.asarray(int(Status.PRIMAL_INFEASIBLE))
                return col_in, col_out, dy_N, fail

            def entering_known(_):
                # dual scan won: nonbasic slot jd enters; find the leaver by
                # the primal ratio test (pd.c:294-338)
                col_in = jd
                j_enter = s.nonbasics[col_in]
                dx_B = s.Binv @ Afull[:, j_enter]
                ratios = (s.x_B + mu * s.xbar_B) / dx_B
                col_out, _ = _masked_argmin(ratios, dx_B > EPS1)
                dy_N = jax.lax.cond(
                    col_out >= 0,
                    lambda _: _dy_nonbasic(Afull, s.Binv, s.nonbasics,
                                           jnp.maximum(col_out, 0)),
                    lambda _: jnp.zeros((n,), dtype),
                    operand=None)
                fail = jnp.asarray(int(Status.PRIMAL_UNBOUNDED))
                return col_in, col_out, dy_N, fail

            col_in, col_out, dy_N, fail = jax.lax.cond(
                primal_driven, leaving_known, entering_known, operand=None)

            def failed(_):
                return s._replace(status=fail)

            def do_pivot(_):
                j_enter = s.nonbasics[col_in]
                dx_B = s.Binv @ Afull[:, j_enter]

                t = s.x_B[col_out] / dx_B[col_out]
                tbar = s.xbar_B[col_out] / dx_B[col_out]
                sv = s.y_N[col_in] / dy_N[col_in]
                sbar = s.ybar_N[col_in] / dy_N[col_in]

                y_N = (s.y_N - sv * dy_N).at[col_in].set(sv)
                ybar_N = (s.ybar_N - sbar * dy_N).at[col_in].set(sbar)
                x_B = (s.x_B - t * dx_B).at[col_out].set(t)
                xbar_B = (s.xbar_B - tbar * dx_B).at[col_out].set(tbar)

                i_leave = s.basics[col_out]
                basics = s.basics.at[col_out].set(j_enter)
                nonbasics = s.nonbasics.at[col_in].set(i_leave)

                Binv = _pivot_binv(s.Binv, dx_B, col_out)
                return PdState(Binv, basics, nonbasics, x_B, xbar_B,
                               y_N, ybar_N, s.iter, s.status)

            return jax.lax.cond((col_in < 0) | (col_out < 0), failed,
                                do_pivot, operand=None)

        out = jax.lax.cond(mu <= EPS3, finish_optimal, pivot, operand=None)
        return out._replace(iter=s.iter + 1)

    def refresh(s: PdState):
        """True refactor: fresh B^-1 AND iterates re-derived from it."""
        Binv = _refresh_binv(Afull, s.basics)
        return s._replace(
            Binv=Binv,
            x_B=Binv @ b,
            xbar_B=Binv @ xbar0,
            y_N=_reduced_costs(Afull, Binv, s.basics, s.nonbasics, c),
            ybar_N=_reduced_costs(Afull, Binv, s.basics, s.nonbasics, cbar))

    out = _chunked_loop(cond, body, state, refresh, refresh_every)
    status = jnp.where(out.status == int(Status.RUNNING),
                       int(Status.ITERATION_LIMIT), out.status)

    # transcription (pd.c:431-445)
    x_full = jnp.zeros((N,), dtype).at[out.basics].set(out.x_B)
    y_full = jnp.zeros((N,), dtype).at[out.nonbasics].set(out.y_N)
    x = x_full[:n]
    z = y_full[:n]
    y = y_full[n:]
    w = x_full[n:]
    return status, x, y, w, z, out.iter, out


# ---------------------------------------------------------------------------
# two-phase (2phase.c)
# ---------------------------------------------------------------------------

class TpState(NamedTuple):
    Binv: jax.Array
    basics: jax.Array
    nonbasics: jax.Array
    x_B: jax.Array
    y_N: jax.Array
    iter: jax.Array
    status: jax.Array
    done: jax.Array          # phase finished (no more pivots available)


def _tp_pivot(Afull, s: TpState, col_in, col_out, dy_N, dx_B, refresh_every):
    """Shared pivot/update for both phases (2phase.c:266-316)."""
    t = s.x_B[col_out] / dx_B[col_out]
    sv = s.y_N[col_in] / dy_N[col_in]
    y_N = (s.y_N - sv * dy_N).at[col_in].set(sv)
    x_B = (s.x_B - t * dx_B).at[col_out].set(t)
    j_enter = s.nonbasics[col_in]
    i_leave = s.basics[col_out]
    basics = s.basics.at[col_out].set(j_enter)
    nonbasics = s.nonbasics.at[col_in].set(i_leave)
    Binv = _pivot_binv(s.Binv, dx_B, col_out)
    return TpState(Binv, basics, nonbasics, x_B, y_N, s.iter, s.status,
                   s.done)


@functools.partial(jax.jit,
                   static_argnames=("refresh_every", "trace"))
def _twophase_loop(Afull, b, c, key, *, max_iter, refresh_every: int,
                   trace: bool = False):
    m, N = Afull.shape
    n = N - m
    dtype = Afull.dtype
    if c.shape[0] < N:      # structural costs only: slack columns cost 0
        c = jnp.concatenate([c, jnp.zeros((N - c.shape[0],), dtype)])

    # dual-feasible start: y_N = max(c,1) + U(0,1)  (2phase.c:168-173)
    y0 = jnp.maximum(c[:n], 1.0) + jax.random.uniform(key, (n,), dtype)
    # Phase I runs with the implicit random objective ctilde whose reduced
    # costs at the slack basis equal y0; refactors re-derive y_N from it
    ctilde = jnp.concatenate([-y0, jnp.zeros((m,), dtype)])

    state = TpState(
        Binv=jnp.eye(m, dtype=dtype),
        basics=jnp.arange(n, N, dtype=jnp.int32),
        nonbasics=jnp.arange(0, n, dtype=jnp.int32),
        x_B=b,
        y_N=y0,
        iter=jnp.asarray(0),
        status=jnp.asarray(int(Status.RUNNING)),
        done=jnp.asarray(False),
    )

    def cond(s: TpState):
        return ((s.status == int(Status.RUNNING)) & (~s.done)
                & (s.iter < max_iter))

    def phase1_body(s: TpState):
        if trace:
            jax.debug.callback(_trace_row, s.iter,
                               jnp.take(c, s.basics) @ s.x_B, jnp.nan)

        # STEP 1: most negative basic primal (pick_neg, 2phase.c:616-629)
        col_out = jnp.argmin(s.x_B)
        no_neg = s.x_B[col_out] >= -EPS2

        def stop(_):
            return s._replace(done=jnp.asarray(True))

        def pivot(_):
            dy_N = _dy_nonbasic(Afull, s.Binv, s.nonbasics, col_out)
            ratios = s.y_N / dy_N
            col_in, _ = _masked_argmin(ratios, dy_N > EPS1)

            def infeasible(_):
                return s._replace(
                    status=jnp.asarray(int(Status.PRIMAL_INFEASIBLE)))

            def do(_):
                j_enter = s.nonbasics[col_in]
                dx_B = s.Binv @ Afull[:, j_enter]
                return _tp_pivot(Afull, s, col_in, col_out, dy_N, dx_B,
                                 refresh_every)

            return jax.lax.cond(col_in < 0, infeasible, do, operand=None)

        out = jax.lax.cond(no_neg, stop, pivot, operand=None)
        return out._replace(iter=s.iter + 1)

    def refresh_with(cvec):
        def refresh(s: TpState):
            Binv = _refresh_binv(Afull, s.basics)
            return s._replace(
                Binv=Binv,
                x_B=Binv @ b,
                y_N=_reduced_costs(Afull, Binv, s.basics, s.nonbasics,
                                   cvec))
        return refresh

    s1 = _chunked_loop(cond, phase1_body, state, refresh_with(ctilde),
                       refresh_every)

    # objective restoration (2phase.c:331-350):
    # y_N = ((c_B B^-1) A_full)[nonbasics] - c_N
    def to_phase2(s: TpState):
        y_N = _reduced_costs(Afull, s.Binv, s.basics, s.nonbasics, c)
        return s._replace(y_N=y_N, done=jnp.asarray(False))

    s1 = jax.lax.cond(
        s1.status == int(Status.RUNNING),
        to_phase2, lambda s: s, s1)

    def phase2_body(s: TpState):
        if trace:
            jax.debug.callback(_trace_row, s.iter,
                               jnp.take(c, s.basics) @ s.x_B, jnp.nan)

        # STEP 1: most negative nonbasic dual (2phase.c:370)
        col_in = jnp.argmin(s.y_N)
        no_neg = s.y_N[col_in] >= -EPS2

        def stop(_):
            return s._replace(done=jnp.asarray(True),
                              status=jnp.asarray(int(Status.OPTIMAL)))

        def pivot(_):
            j_enter = s.nonbasics[col_in]
            dx_B = s.Binv @ Afull[:, j_enter]
            ratios = s.x_B / dx_B
            col_out, _ = _masked_argmin(ratios, dx_B > EPS1)

            def unbounded(_):
                return s._replace(
                    status=jnp.asarray(int(Status.PRIMAL_UNBOUNDED)))

            def do(_):
                dy_N = _dy_nonbasic(Afull, s.Binv, s.nonbasics,
                                    jnp.maximum(col_out, 0))
                return _tp_pivot(Afull, s, col_in, col_out, dy_N, dx_B,
                                 refresh_every)

            return jax.lax.cond(col_out < 0, unbounded, do, operand=None)

        out = jax.lax.cond(no_neg, stop, pivot, operand=None)
        return out._replace(iter=s.iter + 1)

    s2 = _chunked_loop(cond, phase2_body, s1, refresh_with(c),
                       refresh_every)

    status = jnp.where(s2.status == int(Status.RUNNING),
                       int(Status.ITERATION_LIMIT), s2.status)
    x_full = jnp.zeros((N,), dtype).at[s2.basics].set(s2.x_B)
    y_full = jnp.zeros((N,), dtype).at[s2.nonbasics].set(s2.y_N)
    return status, x_full[:n], y_full[n:], x_full[n:], y_full[:n], s2.iter


# ---------------------------------------------------------------------------
# canonical-form entry points
# ---------------------------------------------------------------------------

def _prepare(canon, cfg: SolverConfig):
    import numpy as np
    from ..ops.assemble import device_dense
    A = device_dense(np.asarray(canon.A, cfg.dtype))
    m = A.shape[0]
    Afull = jnp.concatenate([A, jnp.eye(m, dtype=cfg.dtype)], axis=1)
    b = jnp.asarray(canon.b, cfg.dtype)
    c = jnp.concatenate([jnp.asarray(canon.c, cfg.dtype),
                         jnp.zeros((m,), cfg.dtype)])
    key = jax.random.PRNGKey(cfg.seed)
    return Afull, b, c, key


# pivots per launch while a TIMLIM deadline is set: the host checks the
# deadline between launches
DEADLINE_CHUNK_PIVOTS = 2_000


def solve_canon_pd(canon, cfg: SolverConfig):
    import numpy as np
    import time as _time
    Afull, b, c, key = _prepare(canon, cfg)
    max_iter = cfg.max_iter or cfg.simplex_max_iter
    trace = cfg.verbose >= 2
    if trace:
        print(SIMPLEX_BANNER, flush=True)
    deadline = (None if not np.isfinite(cfg.time_limit)
                else _time.monotonic() + cfg.time_limit)
    chunk = max_iter if deadline is None else DEADLINE_CHUNK_PIVOTS
    state = None
    total = 0
    while total < max_iter:
        total = min(max_iter, total + chunk)
        st, x, y, w, z, iters, state = _pd_loop(
            Afull, b, c[: Afull.shape[1]], key,
            max_iter=total, refresh_every=cfg.refresh_every,
            trace=trace, init=state)
        if int(np.asarray(st)) != int(Status.ITERATION_LIMIT):
            break
        if deadline is not None and _time.monotonic() > deadline:
            break
    return st, x, y, w, z, iters


def solve_canon_twophase(canon, cfg: SolverConfig):
    Afull, b, c, key = _prepare(canon, cfg)
    max_iter = cfg.max_iter or cfg.simplex_max_iter
    trace = cfg.verbose >= 2
    if trace:
        print(SIMPLEX_BANNER, flush=True)
    return _twophase_loop(Afull, b, c[: Afull.shape[1]], key,
                          max_iter=max_iter, refresh_every=cfg.refresh_every,
                          trace=trace)
