"""Solver registry and top-level solve().

The reference selects its algorithm at LINK TIME (one solver() per binary,
simpo/makefile:65-67, ipo/makefile:56-58).  Here a runtime registry maps
method names to jitted canonical-form solvers:

    intpt   — path-following primal-dual IPM     (src/ipo/intpt.c)
    hsd     — homogeneous self-dual (default)    (src/ipo/hsd.c)
    hsdls   — HSD long-step                      (src/ipo/hsdls.c)
    pd      — parametric self-dual simplex       (src/simpo/pd.c)
    twophase— two-phase simplex                  (src/simpo/2phase.c)

Precision ladder (cfg.precision == "mixed", chosen by "auto" for large
problems): the IPM solvers run stage 1 entirely in f32 — data, factor,
refinement — until mu (or the duality gap) crosses the stage boundary,
then stage 2 resumes the SAME state in f64 to the reference tolerance.
The pause/resume state is also the warm-start/checkpoint surface
(utils/checkpoint.py).

Shape policy: canonical dims are padded to size classes (powers of two,
floor 256) by default so every problem of a class shares one compiled
executable — compiling a solver loop is the slowest part of a cold solve.
The granularity has not been weighed against padding FLOPs on the GPU.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from ..core.canonicalize import (canonicalize, pad_canon, recover_solution,
                                 CanonLP)
from ..core.config import SolverConfig
from ..core.lp import LP, Solution
from ..core.status import Status
from . import intpt as _intpt
from . import hsd as _hsd
from . import simplex as _simplex


def size_class(dim: int, floor: int = 256) -> int:
    """Padded size class for dim: powers of two up to 2048 (few compiled
    programs for the corpus's many small problems), then multiples of 512
    (big problems are one-per-class anyway, so coarser rounding would buy
    no compile sharing — only padding waste: 2263 rows padded to 4096
    would cost 1.8x the factor FLOPs; to 2560 it costs 1.13x)."""
    if dim > 2048:
        return ((dim + 511) // 512) * 512
    c = floor
    while c < dim:
        c *= 2
    return c


def _check_finite(state) -> bool:
    x = np.asarray(state.x)
    return bool(np.all(np.isfinite(x))) and bool(np.isfinite(np.asarray(state.phi) if hasattr(state, "phi") else 0.0))


# iterations per launch while a TIMLIM deadline is set: the host checks
# the deadline between launches
DEADLINE_CHUNK = 25


def _deadline_iter_budget(cfg: SolverConfig, max_iter: int):
    """(launch budgets, deadline) honoring cfg.time_limit (TIMLIM header).

    max_iter is a traced scalar to the loops, so splitting costs no
    recompiles.  Without a deadline the whole budget is one launch; with
    one, launches of DEADLINE_CHUNK iterations let the host stop between
    them.
    """
    if not np.isfinite(cfg.time_limit):
        return [max_iter], None
    chunk = max(1, min(DEADLINE_CHUNK, max_iter))
    return ([chunk] * ((max_iter + chunk - 1) // chunk),
            time.monotonic() + cfg.time_limit)


def resolve_precision(cfg: SolverConfig, shape) -> str:
    """"auto" -> "mixed" only where the f32 sprint pays (big factored dim);
    small problems run f64 direct with reference-parity iteration paths."""
    if cfg.precision != "auto":
        return cfg.precision
    return "mixed" if min(shape) >= cfg.mixed_min_dim else "f64"


def _run_staged(solver_mod, run_stage, cfg: SolverConfig, max_iter: int,
                mk_args32, mk_args64, stage_knob: float, shape,
                init_for=None):
    """Shared two-stage driver for the IPM solvers.

    run_stage(args, init, max_iter, pause, factor_dtype) -> state.
    init_for(args) builds a fresh initial state (defaults to
    solver_mod.init_state on args[0]).  Returns the final f64 state.
    """
    if init_for is None:
        init_for = lambda args: solver_mod.init_state(args[0])
    precision = resolve_precision(cfg, shape)
    chunks, deadline = _deadline_iter_budget(cfg, max_iter)

    def run_to_end(args, state, factor_dtype):
        for budget in chunks:
            state = run_stage(args, state, budget, 0.0, factor_dtype)
            st = int(np.asarray(state.status))
            if (st != int(Status.RUNNING)
                    or int(np.asarray(state.iter)) >= max_iter):
                break
            if deadline is not None and time.monotonic() > deadline:
                break
        return state

    state = None
    warm = False
    if precision == "mixed":
        args32 = mk_args32()
        state = init_for(args32)
        done = 0
        for budget in chunks:
            state = run_stage(args32, state, budget, stage_knob, None)
            st = int(np.asarray(state.status))
            it = int(np.asarray(state.iter))
            if st != int(Status.RUNNING) or it >= max_iter:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            # pause detection WITHOUT fetching the state vectors: the
            # device loop exits early (iter < chunk budget) only when
            # mu <= pause_mu — the stage boundary
            if it < done + budget:
                break
            done = it
        if (not _check_finite(state)
                or int(np.asarray(state.status)) == int(Status.SUBOPTIMAL)):
            # f32 diverged (the device-side finiteness guard stops the
            # sprint SUBOPTIMAL at the last finite iterate): restart
            # clean in f64 rather than polishing a wandered point
            state = None
        else:
            state = solver_mod.cast_state(state, jnp.float64)
            warm = True

    args64 = mk_args64()
    if state is None:
        state = init_for(args64)
    # the XL dim-triggered f32-factor override applies only to the
    # auto/mixed ladder: an EXPLICIT f64/dd request means full f64
    # (advisor r3: silently capping a requested-f64 factor at f32
    # accuracy can stall refinement with no signal)
    factor_dtype = (jnp.float32
                    if (precision == "f32factor"
                        or (cfg.precision in ("auto", "mixed")
                            and (min(shape) >= cfg.xl_f32factor_dim
                                 or shape[0] * shape[1]
                                 >= cfg.xl_f32factor_elems)))
                    else None)
    state = run_to_end(args64, state, factor_dtype)

    # a warm-started polish that exhausts the budget gets one clean f64
    # retry: the f32 sprint can wander on degenerate problems, and the
    # reference's iteration-limit outcomes should reflect f64 behavior
    if (warm and int(np.asarray(state.status)) == int(Status.RUNNING)
            and int(np.asarray(state.iter)) >= max_iter
            and (deadline is None or time.monotonic() < deadline)):
        state = run_to_end(args64, init_for(args64), factor_dtype)
    return state


def _solve_intpt(canon: CanonLP, cfg: SolverConfig):
    max_iter = cfg.max_iter or _intpt.DEFAULT_MAX_ITER
    trace = cfg.verbose >= 2
    if trace:
        print(_intpt.INTPT_BANNER, flush=True)
    has_q = canon.Q is not None
    # ship A once (ops/assemble) and derive the f32 stage by a device-side
    # cast rather than a second host-to-device copy
    from ..ops.assemble import device_dense
    A_dev = device_dense(canon.A, dtype=canon.A.dtype)

    def mk(dtype):
        A = A_dev if A_dev.dtype == dtype else jnp.asarray(A_dev, dtype)
        Q = jnp.asarray(canon.Q, dtype) if has_q else None
        return (A, jnp.asarray(canon.b, dtype), jnp.asarray(canon.c, dtype),
                Q)

    def run_stage(args, init, budget, pause, factor_dtype):
        A, b, c, Q = args
        total = min(max_iter, int(np.asarray(init.iter)) + budget)
        # the f32 sprint stage can't hit f64 refinement targets; relax
        # them there (traced scalars — no recompile)
        sprint = pause > 0.0
        return _intpt.solve_canon(
            A, b, c, canon.f, Q=Q, max_iter=total, eps=cfg.ipm_eps,
            delta=cfg.delta, step_factor=cfg.step_factor,
            epsdiag=max(cfg.epsdiag, 1e-8) if sprint else cfg.epsdiag,
            refine_tol=max(cfg.refine_tol, 1e-4) if sprint else cfg.refine_tol,
            max_refine=cfg.max_refine, trace=trace,
            factor_dtype=factor_dtype, pause_gap=pause,
            div_detect=(not sprint) and cfg.div_detect,
            # gap-stop floor: under geometric+norm equilibration the
            # scaled objective sits near unit scale (often below 1), so
            # floor at 1e-2 to keep the stop at least as sharp as the
            # reference's absolute gamma < eps (intpt.c:152-158); in
            # scale='none' parity mode floor at 1.0 — there the 1e-2
            # floor was 100x STRICTER than the reference for
            # near-zero-objective problems (advisor r3)
            gap_floor=1.0e-2 if cfg.scale != "none" else 1.0,
            init=init)[-1]

    # intpt's stage boundary is on the duality gap (its own stop is
    # absolute eps on residuals+gap, intpt.c:30); stage1_mu * (n+m) keeps
    # the boundary proportional to the mu the gap corresponds to
    knob = cfg.stage1_mu * sum(canon.A.shape)
    state = _run_staged(_intpt, run_stage, cfg, max_iter,
                        lambda: mk(jnp.float32), lambda: mk(jnp.float64),
                        knob, canon.A.shape)
    return _intpt.finish_state(state, max_iter)


def _hsd_structure_applies(canon: CanonLP) -> bool:
    k = len(canon.ub_cols)
    if not (k > 0 and canon.Q is None and (canon.m - k) <= canon.n):
        return False
    # a split free variable (free_vars='split') with a finite upper bound
    # mirrors -1 into its ub row (canonicalize step 6), so that tail row is
    # NOT a singleton; UbTail would silently drop the mirror entry and
    # enforce x+ <= u instead of x+ - x- <= u — fall back to dense there
    if canon.free_cols is not None and len(canon.free_cols):
        if np.intersect1d(canon.free_cols, canon.ub_cols).size:
            return False
    return True


def _hsd_structured_operands(canon: CanonLP, M1: int | None = None,
                             K: int | None = None, N: int | None = None):
    """Split the canonical rows into [general head | singleton ub tail],
    each padded to its own size class, for the Schur-eliminated KKT path
    (ops/kkt.UbTail).  Returns None when the structure doesn't apply.

    This is the dense counterpart of the reference's sparse LDL'
    absorbing singleton bound rows for free (solve.c:152-174 rows +
    ldlt.c orderings): instead of sparse fill machinery, the tail block —
    diagonal in the normal equations — is eliminated analytically, so
    only the m1 x m1 head is ever factored and the tail rows are never
    materialized on device (KEN-11: 14.7k-row factor instead of 51k).

    M1/K/N override the padded targets (batched size classes); default is
    the per-problem power-of-two size class.
    """
    if not _hsd_structure_applies(canon):
        return None
    k = len(canon.ub_cols)
    m1 = canon.m - k
    n = canon.n
    M1 = M1 if M1 is not None else size_class(m1)
    K = K if K is not None else size_class(k)
    N = N if N is not None else size_class(n)
    A1 = np.zeros((M1, N), dtype=canon.A.dtype)
    A1[:m1, :n] = canon.A[:m1, :n]
    b = np.ones(M1 + K, dtype=canon.A.dtype)
    b[:m1] = canon.b[:m1]
    b[M1:M1 + k] = canon.b[m1:m1 + k]
    c = np.zeros(N, dtype=canon.A.dtype)
    c[:n] = canon.c[:n]
    idx2 = np.zeros(K, dtype=np.int32)
    idx2[:k] = canon.ub_cols
    w2 = np.zeros(K, dtype=canon.A.dtype)
    w2[:k] = canon.A[np.arange(m1, m1 + k), canon.ub_cols]
    return dict(A1=A1, b=b, c=c, idx2=idx2, w2=w2, m1=m1, k=k, M1=M1, K=K)


def _place_tp(args, mesh):
    """Shard one LP's operands over the mesh's "model" axis (tensor
    parallelism for a single large problem).

    A's COLUMNS shard (each device holds A[:, shard] — the per-device
    partial syrk + psum decomposition of the normal equations,
    parallel/distributed.py); the n-vector c shards to match; row-space
    operands replicate.  The SAME jitted HSD loop then runs under GSPMD —
    XLA inserts the psum/all-gather collectives — so the distributed
    product path shares every line of solver code with the local one
    (this fills the scaling-in-(m,n) role of the reference's sparse LDL',
    ldlt.c, whose whole purpose was large single problems).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    A, b, c, ub = args
    A = jax.device_put(A, NamedSharding(mesh, P(None, "model")))
    b = jax.device_put(b, NamedSharding(mesh, P(None)))
    c = jax.device_put(c, NamedSharding(mesh, P("model")))
    if ub is not None:
        from ..ops.kkt import UbTail
        ub = UbTail(jax.device_put(ub.idx2, NamedSharding(mesh, P(None))),
                    jax.device_put(ub.w2, NamedSharding(mesh, P(None))))
    return A, b, c, ub


def _solve_hsd(canon: CanonLP, cfg: SolverConfig, long_step=False,
               mesh=None):
    max_iter = cfg.max_iter or (
        _hsd.DEFAULT_MAX_ITER_LS if long_step else _hsd.DEFAULT_MAX_ITER)
    trace = cfg.verbose >= 2
    if trace:
        print(_hsd.HSD_BANNER, flush=True)

    struct = (_hsd_structured_operands(canon)
              if cfg.use_ub_structure else None)

    # ship the head operand once and cast device-side for the f32 stage
    # (ops/assemble)
    from ..ops.assemble import device_dense
    if struct is None:
        A_dev = device_dense(canon.A, dtype=canon.A.dtype)

        def mk(dtype):
            A = (A_dev if A_dev.dtype == dtype
                 else jnp.asarray(A_dev, dtype))
            args = (A, jnp.asarray(canon.b, dtype),
                    jnp.asarray(canon.c, dtype), None)
            return _place_tp(args, mesh) if mesh is not None else args
        shape = canon.A.shape
    else:
        A1_dev = device_dense(struct["A1"], dtype=struct["A1"].dtype)

        def mk(dtype):
            from ..ops.kkt import UbTail
            A1 = (A1_dev if A1_dev.dtype == dtype
                  else jnp.asarray(A1_dev, dtype))
            args = (A1, jnp.asarray(struct["b"], dtype),
                    jnp.asarray(struct["c"], dtype),
                    UbTail(jnp.asarray(struct["idx2"]),
                           jnp.asarray(struct["w2"], dtype)))
            return _place_tp(args, mesh) if mesh is not None else args
        shape = (struct["M1"], struct["A1"].shape[1])

    def run_stage(args, init, budget, pause, factor_dtype):
        A, b, c, ub = args
        total = min(max_iter, int(np.asarray(init.iter)) + budget)
        sprint = pause > 0.0
        return _hsd.solve_canon(
            A, b, c, canon.f, max_iter=total, eps=cfg.hsd_eps,
            step_factor=cfg.hsd_step_factor, long_step=long_step,
            beta=cfg.beta, gap_tol=cfg.epssol, feas_tol=cfg.epssol,
            epsdiag=max(cfg.epsdiag, 1e-8) if sprint else cfg.epsdiag,
            refine_tol=max(cfg.refine_tol, 1e-4) if sprint else cfg.refine_tol,
            max_refine=cfg.max_refine, trace=trace,
            factor_dtype=factor_dtype, pause_mu=pause,
            compensated=(cfg.precision == "dd" and not sprint),
            corrector=cfg.hsd_corrector, ub=ub, init=init)[-1]

    def init_for(args):
        ub = args[3]
        return _hsd.init_state(
            args[0], extra_rows=0 if ub is None else ub.idx2.shape[0])

    state = _run_staged(_hsd, run_stage, cfg, max_iter,
                        lambda: mk(jnp.float32), lambda: mk(jnp.float64),
                        cfg.stage1_mu, shape, init_for=init_for)
    status, x, y, w, z, iters = _hsd.finish_state(state, max_iter)
    if struct is not None:
        # reassemble canonical row order [head m1 | ub tail k] from the
        # padded [M1 | K] layout
        m1, k, M1 = struct["m1"], struct["k"], struct["M1"]
        y = jnp.concatenate([y[:m1], y[M1:M1 + k]])
        w = jnp.concatenate([w[:m1], w[M1:M1 + k]])
    return status, x, y, w, z, iters


def _solve_pd(canon: CanonLP, cfg: SolverConfig):
    return _simplex.solve_canon_pd(canon, cfg)


def _solve_twophase(canon: CanonLP, cfg: SolverConfig):
    return _simplex.solve_canon_twophase(canon, cfg)


SOLVERS = {
    "intpt": _solve_intpt,
    "hsd": _solve_hsd,
    "hsdls": lambda canon, cfg, **kw: _solve_hsd(canon, cfg,
                                                 long_step=True, **kw),
    "pd": _solve_pd,
    "twophase": _solve_twophase,
}


def get_solver(method: str):
    try:
        return SOLVERS[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; available: {sorted(SOLVERS)}")


def solve(lp: LP, method: str = "hsd", config: SolverConfig | None = None,
          pad_to: int | str = "auto", mesh=None) -> Solution:
    """Canonicalize and solve an LP; the analogue of solvelp (solve.c:28).

    pad_to: "auto" (default) pads canonical dims to power-of-two size
    classes so problems share compiled executables; an int pads to that
    multiple (1 = exact dims).

    mesh: a jax.sharding.Mesh with a "model" axis — solves this ONE
    problem tensor-parallel (A column-sharded, GSPMD collectives; hsd
    family only).
    """
    cfg = config or SolverConfig()
    cfg = cfg.with_(method=method).apply_lp_params(lp)
    if lp.qnz and method != "intpt":
        # the reference's shipped solvers silently ignore Q (its ldltfac
        # builds a private zero-Q LP, ldlt.c:140-144); we instead route
        # quadratic objectives to the QP-capable path-following solver
        if cfg.verbose:
            print(f"QUADS present: routing method {method!r} -> 'intpt' "
                  "(QP-capable)", flush=True)
        method = "intpt"
    canon = canonicalize(lp, pad_to=1, dtype=cfg.dtype,
                         free_vars=cfg.free_vars, scale=cfg.scale)
    if canon.status != int(Status.RUNNING):
        n, m0 = lp.n, lp.m
        return Solution(status=canon.status, x=np.zeros(n), y=np.zeros(m0),
                        w=np.zeros(m0), z=np.zeros(n), primal_obj=0.0,
                        dual_obj=0.0)
    structured = (method in ("hsd", "hsdls") and cfg.use_ub_structure
                  and _hsd_structure_applies(canon))
    if pad_to == "auto" and not structured:
        # the structured (UbTail) path assembles its own head/tail-class
        # padding inside _solve_hsd; padding here would waste host memory
        canon = pad_canon(canon, size_class(canon.m), size_class(canon.n))
    elif isinstance(pad_to, int) and pad_to != 1:
        canon = pad_canon(canon,
                          -(-canon.m // pad_to) * pad_to,
                          -(-canon.n // pad_to) * pad_to)
    t0 = time.perf_counter()
    if mesh is not None and method not in ("hsd", "hsdls"):
        raise ValueError(
            f"mesh (tensor-parallel) solve supports the hsd family, "
            f"not {method!r}")
    kw = {"mesh": mesh} if mesh is not None else {}
    status, x, y, w, z, iters = get_solver(method)(canon, cfg, **kw)
    if (method in ("hsd", "hsdls") and mesh is None and cfg.quality_retries
            and int(np.asarray(status)) == int(Status.SUBOPTIMAL)):
        # the HSD quality gate (models/hsd.py) flagged a converged-but-
        # poor de-homogenized point (gap, complementarity, or feasibility
        # residuals above tolerance at mu < eps).
        #
        # First retry: re-solve UNSCALED.  The geometric equilibration
        # (canonicalize, cfg.scale="geometric") fixes knife-edge problems
        # (NESM/SCRS8/GANGES) but on a few instances (BRANDY, MODSZK1) it
        # steers the embedding to a perturbed optimum — the de-homogenized
        # dual residual grows as mu shrinks.  Unscaled, the same solver
        # lands 1e-12 from the true optimum, so the pair of runs covers
        # both failure modes; the gate decides which run to trust.
        if cfg.scale != "none":
            if cfg.verbose:
                print("hsd suboptimal: retrying unscaled", flush=True)
            canon2 = canonicalize(lp, pad_to=1, dtype=cfg.dtype,
                                  free_vars=cfg.free_vars, scale="none")
            if pad_to == "auto" and not (
                    cfg.use_ub_structure and _hsd_structure_applies(canon2)):
                canon2 = pad_canon(canon2, size_class(canon2.m),
                                   size_class(canon2.n))
            elif isinstance(pad_to, int) and pad_to != 1:
                # keep the caller's padding on the retry too (advisor r4:
                # an explicit pad_to fell back to exact dims here, losing
                # executable sharing)
                canon2 = pad_canon(canon2,
                                   -(-canon2.m // pad_to) * pad_to,
                                   -(-canon2.n // pad_to) * pad_to)
            st2, x2, y2, w2, z2, it2 = get_solver(method)(
                canon2, cfg.with_(scale="none"), **kw)
            if int(np.asarray(st2)) == int(Status.OPTIMAL):
                status, x, y, w, z = st2, x2, y2, w2, z2
                iters = int(np.asarray(iters)) + int(np.asarray(it2))
                canon = canon2
    if (method in ("hsd", "hsdls") and mesh is None and cfg.quality_retries
            and int(np.asarray(status)) == int(Status.SUBOPTIMAL)
            and canon.m * canon.n <= 100_000_000):
        # second retry: cross-check with the second algorithm family —
        # the path-following solver stops on RESIDUALS, so its optimum is
        # trustworthy where HSD's embedding degenerated (FORPLAN-class
        # instances).  Mirrors the reference's de-facto simplex-vs-IPM
        # cross-validation (SURVEY.md section 4).
        # Size gate (a policy not yet measured on the GPU): intpt has no
        # UbTail elimination, so it factors the whole dense canonical
        # system; beyond ~1e8 canonical elements the SUBOPTIMAL verdict
        # stands rather than paying for that solve.
        if cfg.verbose:
            print("hsd suboptimal (phi collapse): falling back to intpt",
                  flush=True)
        st2, x2, y2, w2, z2, it2 = _solve_intpt(canon, cfg)
        if int(np.asarray(st2)) == int(Status.OPTIMAL):
            status, x, y, w, z = st2, x2, y2, w2, z2
            iters = int(np.asarray(iters)) + int(np.asarray(it2))
    if int(np.asarray(status)) == int(Status.RUNNING):
        # a TIMLIM deadline stop exits the chunked loop mid-budget with the
        # internal RUNNING sentinel; report it as the reference's nearest
        # outcome (iteration limit) rather than leaking the sentinel
        status = int(Status.ITERATION_LIMIT)
    x = np.asarray(x)
    elapsed = time.perf_counter() - t0
    x, y, w, z, pobj, dobj, b_canon = recover_solution(canon, x, y, w, z)
    return Solution(status=int(status), x=x, y=y, w=w, z=z,
                    primal_obj=pobj, dual_obj=dobj, iterations=int(iters),
                    solve_time_s=elapsed, b_canon=b_canon)
