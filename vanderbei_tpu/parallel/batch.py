"""Instance batching: vmapped solves over padded size classes.

The netlib corpus spans 28..16k rows; batching requires a common padded
shape.  Problems are grouped into size classes (padded-dim buckets), each
class canonicalized with benign padding (core/canonicalize.py) and solved by
ONE vmapped, jitted while_loop — divergent per-instance iteration counts are
handled by the solvers' status masking (a converged lane no-ops its
updates), the run-to-fixpoint pattern from SURVEY.md section 7 hard part #3.

The batched IPM runs the same two-stage f32 -> f64 precision ladder as the
single-instance path (models/registry.py): stage 1 solves every lane in
pure f32 until each lane's mu crosses the stage boundary (the
vmapped while_loop runs until ALL lanes pause), stage 2 resumes the casted
states in f64 to the reference tolerance (hsd.c:24).

With a mesh, the stacked batch is sharded over the "batch" axis
(data parallelism over instances); A's column dim may additionally shard
over "model".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.canonicalize import canonicalize, CanonLP
from ..core.config import SolverConfig
from ..core.status import Status
from ..models import hsd as _hsd
from ..ops.kkt import UbTail
from jax.sharding import NamedSharding, PartitionSpec as P


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def size_class(canon_m: int, n: int, granularity: int = 128) -> tuple:
    """Bucket key: dims rounded up to the granularity."""
    return (_round_up(canon_m, granularity), _round_up(n, granularity))


def group_by_class(lps, granularity: int = 128,
                   use_ub_structure: bool = False, scale: str = "none",
                   free_vars: str = "reject"):
    """Canonicalize each LP and bucket by padded shape.

    Returns {key: [(index, CanonLP), ...]} over the input order; LPs whose
    canonicalization aborts (free variables) are returned separately as
    [(index, status)].

    With use_ub_structure, problems whose canonical tail is all singleton
    upper-bound rows bucket by the STRUCTURED class key
    ("s", M1, N, K) — head dims + tail count, each rounded up — and are
    solved through the Schur-eliminated UbTail path; the rest bucket by
    the dense key ("d", M, N).
    """
    from ..models.registry import _hsd_structure_applies
    classes: dict = {}
    aborted = []
    for idx, lp in enumerate(lps):
        canon = canonicalize(lp, pad_to=1, scale=scale, free_vars=free_vars)
        if canon.status != int(Status.RUNNING):
            aborted.append((idx, canon.status))
            continue
        if use_ub_structure and _hsd_structure_applies(canon):
            k = len(canon.ub_cols)
            m1 = canon.m - k
            key = ("s", _round_up(m1, granularity),
                   _round_up(canon.n, granularity),
                   _round_up(k, granularity))
        elif use_ub_structure:
            key = ("d",) + size_class(canon.m, canon.n, granularity)
        else:       # legacy dense-only keying
            key = size_class(canon.m, canon.n, granularity)
        classes.setdefault(key, []).append((idx, canon))
    return classes, aborted


def stack_class(entries, mp: int, np_: int, dtype=np.float64):
    """Stack a size class's canonical problems into (B, mp, np_) arrays."""
    B = len(entries)
    A = np.zeros((B, mp, np_), dtype=dtype)
    b = np.ones((B, mp), dtype=dtype)
    c = np.zeros((B, np_), dtype=dtype)
    for k, (_, canon) in enumerate(entries):
        m, n = canon.m, canon.n
        A[k, :m, :n] = canon.A[:m, :n]
        b[k, :m] = canon.b[:m]
        c[k, :n] = canon.c[:n]
    return A, b, c


def stack_class_device(entries, mp: int, np_: int, dtype=np.float64):
    """stack_class, but the (B, mp, np_) operand is assembled ON DEVICE
    from one concatenated COO copy (ops/assemble.device_dense_batch) when
    that is smaller than the dense stack.  b and c ship dense (they are
    small)."""
    from ..ops.assemble import device_dense_batch
    import jax.numpy as jnp
    B = len(entries)
    blocks = []
    b = np.ones((B, mp), dtype=dtype)
    c = np.zeros((B, np_), dtype=dtype)
    for k, (_, canon) in enumerate(entries):
        m, n = canon.m, canon.n
        blocks.append(np.asarray(canon.A[:m, :n], dtype))
        b[k, :m] = canon.b[:m]
        c[k, :n] = canon.c[:n]
    A = device_dense_batch(blocks, B, mp, np_, dtype)
    return A, b, c


def stack_class_structured_device(entries, M1: int, N: int, K: int,
                                  dtype=np.float64):
    """stack_class_structured with the (B, M1, N) head assembled on
    device from one COO shipment (see stack_class_device)."""
    from ..models.registry import _hsd_structured_operands
    from ..ops.assemble import device_dense_batch
    B = len(entries)
    blocks = []
    b = np.ones((B, M1 + K), dtype=dtype)
    c = np.zeros((B, N), dtype=dtype)
    idx2 = np.zeros((B, K), dtype=np.int32)
    w2 = np.zeros((B, K), dtype=dtype)
    for j, (_, canon) in enumerate(entries):
        s = _hsd_structured_operands(canon, M1=M1, K=K, N=N)
        assert s is not None, "structured class entry lost its structure"
        blocks.append(np.asarray(s["A1"], dtype))
        b[j] = s["b"]
        c[j] = s["c"]
        idx2[j] = s["idx2"]
        w2[j] = s["w2"]
    A1 = device_dense_batch(blocks, B, M1, N, dtype)
    return A1, b, c, UbTail(idx2, w2)


def stack_class_structured(entries, M1: int, N: int, K: int,
                           dtype=np.float64):
    """Stack a STRUCTURED size class: head A1 (B, M1, N), b (B, M1+K),
    c (B, N) plus the batched UbTail (idx2, w2 each (B, K); w2 = 0 marks
    padding tail rows)."""
    from ..models.registry import _hsd_structured_operands
    B = len(entries)
    A1 = np.zeros((B, M1, N), dtype=dtype)
    b = np.ones((B, M1 + K), dtype=dtype)
    c = np.zeros((B, N), dtype=dtype)
    idx2 = np.zeros((B, K), dtype=np.int32)
    w2 = np.zeros((B, K), dtype=dtype)
    for j, (_, canon) in enumerate(entries):
        s = _hsd_structured_operands(canon, M1=M1, K=K, N=N)
        assert s is not None, "structured class entry lost its structure"
        A1[j] = s["A1"]
        b[j] = s["b"]
        c[j] = s["c"]
        idx2[j] = s["idx2"]
        w2[j] = s["w2"]
    return A1, b, c, UbTail(idx2, w2)


def _run_batch(A, b, c, init, *, max_iter, eps, step_factor, beta,
               epsdiag, refine_tol, pause_mu, long_step, max_refine,
               factor_dtype, ub=None, gap_tol=1.0e-6, feas_tol=1.0e-6,
               corrector="mehrotra", compensated=False):
    def one(Ai, bi, ci, st, ubi):
        return _hsd._hsd_loop(
            Ai, bi, ci, 0.0, st, max_iter=max_iter, eps=eps,
            step_factor=step_factor, beta=beta, epsdiag=epsdiag,
            refine_tol=refine_tol, pause_mu=pause_mu, gap_tol=gap_tol,
            feas_tol=feas_tol,
            long_step=long_step, max_refine=max_refine,
            factor_dtype=factor_dtype, corrector=corrector,
            compensated=compensated, ub=ubi)
    if ub is None:
        return jax.vmap(lambda Ai, bi, ci, st:
                        one(Ai, bi, ci, st, None))(A, b, c, init)
    return jax.vmap(one)(A, b, c, init, ub)


def _batch_init(A, ub):
    extra = 0 if ub is None else ub.idx2.shape[1]
    return jax.vmap(lambda Ai: _hsd.init_state(Ai, extra_rows=extra))(A)


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "long_step", "max_refine", "precision",
                     "corrector", "compensated"))
def solve_batch_hsd(A, b, c, *,
                    ub: UbTail | None = None,
                    max_iter: int = 200,
                    eps: float = 1.0e-12,
                    step_factor: float = 0.95,
                    long_step: bool = False,
                    beta: float = 0.80,
                    epsdiag: float = 1.0e-14,
                    refine_tol: float = 1.0e-10,
                    max_refine: int = 4,
                    precision: str = "mixed",
                    corrector: str = "mehrotra",
                    compensated: bool = False,
                    stage1_mu: float = 1.0e-4):
    """Two-stage vmapped HSD over a stacked class (B, mp, np_).

    ub: batched UbTail (idx2, w2 each (B, K)) — A then holds only head
    rows and b spans (B, mp + K); the Schur-eliminated structured KKT
    path runs per lane (stack_class_structured builds these).

    Returns (status, x, y, w, z, iterations), each batched over B.

    The WHOLE two-stage ladder (f32 sprint, cast, f32-divergence lane
    restart, f64 polish, finish) is one jitted program: every distinct
    eager op would be its own XLA executable, so inter-stage glue left
    eager turns one batched solve into ~20 compiles.
    """
    knobs = dict(max_iter=max_iter, eps=eps, step_factor=step_factor,
                 beta=beta, epsdiag=epsdiag, refine_tol=refine_tol,
                 long_step=long_step, max_refine=max_refine,
                 corrector=corrector)

    def cast_ub(dtype):
        return None if ub is None else UbTail(ub.idx2, ub.w2.astype(dtype))

    if precision == "mixed":
        # the f32 sprint can't hit f64 refinement targets; relax them there
        # (jnp.maximum: the knobs are traced scalars under the outer jit)
        knobs32 = dict(knobs, epsdiag=jnp.maximum(epsdiag, 1e-8),
                       refine_tol=jnp.maximum(refine_tol, 1e-4))
        A32 = A.astype(jnp.float32)
        st = _batch_init(A32, ub)
        st = _run_batch(A32, b.astype(jnp.float32), c.astype(jnp.float32),
                        st, pause_mu=stage1_mu, factor_dtype=None,
                        ub=cast_ub(jnp.float32), **knobs32)
        st = _hsd.cast_state(st, jnp.float64)
        # lanes that diverged in f32 restart clean in f64 (the device
        # finiteness guard stops such lanes SUBOPTIMAL at the last
        # finite iterate, so check status as well as values)
        finite = (jnp.all(jnp.isfinite(st.x), axis=1)
                  & jnp.isfinite(st.phi)
                  & (st.status != int(Status.SUBOPTIMAL)))
        fresh = _batch_init(A.astype(jnp.float64), ub)
        st = jax.tree.map(
            lambda warm, cold: jnp.where(
                finite.reshape((-1,) + (1,) * (warm.ndim - 1)), warm, cold),
            st, fresh)
        factor_dtype = None
    elif precision == "f32factor":
        st = _batch_init(A, ub)
        factor_dtype = jnp.float32
    else:
        st = _batch_init(A, ub)
        factor_dtype = None
    out = _run_batch(A, b, c, st, pause_mu=0.0, factor_dtype=factor_dtype,
                     ub=cast_ub(A.dtype), compensated=compensated, **knobs)
    return jax.vmap(_hsd.finish_state, in_axes=(0, None))(out, max_iter)


def shard_batch(arrays, mesh, model_axis_dims=()):
    """Place stacked (B, ...) arrays on the mesh, batch-sharded.

    model_axis_dims: per-array tuple position (or None) to additionally
    shard over "model" — e.g. A's column dim.
    """
    out = []
    for i, arr in enumerate(arrays):
        spec = [None] * arr.ndim
        spec[0] = "batch"
        if i < len(model_axis_dims) and model_axis_dims[i] is not None:
            spec[model_axis_dims[i]] = "model"
        sharding = NamedSharding(mesh, P(*spec))
        out.append(jax.device_put(jnp.asarray(arr), sharding))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "max_refine", "precision"))
def solve_batch_intpt(A, b, c, *,
                      max_iter: int = 200,
                      eps: float = 1.0e-6,
                      delta: float = 0.02,
                      step_factor: float = 0.9,
                      epsdiag: float = 1.0e-14,
                      refine_tol: float = 1.0e-10,
                      max_refine: int = 4,
                      precision: str = "mixed",
                      stage1_gap: float = 1.0e-2,
                      gap_floor: float = 1.0e-2):
    """Two-stage vmapped path-following IPM over a stacked class.

    Mirrors solve_batch_hsd: stage 1 runs every lane in f32 until its
    duality gap crosses stage1_gap * (n+m), stage 2 resumes in f64 to the
    reference tolerance (intpt.c:30).  One jitted program end to end.
    """
    from ..models import intpt as _intpt
    B, mp, np_ = A.shape
    knob_gap = stage1_gap * (mp + np_)

    def run(Ai, bi, ci, st, pause, factor_dtype, eps_d, ref_t, dd):
        return _intpt._intpt_loop(
            Ai, bi, ci, 0.0, jnp.zeros((), Ai.dtype), st,
            max_iter=max_iter, eps=eps, delta=delta,
            step_factor=step_factor, epsdiag=eps_d, refine_tol=ref_t,
            pause_gap=pause, div_detect=dd, gap_floor=gap_floor,
            max_refine=max_refine,
            factor_dtype=factor_dtype, has_q=False)

    if precision == "mixed":
        A32 = A.astype(jnp.float32)
        st = jax.vmap(_intpt.init_state)(A32)
        st = jax.vmap(lambda Ai, bi, ci, s: run(
            Ai, bi, ci, s, knob_gap, None,
            jnp.maximum(epsdiag, 1e-8), jnp.maximum(refine_tol, 1e-4),
            False))(A32, b.astype(jnp.float32), c.astype(jnp.float32), st)
        st = _intpt.cast_state(st, jnp.float64)
        finite = (jnp.all(jnp.isfinite(st.x), axis=1)
                  & (st.status != int(Status.SUBOPTIMAL)))
        fresh = jax.vmap(_intpt.init_state)(A)
        st = jax.tree.map(
            lambda warm, cold: jnp.where(
                finite.reshape((-1,) + (1,) * (warm.ndim - 1)), warm, cold),
            st, fresh)
    else:
        st = jax.vmap(_intpt.init_state)(A)
    out = jax.vmap(lambda Ai, bi, ci, s: run(
        Ai, bi, ci, s, 0.0, None, epsdiag, refine_tol, True))(A, b, c, st)
    return jax.vmap(_intpt.finish_state, in_axes=(0, None))(out, max_iter)


@functools.partial(jax.jit, static_argnames=("max_iter", "refresh_every"))
def solve_batch_pd(A, b, c, *, max_iter: int = 20000,
                   refresh_every: int = 64, seed: int = 0):
    """vmapped parametric self-dual simplex over a stacked class.

    Divergent pivot counts across the batch are handled by the chunked
    run-to-fixpoint loop (finished lanes no-op until the slowest converges).
    """
    from ..models.simplex import _pd_loop
    B, mp, np_ = A.shape
    eye = jnp.eye(mp, dtype=A.dtype)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)

    def one(Ai, bi, ci, key):
        Afull = jnp.concatenate([Ai, eye], axis=1)
        # drop the resume state (7th element): lanes have no per-lane
        # chunk driver; the batched budget bounds the launch instead
        return _pd_loop(Afull, bi, ci, key, max_iter=max_iter,
                        refresh_every=refresh_every)[:6]

    return jax.vmap(one)(A, b, c, keys)
