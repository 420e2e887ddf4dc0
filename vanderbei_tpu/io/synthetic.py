"""Seeded LP generator and the HiGHS reference it is checked against.

The repository carries no problem corpus, so the tests and `chip_smoke.py`
build their instances here from a seed.  `random_lp` makes a sparse LP in
the shape of netlib's general instances: a mix of `<=`, `>=` and `=` rows,
upper bounds on a share of the columns, a fixed number of nonzeros per
column, and coefficients spread log-uniformly over four decades.  It is
feasible and bounded by construction:

- b comes from an interior point x0 (0.5 <= x0 <= 1.5, strictly inside
  every bound), with a positive slack on each inequality row;
- c = A'y0 + z0 for a dual-feasible (y0, z0) with z0 > 0 on every column,
  so the dual is feasible and the primal minimum is finite.

Every value is rounded to six significant figures, so `io.writer.write_lp`
writes the instance to MPS without losing a digit and the file and the
in-memory LP are the same problem.

`highs_reference` solves an `LP` with `scipy.optimize.linprog(method=
"highs")`, independently of this package's canonicalization and solvers.
"""

from __future__ import annotations

import numpy as np

from ..core.lp import LP, INF, VAR_REAL
from ..core.status import Status

# shares of <=, >= and = rows
ROW_MIX = (0.6, 0.2, 0.2)


def _round_sig(x: np.ndarray, digits: int = 6) -> np.ndarray:
    return np.array([float(f"{v:.{digits}g}") for v in np.ravel(x)],
                    dtype=np.float64).reshape(np.shape(x))


def _column_rows(rng, m: int, n: int, k: int) -> np.ndarray:
    """(n, k) row indices, k distinct rows per column."""
    out = np.empty((n, k), np.int64)
    for j0 in range(0, n, 512):
        j1 = min(n, j0 + 512)
        keys = rng.random((j1 - j0, m))
        out[j0:j1] = np.argpartition(keys, k - 1, axis=1)[:, :k]
    return out


def random_lp(m: int, n: int, *, density: float, ub_frac: float,
              seed: int, name: str = "RANDLP") -> LP:
    """A feasible, bounded min-LP with m general rows and n columns.

    density: share of the m rows each column touches (at least one);
    ub_frac: share of columns with a finite upper bound.
    Rows split ROW_MIX between <=, >= and =; every row gets at least one
    nonzero.  The same arguments always give the same LP.
    """
    if m < 1 or n < 1:
        raise ValueError(f"need m, n >= 1, got {m}x{n}")
    rng = np.random.default_rng(seed)
    k = int(min(m, max(1, round(density * m))))

    rows = _column_rows(rng, m, n, k)
    cols = np.repeat(np.arange(n), k)
    rows = rows.ravel()
    empty = np.nonzero(np.bincount(rows, minlength=m) == 0)[0]
    rows = np.concatenate([rows, empty])
    cols = np.concatenate([cols, rng.integers(0, n, len(empty))])
    vals = (10.0 ** rng.uniform(-2.0, 2.0, len(rows))
            * rng.choice([-1.0, 1.0], len(rows)))
    vals = _round_sig(vals)
    order = np.lexsort((rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]

    n_le = int(round(ROW_MIX[0] * m))
    n_ge = int(round(ROW_MIX[1] * m))
    kind = np.zeros(m, np.int64)                 # 0: <=, 1: >=, 2: =
    perm = rng.permutation(m)
    kind[perm[n_le:n_le + n_ge]] = 1
    kind[perm[n_le + n_ge:]] = 2

    x0 = rng.uniform(0.5, 1.5, n)
    act = np.bincount(rows, weights=vals * x0[cols], minlength=m)
    size = np.bincount(rows, weights=np.abs(vals) * x0[cols], minlength=m)
    slack = rng.uniform(0.05, 0.5, m) * size
    rhs = _round_sig(np.where(kind == 0, act + slack,
                              np.where(kind == 1, act - slack, act)))

    # stored form b <= Ax <= b + r: <= rows are negated, as the MPS reader
    # and LPBuilder store them
    neg = kind == 0
    vals = np.where(neg[rows], -vals, vals)
    b = np.where(neg, -rhs, rhs)
    r = np.where(kind == 2, 0.0, INF)

    u = np.full(n, INF)
    ub_cols = rng.permutation(n)[:int(round(ub_frac * n))]
    u[ub_cols] = _round_sig(x0[ub_cols] + rng.uniform(0.5, 2.0,
                                                      len(ub_cols)))

    # y0 >= 0 on the (stored) >= rows, free on = rows; z0 > 0
    y0 = np.where(kind == 2, rng.uniform(-1.0, 1.0, m),
                  rng.uniform(0.0, 1.0, m))
    z0 = rng.uniform(0.1, 1.0, n)
    c = _round_sig(np.bincount(cols, weights=vals * y0[rows], minlength=n)
                   + z0)

    kA = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=n))])
    return LP(
        name=name, m=m, n=n, A=vals, iA=rows, kA=kA.astype(np.int64),
        b=b, c=c, f=0.0, r=r, l=np.zeros(n), u=u,
        Q=np.zeros(0), iQ=np.zeros(0, np.int64),
        kQ=np.zeros(n + 1, np.int64), qnz=0,
        varsgn=np.full(n, VAR_REAL, np.int64),
        rowlab=[f"R{i}" for i in range(m)],
        collab=[f"C{j}" for j in range(n)],
    )


def highs_reference(lp: LP) -> tuple[int, float]:
    """(status, objective) of the LP from scipy's HiGHS.

    The status is this package's `Status` code; the objective is in the
    LP's own sense, constant included (nan unless OPTIMAL).
    """
    from scipy.optimize import linprog
    from scipy.sparse import csc_matrix, vstack

    if lp.qnz:
        raise ValueError("highs_reference solves LPs only (QUADS present)")
    A = csc_matrix((lp.A, lp.iA, lp.kA), shape=(lp.m, lp.n)).tocsr()
    r = lp.r if lp.r is not None else np.zeros(lp.m)
    eq = r == 0.0
    lo = ~eq & np.isfinite(lp.b)
    hi = ~eq & np.isfinite(r)
    A_ub = vstack([-A[lo], A[hi]]).tocsr()
    b_ub = np.concatenate([-lp.b[lo], lp.b[hi] + r[hi]])
    sign = -1.0 if lp.maximize else 1.0
    l = lp.l if lp.l is not None else np.zeros(lp.n)
    u = lp.u if lp.u is not None else np.full(lp.n, INF)
    res = linprog(sign * lp.c,
                  A_ub=A_ub if A_ub.shape[0] else None,
                  b_ub=b_ub if A_ub.shape[0] else None,
                  A_eq=A[eq] if eq.any() else None,
                  b_eq=lp.b[eq] if eq.any() else None,
                  bounds=np.column_stack([l, u]), method="highs")
    status = {0: Status.OPTIMAL, 1: Status.ITERATION_LIMIT,
              2: Status.PRIMAL_INFEASIBLE,
              3: Status.PRIMAL_UNBOUNDED}.get(res.status)
    if status is None:
        raise RuntimeError(f"HiGHS failed: {res.message}")
    obj = sign * res.fun + lp.f if status == Status.OPTIMAL else float("nan")
    return int(status), float(obj)
