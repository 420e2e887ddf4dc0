"""Dense square solves through Householder QR.

Generic square solves in this package (the simplex basis-inverse refresh,
`kkt.augmented_qr_solve`) go through QR rather than `jnp.linalg.solve`'s
LU.  QR is backward-stable and costs about twice LU's flops.  The GPU
factors LU at f64 as well, but switching the simplex to it changes its
pivoting numerics, so that is left to a measured change.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def qr_solve(A, B):
    """Solve A X = B for square A via QR.

    B may be a vector or a matrix.
    """
    q, r = jnp.linalg.qr(A)
    vec = B.ndim == 1
    rhs = q.T @ (B[:, None] if vec else B)
    X = jax.lax.linalg.triangular_solve(
        r, rhs, left_side=True, lower=False)
    return X[:, 0] if vec else X


def inv_qr(A):
    """Dense inverse via QR (used for the simplex basis-inverse refresh)."""
    return qr_solve(A, jnp.eye(A.shape[0], dtype=A.dtype))
