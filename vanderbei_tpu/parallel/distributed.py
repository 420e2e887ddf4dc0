"""Model-parallel (single large LP) building blocks.

The reference is single-threaded; scaling one large LP across chips is a
new capability.  The decomposition follows the normal-equations algebra:
with A's COLUMNS sharded over the "model" mesh axis (each device holds
A_k = A[:, k-th shard] and the matching D_k slice),

    M = E + sum_k A_k D_k^-1 A_k'          (primal form)

is a per-device partial syrk + one psum — the same pattern as
tensor-parallel attention logits.  The Cholesky factor and the triangular
solves then run replicated (m x m lives on every device), while all
A-sized work (the syrk, A'y gathers, Ax products) stays sharded.  This is
the profitable split when n >> m (many columns, few rows), which is what
canonicalization produces for upper-bounded problems.

Expressed with shard_map so the collective placement is explicit and
testable on a virtual CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def sharded_normal_matrix(A, Dinv, E, mesh: Mesh):
    """M = diag(E) + A diag(Dinv) A' with A/Dinv column-sharded on "model".

    Returns M replicated on every device.
    """
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "model"), P("model"), P(None)),
        out_specs=P(None, None))
    def _compute(A_blk, dinv_blk, e_full):
        partial = (A_blk * dinv_blk[None, :]) @ A_blk.T
        total = jax.lax.psum(partial, "model")
        return total + jnp.diag(e_full)

    return _compute(A, Dinv, E)


def sharded_kkt_solve(A, E, D, rhs_y, rhs_x, mesh: Mesh,
                      epsdiag: float = 1.0e-14):
    """One distributed primal-form KKT solve (factor + substitution).

    A (m, n) column-sharded; E (m,) replicated; D, rhs_x (n,) sharded.
    dy comes back replicated, dx sharded like D.
    """
    Dc = jnp.maximum(D, epsdiag)
    Ec = jnp.maximum(E, epsdiag)
    M = sharded_normal_matrix(A, 1.0 / Dc, Ec, mesh)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "model"), P("model"), P(None)),
        out_specs=P(None))
    def _rhs(A_blk, t_blk, ry_full):
        return jax.lax.psum(A_blk @ t_blk, "model") - ry_full

    t = _rhs(A, rhs_x / Dc, rhs_y)

    # replicated dense factor + solve (m x m fits every device)
    d = jnp.diagonal(M)
    s = jax.lax.rsqrt(jnp.maximum(d, 1e-300))
    L = jnp.linalg.cholesky(M * s[:, None] * s[None, :])
    from jax.scipy.linalg import cho_solve
    dy = s * cho_solve((L, True), s * t)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "model"), P("model"), P("model"), P(None)),
        out_specs=P("model"))
    def _back(A_blk, rx_blk, dinv_blk, dy_full):
        return (rx_blk - A_blk.T @ dy_full) * dinv_blk

    dx = _back(A, rhs_x, 1.0 / Dc, dy)
    return dy, dx


def place_column_sharded(A, D, rhs_x, mesh: Mesh):
    """Device-put the column-sharded operands for sharded_kkt_solve."""
    sh_cols2 = NamedSharding(mesh, P(None, "model"))
    sh_cols1 = NamedSharding(mesh, P("model"))
    return (jax.device_put(A, sh_cols2),
            jax.device_put(D, sh_cols1),
            jax.device_put(rhs_x, sh_cols1))
