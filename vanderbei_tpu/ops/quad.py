"""Double-double ("Quad") arithmetic via error-free transforms.

The reference ships a C++ double-double class activated by -DQuadPrec
(src/Quad/Quad.{h,c}: Knuth two-sum add at Quad.c:180-236, Dekker split
multiply at Quad.c:240-270) that textually rebinds `double` in every
compilation unit, at ~50x slowdown (Quad.h:43-44).

The vectorized equivalent is a (hi, lo) pair carried through vectorized
error-free transforms — the same algorithms, but as elementwise VPU ops on
whole arrays, and usable at BOTH precisions: f64 pairs reproduce QuadPrec
mode (~32 significant digits), f32 pairs give double-like accuracy on
hardware whose fast path is single precision.  No FMA is assumed: products
use the Dekker split exactly like the reference.

Compensated reductions (dot2/sum2, Ogita-Rump-Oishi) give results as
accurate as evaluating in twice the working precision — the default
numerical hygiene for residuals and objectives on f32-dominant hardware.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class DD(NamedTuple):
    """Unevaluated sum hi + lo with |lo| <= ulp(hi)/2."""
    hi: jnp.ndarray
    lo: jnp.ndarray


def _split_const(dtype) -> float:
    # 2^s + 1 with s = ceil(p/2): 27 for f64 (Quad.c's 134217729), 12 for f32
    if np.dtype(dtype) == np.float64:
        return 134217729.0
    if np.dtype(dtype) == np.float32:
        return 4097.0
    raise ValueError(f"unsupported dtype {dtype}")


def two_sum(a, b):
    """Error-free a+b (Knuth): returns (s, err) with s+err == a+b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a+b assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Dekker split of a into high/low halves (Quad.c multstep)."""
    c = _split_const(a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free a*b: returns (p, err) with p+err == a*b exactly."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# --- DD arithmetic -------------------------------------------------------

def dd(x) -> DD:
    x = jnp.asarray(x)
    return DD(x, jnp.zeros_like(x))


def dd_add(x: DD, y: DD) -> DD:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    hi, lo = fast_two_sum(s, e)
    return DD(hi, lo)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    hi, lo = fast_two_sum(p, e)
    return DD(hi, lo)


def dd_div(x: DD, y: DD) -> DD:
    q1 = x.hi / y.hi
    r = dd_sub(x, dd_mul(dd(q1), y))
    q2 = r.hi / y.hi
    r = dd_sub(r, dd_mul(dd(q2), y))
    q3 = r.hi / y.hi
    hi, lo = fast_two_sum(q1, q2)
    return dd_add(DD(hi, lo), dd(q3))


def dd_sum(x: DD, axis=None) -> DD:
    """Tree-reduce a DD array with dd_add (log-depth, vectorized)."""
    hi, lo = x.hi, x.lo
    if axis is not None:
        raise NotImplementedError("dd_sum reduces all elements")
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    n = hi.shape[0]
    m = 1 << max(0, (n - 1).bit_length())
    pad = m - n
    hi = jnp.pad(hi, (0, pad))
    lo = jnp.pad(lo, (0, pad))
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        s = dd_add(DD(hi[:half], lo[:half]), DD(hi[half:], lo[half:]))
        hi, lo = s.hi, s.lo
    return DD(hi[0], lo[0])


# --- compensated reductions (work in single words, DD internally) --------

def dot2(a, b) -> jnp.ndarray:
    """Compensated dot product: as if computed in 2x working precision
    then rounded (Ogita-Rump-Oishi Dot2, vectorized as a tree)."""
    p, e = two_prod(a, b)
    s = dd_sum(DD(p, e))
    return s.hi + s.lo


def matvec2(A, x) -> jnp.ndarray:
    """Compensated matrix-vector product A @ x: every row evaluated as if
    in 2x working precision, then rounded once (row-wise Dot2).

    This is the vectorized analogue of the reference's QuadPrec rebinding
    of its residual kernels (src/Quad/Quad.h:43-44 + smx/dotprod under
    #define double Quad): instead of swapping the scalar type, the
    products' exact error terms ride along (two_prod) and a compensated
    pairwise reduction sums them.  O(1) extra memory per element (the
    error plane), ~6x the FLOPs of a plain matvec — all VPU elementwise,
    versus the reference's ~50x QuadPrec slowdown.
    """
    p, e = two_prod(A, x[None, :])
    hi, lo = p, e
    # pairwise dd reduction over columns (log-depth, stays vectorized)
    n = hi.shape[1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        hi = jnp.pad(hi, ((0, 0), (0, width - n)))
        lo = jnp.pad(lo, ((0, 0), (0, width - n)))
    while hi.shape[1] > 1:
        half = hi.shape[1] // 2
        s = dd_add(DD(hi[:, :half], lo[:, :half]),
                   DD(hi[:, half:], lo[:, half:]))
        hi, lo = s.hi, s.lo
    return hi[:, 0] + lo[:, 0]


def sum2(a) -> jnp.ndarray:
    """Compensated sum of an array."""
    s = dd_sum(dd(a))
    return s.hi + s.lo


def norm2sq(a) -> jnp.ndarray:
    return dot2(a, a)
