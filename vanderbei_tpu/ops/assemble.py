"""Device-side operand assembly: ship COO, densify on device.

The canonical dense operands of a mid-size netlib problem are tens of MB
(SCTAP3's padded 2048x2560 f64 head alone is 42 MB), while the underlying
problem has only 10k-300k nonzeros.  So the host-to-device copy keeps the
wire format SPARSE — value + (row, col) index triples — and builds the
dense operand on the DEVICE with one scatter-add:

    A = zeros((mp, np_)).at[rows, cols].add(vals)

Nonzero counts pad to power-of-two classes so the scatter program is
compiled once per (nnz_class, shape) pair; padding triples add 0.0 at
(0, 0), which is exact under `add`.  Dense fallback: when the COO wire
encoding would not actually be smaller than the dense array (FIT-class
near-dense problems), ship dense directly.  Whether this pays over a
plain dense copy on the GPU's host link has not been measured.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_NNZ_FLOOR = 4096


def _nnz_class(nnz: int) -> int:
    c = _NNZ_FLOOR
    while c < nnz:
        c *= 2
    return c


@functools.partial(jax.jit, static_argnames=("mp", "np_"))
def _densify(vals, rows, cols, mp: int, np_: int):
    return jnp.zeros((mp, np_), vals.dtype).at[rows, cols].add(
        vals, mode="drop")


@functools.partial(jax.jit, static_argnames=("B", "mp", "np_"))
def _densify_batch(vals, lanes, rows, cols, B: int, mp: int, np_: int):
    return jnp.zeros((B, mp, np_), vals.dtype).at[lanes, rows, cols].add(
        vals, mode="drop")


def to_coo(A: np.ndarray, extra_rows=None, extra_cols=None,
           extra_vals=None):
    """Host-side COO extraction with nnz padded to a size class.

    extra_*: additional triples appended before padding (callers composing
    an operand from blocks without materializing the whole dense array).
    Returns (vals, rows, cols) numpy arrays of class length.
    """
    rows, cols = np.nonzero(A)
    vals = A[rows, cols]
    if extra_rows is not None:
        rows = np.concatenate([rows, np.asarray(extra_rows, rows.dtype)])
        cols = np.concatenate([cols, np.asarray(extra_cols, cols.dtype)])
        vals = np.concatenate([vals, np.asarray(extra_vals, vals.dtype)])
    nnz = len(vals)
    cap = _nnz_class(nnz)
    pad = cap - nnz
    if pad:
        rows = np.concatenate([rows, np.zeros(pad, rows.dtype)])
        cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
        vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    return (vals, rows.astype(np.int32), cols.astype(np.int32))


def coo_worthwhile(nnz: int, mp: int, np_: int, itemsize: int = 8) -> bool:
    """True when the COO wire encoding beats shipping the dense array."""
    wire_coo = _nnz_class(nnz) * (itemsize + 8)   # vals + two int32 indices
    return wire_coo < 0.6 * mp * np_ * itemsize


def device_dense(A: np.ndarray, mp: int | None = None,
                 np_: int | None = None, dtype=None) -> jax.Array:
    """Build the dense (mp, np_) device array for host matrix A.

    Ships COO when it is smaller on the wire, else the dense array.  The
    returned array is committed to the default device; cast it (device-side)
    for lower-precision stages rather than re-shipping.
    """
    m, n = A.shape
    mp = mp or m
    np_ = np_ or n
    dtype = dtype or A.dtype
    nnz = int(np.count_nonzero(A))
    if not coo_worthwhile(nnz, mp, np_, np.dtype(dtype).itemsize):
        if (mp, np_) != (m, n):
            Ap = np.zeros((mp, np_), dtype=dtype)
            Ap[:m, :n] = A
            A = Ap
        return jnp.asarray(A, dtype)
    vals, rows, cols = to_coo(np.asarray(A, dtype))
    return _densify(jnp.asarray(vals), jnp.asarray(rows),
                    jnp.asarray(cols), mp, np_)


def device_dense_batch(blocks, B: int, mp: int, np_: int,
                       dtype=np.float64) -> jax.Array:
    """Stack host matrices into a (B, mp, np_) device array via one
    batched scatter (blocks: list of <= B (mi, ni) arrays, lane j at
    blocks[j]).  Falls back to dense shipping when COO would not pay."""
    nnz = sum(int(np.count_nonzero(blk)) for blk in blocks)
    if not coo_worthwhile(nnz, B * mp, np_, np.dtype(dtype).itemsize):
        A = np.zeros((B, mp, np_), dtype=dtype)
        for j, blk in enumerate(blocks):
            m, n = blk.shape
            A[j, :m, :n] = blk
        return jnp.asarray(A)
    lanes_l, rows_l, cols_l, vals_l = [], [], [], []
    for j, blk in enumerate(blocks):
        r, c = np.nonzero(blk)
        lanes_l.append(np.full(len(r), j, np.int32))
        rows_l.append(r.astype(np.int32))
        cols_l.append(c.astype(np.int32))
        vals_l.append(np.asarray(blk[r, c], dtype))
    lanes = np.concatenate(lanes_l) if lanes_l else np.zeros(0, np.int32)
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int32)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int32)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, dtype)
    cap = _nnz_class(len(vals))
    pad = cap - len(vals)
    if pad:
        lanes = np.concatenate([lanes, np.zeros(pad, np.int32)])
        rows = np.concatenate([rows, np.zeros(pad, np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, dtype)])
    return _densify_batch(jnp.asarray(vals), jnp.asarray(lanes),
                          jnp.asarray(rows), jnp.asarray(cols),
                          B, mp, np_)
