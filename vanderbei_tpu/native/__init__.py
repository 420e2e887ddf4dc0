"""Native (C++) runtime components, bound via ctypes.

The reference's entire runtime is C; here the device compute path is JAX/XLA
and the host runtime keeps native components where they are hot: the MPS
data loader (this package) parses the corpus ~50x faster than the pure
Python reader, with identical semantics (tested against it on the netlib
corpus).

The shared library is built on demand with g++ (no pybind11 in the image;
plain C ABI + ctypes).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mps_reader.cc")
_LIB = os.path.join(_DIR, "libvmps.so")

_lib = None


class _VmpsLP(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int64), ("n", ctypes.c_int64),
        ("nz", ctypes.c_int64), ("qnz", ctypes.c_int64),
        ("A", ctypes.POINTER(ctypes.c_double)),
        ("iA", ctypes.POINTER(ctypes.c_int64)),
        ("kA", ctypes.POINTER(ctypes.c_int64)),
        ("b", ctypes.POINTER(ctypes.c_double)),
        ("r", ctypes.POINTER(ctypes.c_double)),
        ("c", ctypes.POINTER(ctypes.c_double)),
        ("l", ctypes.POINTER(ctypes.c_double)),
        ("u", ctypes.POINTER(ctypes.c_double)),
        ("Q", ctypes.POINTER(ctypes.c_double)),
        ("iQ", ctypes.POINTER(ctypes.c_int64)),
        ("kQ", ctypes.POINTER(ctypes.c_int64)),
        ("varsgn", ctypes.POINTER(ctypes.c_int64)),
        ("rowlab", ctypes.POINTER(ctypes.c_char)),
        ("rowlab_off", ctypes.POINTER(ctypes.c_int64)),
        ("collab", ctypes.POINTER(ctypes.c_char)),
        ("collab_off", ctypes.POINTER(ctypes.c_int64)),
        ("maximize", ctypes.c_int32),
        ("inftol", ctypes.c_double),
        ("sf_req", ctypes.c_int64),
        ("verbose", ctypes.c_int64),
        ("itnlim", ctypes.c_int64),
        ("timlim", ctypes.c_double),
        ("name", ctypes.c_char * 256),
        ("obj", ctypes.c_char * 256),
        ("err", ctypes.c_char_p),
        ("np_", ctypes.c_int64),
        ("pkeys", ctypes.POINTER(ctypes.c_char)),
        ("pkeys_off", ctypes.POINTER(ctypes.c_int64)),
        ("pvals", ctypes.POINTER(ctypes.c_char)),
        ("pvals_off", ctypes.POINTER(ctypes.c_int64)),
    ]


def build(force: bool = False) -> str:
    """Compile libvmps.so if missing or stale; returns its path."""
    if (not force and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", _LIB, _SRC],
        check=True, capture_output=True)
    return _LIB


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.vmps_read.restype = ctypes.POINTER(_VmpsLP)
        lib.vmps_read.argtypes = [ctypes.c_char_p]
        lib.vmps_release.restype = None
        lib.vmps_release.argtypes = [ctypes.POINTER(_VmpsLP)]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _labels(text_ptr, off_ptr, count):
    if count == 0:
        return []
    offs = np.ctypeslib.as_array(off_ptr, shape=(count + 1,))
    raw = ctypes.cast(text_ptr, ctypes.POINTER(ctypes.c_char * int(offs[-1])))
    blob = bytes(raw.contents)
    return [blob[int(offs[i]):int(offs[i + 1]) - 1].decode()
            for i in range(count)]


def read_mps_native(path: str):
    """Parse one MPS file with the native reader; returns an LP."""
    from ..core.lp import LP

    lib = _load()
    p = lib.vmps_read(path.encode())
    try:
        s = p.contents
        if s.err:
            raise ValueError(s.err.decode())
        m, n = int(s.m), int(s.n)
        lp = LP(
            name=s.name.decode(),
            m=m, n=n,
            A=_arr(s.A, int(s.nz), np.float64),
            iA=_arr(s.iA, int(s.nz), np.int64),
            kA=_arr(s.kA, n + 1, np.int64),
            b=_arr(s.b, m, np.float64),
            c=_arr(s.c, n, np.float64),
            f=0.0,
            r=_arr(s.r, m, np.float64),
            l=_arr(s.l, n, np.float64),
            u=_arr(s.u, n, np.float64),
            Q=_arr(s.Q, int(s.qnz), np.float64),
            iQ=_arr(s.iQ, int(s.qnz), np.int64),
            kQ=_arr(s.kQ, n + 1, np.int64),
            qnz=int(s.qnz),
            varsgn=_arr(s.varsgn, n, np.int64),
            rowlab=_labels(s.rowlab, s.rowlab_off, m),
            collab=_labels(s.collab, s.collab_off, n),
            maximize=bool(s.maximize),
            inftol=float(s.inftol),
            sf_req=int(s.sf_req),
            verbose=int(s.verbose),
            itnlim=int(s.itnlim),
            timlim=float(s.timlim),
            obj_name=s.obj.decode(),
            params=dict(zip(_labels(s.pkeys, s.pkeys_off, int(s.np_)),
                            _labels(s.pvals, s.pvals_off, int(s.np_)))),
        )
        return lp
    finally:
        lib.vmps_release(p)
