"""ctypes bindings to the native host library (``native/fmf_host.cpp``).

Counterpart of functionalmf_tpu/utils/native.py: the host-side sequential
inner loops, PAV and Lawson-Hanson NNLS (plain and in Gram form, one
problem or a batch), in C++. The source is read from ``native/`` and never
written there: at first use it is compiled with the host's ``c++`` and
``native/Makefile``'s flags into ``functionalmf_tpu_torch/_build/``, as
``libfmf_host_<hash>.so`` (a hash of the source and the flags, so an
edited source builds anew). A build holds the build directory's lock
(``_runtime.build_lock``), so processes started together compile once;
the compiler writes a temporary file of its process and thread that is
renamed into place. A missing compiler or
a failed compile raises with the compiler's output; nothing falls back
to numpy.

``utils/nmf.py`` (the Gram NNLS batch) and ``utils/pav.py`` (``pav``) call
this module; their numpy versions stay beside them as the plain versions
the tests hold it against.

    python -m functionalmf_tpu_torch.utils.native      # build, print path
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from functionalmf_tpu_torch._runtime import build_lock

__all__ = ["CXX_FLAGS", "build", "pav", "pav_weighted", "nnls", "nnls_batch",
           "nnls_gram", "nnls_gram_batch"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "fmf_host.cpp"
_BUILD_DIR = _PKG / "_build"
# native/Makefile: CXXFLAGS = -O3 -fPIC -std=c++17 -Wall, then -shared
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_DP = ctypes.POINTER(ctypes.c_double)


def build(force: bool = False) -> Path:
    """Compile native/fmf_host.cpp unless a library of the same hash
    exists (or ``force``); return the library's path."""
    if not _SRC.exists():
        raise RuntimeError(f"native source not found: {_SRC}")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out = _BUILD_DIR / f"libfmf_host_{h.hexdigest()[:16]}.so"
    if out.exists() and not force:
        return out
    with build_lock(_BUILD_DIR):
        if out.exists() and not force:   # built meanwhile by another process
            return out
        cxx = shutil.which("c++")
        if cxx is None:
            raise RuntimeError(
                "no host C++ compiler (c++) on PATH: the native library is "
                "compiled from native/fmf_host.cpp at first use")
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"c++ failed ({proc.returncode}): {' '.join(cmd)}"
                f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        dp, n = _DP, ctypes.c_long
        for name, args in (
                ("fmf_pav", [dp, dp, n]),
                ("fmf_pav_weighted", [dp, dp, dp, n]),
                ("fmf_nnls", [dp, n, n, dp, dp]),
                ("fmf_nnls_batch", [dp, n, n, dp, n, dp]),
                ("fmf_nnls_gram", [dp, dp, n, dp]),
                ("fmf_nnls_gram_batch", [dp, dp, n, n, dp])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _f64(a, ndim):
    a = np.ascontiguousarray(a, dtype=np.float64)
    if a.ndim != ndim:
        raise ValueError(f"expected a {ndim}-d array, got shape {a.shape}")
    return a


def _ptr(a):
    return a.ctypes.data_as(_DP)


def _call(name, *args):
    """Call a library function; each returns < 0 on failure (NNLS > 0: its
    iteration limit, the solution usable)."""
    rc = getattr(_load(), name)(*args)
    if rc < 0:
        raise RuntimeError(f"{name} failed: {rc}")


def pav(y):
    """Monotone-increasing PAV (reference utils.py:458-492)."""
    y = _f64(y, 1)
    out = np.empty_like(y)
    _call("fmf_pav", _ptr(y), _ptr(out), y.shape[0])
    return out


def pav_weighted(y, w):
    """Weighted monotone-increasing PAV."""
    y, w = _f64(y, 1), _f64(w, 1)
    if w.shape != y.shape:
        raise ValueError(f"weights {w.shape} do not match y {y.shape}")
    out = np.empty_like(y)
    _call("fmf_pav_weighted", _ptr(y), _ptr(w), _ptr(out), y.shape[0])
    return out


def nnls(A, b):
    """min ||A x - b||, x >= 0 (Lawson-Hanson). Returns x."""
    A, b = _f64(A, 2), _f64(b, 1)
    m, n = A.shape
    if b.shape != (m,):
        raise ValueError(f"b {b.shape} does not match A {A.shape}")
    x = np.zeros(n)
    _call("fmf_nnls", _ptr(A), m, n, _ptr(b), _ptr(x))
    return x


def nnls_batch(A, B):
    """Batched NNLS sharing one design: B is (nb, m); returns (nb, n)."""
    A, B = _f64(A, 2), _f64(B, 2)
    m, n = A.shape
    if B.shape[1] != m:
        raise ValueError(f"B {B.shape} does not match A {A.shape}")
    X = np.zeros((B.shape[0], n))
    _call("fmf_nnls_batch", _ptr(A), m, n, _ptr(B), B.shape[0], _ptr(X))
    return X


def nnls_gram(G, f):
    """Gram-form NNLS: argmin_{x>=0} 1/2 x'Gx - f'x for one (n, n) Gram."""
    G, f = _f64(G, 2), _f64(f, 1)
    n = f.shape[0]
    if G.shape != (n, n):
        raise ValueError(f"G {G.shape} does not match f {f.shape}")
    x = np.zeros(n)
    _call("fmf_nnls_gram", _ptr(G), _ptr(f), n, _ptr(x))
    return x


def nnls_gram_batch(G, F):
    """Batched Gram-form NNLS: G (nb, n, n), F (nb, n) -> X (nb, n), the
    tensor-NMF inner solver (utils/nmf.py)."""
    G, F = _f64(G, 3), _f64(F, 2)
    nb, n = F.shape
    if G.shape != (nb, n, n):
        raise ValueError(f"G {G.shape} does not match F {F.shape}")
    X = np.zeros((nb, n))
    _call("fmf_nnls_gram_batch", _ptr(G), _ptr(F), n, nb, _ptr(X))
    return X


if __name__ == "__main__":
    print(build(force=True))
