"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The sources compile at first use into ``functionalmf_tpu_torch/_build/``
as one shared library with a plain C interface (no PyTorch headers, so
the build takes seconds). The library's file name carries a hash of the
sources and flags: an edited source builds anew, an unchanged one loads
the existing file. A build holds the build directory's lock
(``_runtime.build_lock``): processes started together (the ranks of a
mesh) compile once and load the same file. A missing nvcc or a failed compile raises with the
compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from functionalmf_tpu_torch._runtime import build_lock

__all__ = ["NVCC_FLAGS", "build", "load_library", "declare", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

# -split-compile=0 optimises the kernels' instantiations on every core
# (about half the build time of one nvcc on an 8-core host)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
              "-Xptxas", "-v")

_lib = None
_log = ""


def _find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of functionalmf_tpu_torch are compiled from csrc/ at "
        "first use")


def build(sources=None, name="fmf_kernels") -> Path:
    """Compile ``sources`` (default csrc/*.cu) into lib<name>_<hash>.so
    unless a library of the same hash exists; return its path."""
    global _log
    sources = (sorted(_SRC_DIR.glob("*.cu")) if sources is None
               else [Path(s) for s in sources])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = _BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    with build_lock(_BUILD_DIR):
        if out.exists():          # another process built it meanwhile
            return out
        nvcc = _find_nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{_log}")
        os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler's output of the build this process ran ('' if the
    library was already built)."""
    return _log


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    if _lib is None:
        _lib = declare(ctypes.CDLL(str(build())))
    return _lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the kernels' C entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # cell, cands, bt, y, mu, sig, row_chain, row_idx, out,
    # R, G, k, C, nchains, nrows, stream, cluster, chunk, smem
    # (mu = sig = NULL: no EP)
    lib.fmf_row_ll.argtypes = [i, p, p, p, p, p, p, p, p,
                               i, i, i, i, i, i, p, i, i, i]
    lib.fmf_row_ll.restype = i
    # cell, cands, w, y, mu, sig, pair_chain, pair_col, pair_t0, out,
    # P, G, Tb, k, n, m, T, nchains, stream, cluster, chunk, smem
    lib.fmf_col_block_ll.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i, i, p, i, i, i]
    lib.fmf_col_block_ll.restype = i
    lib.fmf_error_string.argtypes = [i]
    lib.fmf_error_string.restype = ctypes.c_char_p
    return lib
