"""ctypes binding for the native host library (``native/eicos_native.cpp``).

The port's own loader of the C++ source that ``eicos_tpu.native`` binds,
for what this slice uses: the symbolic ordering of the banded KKT strategy
(RCM order and band statistics).  CSC interop and corpus parsing come with
the corpus loader.  The library builds at first use with the host C++
compiler into ``eicos_tpu_torch/_build/``, so the port never writes into
the JAX package's tree.

Every entry point has the same NumPy/SciPy fallback as the reference
loader.  The banded plan's permutation is only equal to the reference's
when both sides take the same path, so ``available()`` says which is live.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "eicos_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libeicos_native.so")

_lib = None


def _build() -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(_SRC):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, "-O3", "-march=native", "-fPIC", "-shared",
                        "-std=c++17", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def _try_load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64 = ctypes.c_int64
    pi = ctypes.POINTER(i64)
    lib.eicos_native_abi.restype = i64
    lib.eicos_rcm_order.restype = i64
    lib.eicos_rcm_order.argtypes = [i64, pi, pi, pi]
    lib.eicos_band_stats.argtypes = [i64, pi, pi, pi, pi, pi]
    if lib.eicos_native_abi() != 1:
        return None
    _lib = lib
    return lib


def available() -> bool:
    """True if the compiled native library is loaded."""
    return _try_load() is not None


def _pi(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def rcm_order(n: int, jc, ir) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a symmetric sparsity pattern.
    Returns perm with perm[k] = old index of the k-th new row."""
    jc, ir = _as_i64(jc), _as_i64(ir)
    lib = _try_load()
    if lib is None:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        pat = sp.csc_matrix((np.ones(len(ir)), ir, jc), shape=(n, n))
        return np.asarray(reverse_cuthill_mckee(pat, symmetric_mode=True),
                          dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    if lib.eicos_rcm_order(n, _pi(jc), _pi(ir), _pi(perm)) != 0:
        raise RuntimeError("eicos_rcm_order failed")
    return perm


def band_stats(n: int, jc, ir, iperm=None) -> tuple:
    """(bandwidth, profile) of the symmetrically permuted pattern."""
    jc, ir = _as_i64(jc), _as_i64(ir)
    lib = _try_load()
    if lib is None:
        ip = np.arange(n) if iperm is None else np.asarray(iperm)
        cols = np.repeat(np.arange(n), np.diff(jc))
        rows = np.asarray(ir)
        pc, pr_ = ip[cols], ip[rows]
        lo, hi = np.minimum(pc, pr_), np.maximum(pc, pr_)
        bw = int(np.max(hi - lo, initial=0))
        minrow = np.arange(n)
        np.minimum.at(minrow, hi, lo)
        return bw, int(np.sum(np.arange(n) - minrow))
    ipa = None if iperm is None else _as_i64(iperm)
    bw = np.zeros(1, dtype=np.int64)
    prof = np.zeros(1, dtype=np.int64)
    lib.eicos_band_stats(n, _pi(jc), _pi(ir),
                         None if ipa is None else _pi(ipa),
                         _pi(bw), _pi(prof))
    return int(bw[0]), int(prof[0])
