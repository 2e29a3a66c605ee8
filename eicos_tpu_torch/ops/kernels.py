"""Build and bind the port's CUDA kernels (``eicos_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface under ``eicos_tpu_torch/_build/``, at first use; all sources
build at once, one ``nvcc`` process each.  A library's file name carries a
hash of its source and flags, so an edited source rebuilds.  The libraries
are bound with ``ctypes``: pointers and the stream pass as ``c_void_p``.

``COUNTS`` holds one plain integer per kernel: its wrapper (``band.py``,
``leaf.py``, ``gemm.py``, ``dense.py``, ``spmv.py``, ``soc.py``) adds one
through ``count`` where it launches the kernel, and nowhere else, so a run
can show that the main path went through the kernels.  ``loop_cond`` (S2,
``graph_loop.py``) launches only on the card, as nodes of a composed
program graph: each node counts its launches on the device, and
``graphs.settle`` adds them here, with ``loop_stamp``'s two a traced
composed launch, counted on the device likewise (its calibration
launches are not counted).  ``count`` and ``lib`` hold a lock: a sharded
solve launches from one host thread per device.  Inside
``recording()`` a thread's counts go to a dict of their own instead:
``graphs`` records what a captured segment launches and adds it to
``COUNTS`` with ``add_counts`` at every replay, so the counts of a graphed
solve are those of the same solve run eagerly.  The wrappers share the
dispatch rule below: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> (source file, {C symbol: ctypes argtypes}[, restype]);
# the restype is ``c_int``, a CUDA error code, unless given
_P, _I = ctypes.c_void_p, ctypes.c_int
_LL, _D = ctypes.c_longlong, ctypes.c_double
_ULL, _PP = ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_void_p)
LIBS = {
    "band_factor_bw": ("band_factor_bw.cu",
                       {"eicos_band_factor_bw": [_P] * 5 + [_I, _I, _I, _P]}),
    "band_factor_cluster": ("band_factor_cluster.cu",
                            {"eicos_band_factor_cluster": [_P] * 5
                             + [_I, _I, _I, _P],
                             "eicos_band_factor_clusters":
                                 [_I, ctypes.POINTER(_I)]}),
    "band_solve_bw": ("band_solve_bw.cu",
                      {"eicos_band_fwd_bw": [_P] * 5 + [_I] * 5 + [_P],
                       "eicos_band_bwd_bw": [_P] * 4 + [_I] * 5 + [_P],
                       "eicos_band_sweep_smem": [ctypes.POINTER(_I)],
                       "eicos_band_sweep_clusters": [_I] * 4
                       + [ctypes.POINTER(_I)]}),
    "leaf_ldl": ("leaf_ldl.cu",
                 {"eicos_leaf_ldl": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL,
                                     _I, _P]}),
    "dgemm": ("dgemm.cu",
              {"eicos_dgemm": [_I] * 4 + [_D, _P, _LL, _LL, _LL,
                                          _P, _LL, _LL, _LL,
                                          _D, _P, _LL, _LL, _I, _P]}),
    "linv_solve": ("linv_solve.cu",
                   {"eicos_linv_fwd": [_P] * 4 + [_I, _I, _I, _P],
                    "eicos_linv_bwd": [_P] * 3 + [_I, _I, _I, _P]}),
    "leaf_ldl_f32": ("leaf_ldl_f32.cu",
                     {"eicos_leaf_ldl_f32": [_P, _LL, _LL, _P, _LL, _LL, _P,
                                             _LL, _I, _P]}),
    "dense_pack": ("dense_pack.cu",
                   {"eicos_dense_pack": [_P, _P, _I, _I, _P]}),
    "dense_solve": ("dense_solve.cu",
                    {"eicos_dense_fwd": [_P] * 5 + [_I, _I, _I, _P],
                     "eicos_dense_bwd": [_P] * 4 + [_I, _I, _I, _P]}),
    "spmv": ("spmv.cu",
             {"eicos_spmv": [_P, _P]}),
    "cones": ("cones.cu",
              {"eicos_cone_scalings": [_P, _LL, _P, _LL, _P] + [_I] * 5
               + [_P] * 11,
               "eicos_cone_eig": [_P] * 5 + [_LL] + [_I] * 5 + [_D] * 2
               + [_P] * 5,
               "eicos_cone_rotate": [_P, _P, _LL, _LL, _P] + [_I] * 6
               + [_P] * 2,
               "eicos_cone_line_search": [_P, _LL] * 7 + [_P] + [_I] * 4
               + [_D] * 4 + [_P] * 2}),
    # the program graph and S2 (``graph_loop.py``): every function returns
    # a null pointer or an error message
    "graph_loop": ("graph_loop.cu",
                   {"eicos_loop_create": [_I, _PP],
                    "eicos_loop_handle": [_P, ctypes.POINTER(_ULL)],
                    "eicos_loop_while": [_P, _P, _ULL, _PP, _PP],
                    "eicos_loop_child": [_P, _P, _P, _PP],
                    "eicos_loop_cond": [_P, _P, _ULL, _P, _I, _P, _P, _P,
                                        _PP],
                    "eicos_loop_stamp": [_P, _P, _P, _I, _P, _I, _PP],
                    "eicos_loop_stamp_now": [_I, _P, _P],
                    "eicos_loop_stamp_on": [_I, _P, _I, _P, _I, _P],
                    "eicos_loop_check": [_P],
                    "eicos_loop_instantiate": [_I, _P, _P, _PP],
                    "eicos_loop_launch": [_I, _P, _P],
                    "eicos_loop_destroy": [_P, _P]},
                   ctypes.c_char_p),
}

COUNTS = {"band_factor_bw": 0, "band_factor_cluster": 0, "band_fwd_bw": 0,
          "band_bwd_bw": 0,
          "leaf_ldl": 0, "dgemm": 0, "linv_fwd": 0, "linv_bwd": 0,
          "leaf_ldl_f32": 0, "dense_pack": 0, "dense_fwd": 0, "dense_bwd": 0,
          "spmv": 0, "loop_cond": 0, "loop_stamp": 0, "cone_scalings": 0,
          "cone_eig": 0, "cone_rotate": 0, "cone_line_search": 0}
BUILD_LOG: dict = {}      # library name -> nvcc's output (ptxas -v report)

_loaded: dict = {}
_LOCK = threading.RLock()
_TLS = threading.local()       # ``rec``: this thread's recording, or None


def reset_counts() -> None:
    with _LOCK:
        for name in COUNTS:
            COUNTS[name] = 0


def count(name: str) -> None:
    """One launch of kernel ``name``: into this thread's recording where
    one is open, else into ``COUNTS``."""
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _LOCK:
        COUNTS[name] += 1


def add_counts(delta: dict) -> None:
    """Add a recording's counts to ``COUNTS``."""
    with _LOCK:
        for name, n in delta.items():
            COUNTS[name] += n


@contextlib.contextmanager
def recording():
    """Inside the block, this thread's ``count`` calls add to the yielded
    dict instead of ``COUNTS``."""
    prev = getattr(_TLS, "rec", None)
    _TLS.rec = rec = {}
    try:
        yield rec
    finally:
        _TLS.rec = prev


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "eicos_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return path


def lib_path(name: str) -> str:
    """The library's build path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [LIBS[name][0]] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build(names=None) -> None:
    """Compile every library that is not built yet, all in parallel.
    Raises RuntimeError with nvcc's output if one fails."""
    names = list(LIBS) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, LIBS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(BUILD_LOG[n] for n in failed))


def lib(name: str):
    """The loaded ctypes library ``name``, built first if needed."""
    if name in _loaded:
        return _loaded[name]
    with _LOCK:
        if name not in _loaded:
            build()
            cdll = ctypes.CDLL(lib_path(name))
            _, symbols, *restype = LIBS[name]
            for sym, argtypes in symbols.items():
                fn = getattr(cdll, sym)
                fn.argtypes = argtypes
                fn.restype = restype[0] if restype else ctypes.c_int
            _loaded[name] = cdll
    return _loaded[name]


# ------------------------------------------------ shared by the wrappers

def on_cpu(t) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"kernels run on cuda or cpu, got {t.device}")
    return False


def check(name: str, t, shape: tuple, device, contiguous: bool = True,
          unit_rows: bool = False, dtype=None) -> None:
    """Raise ValueError unless ``t`` is of ``dtype`` (f64 unless given) on
    ``device`` with ``shape`` and, with ``contiguous``, contiguous and
    16-byte aligned; otherwise any strides, or with ``unit_rows`` unit
    stride along the last axis."""
    import torch

    dtype = torch.float64 if dtype is None else dtype
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if contiguous:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
    elif unit_rows and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must have unit stride")


def launch(fn, *args) -> None:
    """Call a kernel's C entry point and raise on a launch error."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
