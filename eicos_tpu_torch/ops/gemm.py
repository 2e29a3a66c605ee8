"""f64 products of the dense LDL^T path: ``matmul`` (``csrc/dgemm.cu``)
and the two passes of the inverse solve, ``linv_fwd`` and ``linv_bwd``
(``csrc/linv_solve.cu``), the port of ``eicos_tpu.ops.pallas_gemm_ds``
(``matmul_ds`` / ``_bmatmul_ds`` and ``PrechunkedOperand.rmatmul``).

For a CUDA tensor each wrapper checks its inputs, launches its kernel on
the current stream and counts the launch in ``kernels.COUNTS``; for a CPU
tensor it runs the plain version beside it.  Nothing falls back from the
kernel to the plain version.

``matmul`` runs on Hopper's f64 tensor cores and takes structure flags
(a lower-only result, triangular operands) with which the dense recursion
halves its node products; the plain version gives the flags the same
meaning, so on the CPU the recursion keeps its bits.

float32 operands (``Settings.factor_dtype="float32"``) are no kernel's
business: the reference leaves its f32 products to XLA's dots outside any
Pallas kernel, and ``matmul`` sends them to ``torch.matmul`` on either
device (full f32: ``torch.backends.cuda.matmul.allow_tf32`` must be off,
as it is by default).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .band_ldl import B, KP


def _lane_strides(t: torch.Tensor):
    """(lane, row, column) strides of an (L, r, c) or shared (r, c)
    operand; a shared operand has lane stride 0."""
    if t.dim() == 2:
        return 0, t.stride(0), t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


# the kernel's flag bits (csrc/dgemm.cu)
_C_LOWER = 1
_TRI_BITS = {("a", "lower"): 2, ("a", "upper"): 4, ("b", "lower"): 8,
             ("b", "upper"): 16}


def _flags(a, b, c, c_lower: bool, a_tri, b_tri) -> int:
    """Validate the structure flags and encode them for the kernel."""
    flags = _C_LOWER if c_lower else 0
    if c_lower and c is None:
        raise ValueError("c_lower writes into a given c")
    for name, t, tri in (("a", a, a_tri), ("b", b, b_tri)):
        if tri is None:
            continue
        if tri not in ("lower", "upper"):
            raise ValueError(f"{name}_tri must be 'lower', 'upper' or None, "
                             f"got {tri!r}")
        if t.shape[-1] != t.shape[-2]:
            raise ValueError(f"{name}_tri needs a square {name}, got "
                             f"{tuple(t.shape)}")
        flags |= _TRI_BITS[name, tri]
    return flags


def matmul_plain(a, b, c=None, alpha: float = 1.0, beta: float = 0.0,
                 c_lower: bool = False, a_tri=None, b_tri=None):
    """Plain version of ``matmul``.  The triangle flags are validated and
    change nothing else: a triangular operand's zeros add exact zeros."""
    _flags(a, b, c, c_lower, a_tri, b_tri)
    p = torch.matmul(a, b)
    if alpha != 1.0:
        p = p * alpha
    if c is None:
        return p
    if c_lower:
        new = p if beta == 0.0 else (c if beta == 1.0 else c * beta) + p
        keep = torch.ones(c.shape[-2:], dtype=torch.bool,
                          device=c.device).tril()
        return c.copy_(torch.where(keep, new, c))
    if beta == 0.0:
        return c.copy_(p)
    if beta != 1.0:
        c.mul_(beta)
    return c.add_(p)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           c: Optional[torch.Tensor] = None, alpha: float = 1.0,
           beta: float = 0.0, c_lower: bool = False, a_tri=None,
           b_tri=None) -> torch.Tensor:
    """alpha a @ b + beta c in f64 (f32 operands: ``torch.matmul``, module
    doc), over a leading lane axis.

    ``a`` is (L, r, k) or a shared (r, k), ``b`` (L, k, n) or a shared
    (k, n), at least one of them per lane; either may be a strided view,
    such as a transpose, which the kernel reads in place.  Without ``c``
    the result is a new (L, r, n) tensor; with ``c``, an (L, r, n) view
    with unit stride along its rows, the result is written into ``c``
    (BLAS semantics: with ``beta = 0`` the old values of ``c`` are not
    read) and ``c`` is returned.

    Structure flags, which let the kernel skip known zeros:
    ``c_lower`` writes only the elements of ``c`` with column <= row and
    leaves the rest of ``c`` as it was (the Schur update, of which only
    the lower triangle is read again); ``a_tri`` / ``b_tri`` ("lower" or
    "upper") declare a square operand triangular, and its other triangle
    must then hold exact zeros, which the kernel does not read.  For f32
    operands only ``c_lower`` has an effect."""
    if kernels.on_cpu(a) or a.dtype == torch.float32:
        return matmul_plain(a, b, c, alpha, beta, c_lower, a_tri, b_tri)
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or (
            a.dim() == 2 and b.dim() == 2):
        raise ValueError(f"matmul takes (L, r, k) @ (L, k, n) with one side "
                         f"possibly shared, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    lanes = a.shape[0] if a.dim() == 3 else b.shape[0]
    r, k = a.shape[-2:]
    n = b.shape[-1]
    dev = a.device
    kernels.check("a", a, (lanes, r, k)[3 - a.dim():], dev, contiguous=False)
    kernels.check("b", b, (lanes, k, n)[3 - b.dim():], dev, contiguous=False)
    flags = _flags(a, b, c, c_lower, a_tri, b_tri)
    if c is None:
        c = torch.empty((lanes, r, n), dtype=a.dtype, device=dev)
        beta = 0.0
    kernels.check("c", c, (lanes, r, n), dev, contiguous=False,
                  unit_rows=True)
    a_s, b_s, c_s = _lane_strides(a), _lane_strides(b), c.stride()[:2]
    m = r
    if (b.dim() == 2 and a_s[0] == r * a_s[1] and c_s[0] == r * c_s[1]
            and not flags):
        # a shared right operand under lanes that follow one another in a
        # and c: one (lanes r, k) @ (k, n) product that reads b once
        m, lanes, a_s, c_s = lanes * r, 1, (0,) + a_s[1:], (0, c_s[1])
    with torch.cuda.device(dev):
        kernels.launch(kernels.lib("dgemm").eicos_dgemm,
                       lanes, m, n, k, float(alpha),
                       a.data_ptr(), *a_s, b.data_ptr(), *b_s,
                       float(beta), c.data_ptr(), *c_s, flags,
                       kernels.stream(a))
    kernels.count("dgemm")
    return c


# ------------------------------------------------------------ LDL^T solve

def linv_fwd_plain(Linv, d, rhs):
    """Plain version of ``linv_fwd``."""
    return torch.matmul(rhs, Linv.transpose(-1, -2)) / d[:, None, :]


def linv_bwd_plain(Linv, t):
    """Plain version of ``linv_bwd``."""
    return torch.matmul(t, Linv)


def _check_solve(Linv, vecs, d=None):
    lanes, Dp = Linv.shape[0], Linv.shape[-1]
    k = vecs.shape[1]
    if not 1 <= k <= KP:
        raise ValueError(f"the inverse solve takes 1..{KP} right-hand "
                         f"sides, got {k}")
    if Dp % B:
        raise ValueError(f"the inverse solve needs Dp a multiple of {B}, "
                         f"got {Dp}")
    kernels.check("Linv", Linv, (lanes, Dp, Dp), vecs.device)
    if d is not None:
        kernels.check("d", d, (lanes, Dp), vecs.device)
    kernels.check("rhs", vecs, (lanes, k, Dp), vecs.device)
    return lanes, Dp, k


def linv_fwd(Linv: torch.Tensor, d: torch.Tensor,
             rhs: torch.Tensor) -> torch.Tensor:
    """t = (Linv rhs) / d for rhs (L, k, Dp) in the (k, Dp)-per-lane
    layout, k <= 16; Linv (L, Dp, Dp) lower triangular, d (L, Dp)."""
    if kernels.on_cpu(rhs):
        return linv_fwd_plain(Linv, d, rhs)
    lanes, Dp, k = _check_solve(Linv, rhs, d)
    out = torch.empty_like(rhs)
    with torch.cuda.device(rhs.device):
        kernels.launch(kernels.lib("linv_solve").eicos_linv_fwd,
                       Linv.data_ptr(), d.data_ptr(), rhs.data_ptr(),
                       out.data_ptr(), lanes, Dp, k, kernels.stream(rhs))
    kernels.count("linv_fwd")
    return out


def linv_bwd(Linv: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x = Linv^T t for t (L, k, Dp), k <= 16."""
    if kernels.on_cpu(t):
        return linv_bwd_plain(Linv, t)
    lanes, Dp, k = _check_solve(Linv, t)
    out = torch.empty_like(t)
    with torch.cuda.device(t.device):
        kernels.launch(kernels.lib("linv_solve").eicos_linv_bwd,
                       Linv.data_ptr(), t.data_ptr(), out.data_ptr(), lanes,
                       Dp, k, kernels.stream(t))
    kernels.count("linv_bwd")
    return out
