"""Wrappers of the band LDL^T kernels: the port of
``eicos_tpu.ops.pallas_band_ds`` at block bandwidths 1..6
(``csrc/band_factor_bw.cu``, ``csrc/band_solve_bw.cu``), and the dispatch
between them and the scan of ``ops/band_ldl.py``.

``band_factor``, ``band_fwd``, ``band_bwd`` and ``band_solve`` dispatch on
the layout and the type: sub-diagonal blocks ``Ks`` (lanes, nb, 128, 128)
are block bandwidth 1; (lanes, nb, bw, 128, 128) with ``Ks[:, k, j-1] =
K[k, k-j]`` is block bandwidth bw.  Where the reference's band kernels do
not run, a band wider than 6 or an f32 factor (both in the 5-d layout,
which ``kkt`` gathers for them), these four run the scan
(``band_ldl_factor`` / ``band_ldl_solve``: batched ``torch.matmul``
products, in ``gemm_dtype`` when it is given, and the leaf kernel
``ops/leaf.leaf_ldl`` on a CUDA tensor), as the reference runs its XLA
scan there.  Otherwise, on the card every bandwidth runs the wide kernels,
the 4-d layout as its ``[:, :, None]`` view, and ``gemm_dtype`` is not
read (the kernels compute in f64, as the reference's do); the factor's
``L`` has the layout of the ``Ks`` it came from.

The kernel wrappers ``band_factor_bw``, ``band_fwd_bw`` and ``band_bwd_bw``
take block bandwidths 1..6 (the reference's own bound) and raise outside.
For a CUDA tensor each checks its inputs, allocates its outputs with
``torch.empty``, launches its kernel on the current stream and counts the
launch in ``kernels.COUNTS``; a launch error raises.  For a CPU tensor it
runs the plain twin of ``ops/band_ldl.py`` (the bandwidth-1 twins for the
4-d layout).  Nothing falls back from a kernel to a twin or to the scan.
"""

from __future__ import annotations

import torch

from . import kernels
from .band_ldl import (B, KP, BandFactors, band_bwd_bw_plain, band_bwd_plain,
                       band_factor_bw_plain, band_factor_plain,
                       band_fwd_bw_plain, band_fwd_plain, band_ldl_bwd,
                       band_ldl_factor, band_ldl_fwd)

BW_MAX = 6    # widest block band of the wide kernels


def scan(Ks: torch.Tensor, dtype: torch.dtype) -> bool:
    """True where the scan runs instead of the kernels: 5-d sub-diagonal
    blocks (or a factor's ``L``) ``Ks`` wider than ``BW_MAX``, or in
    another type than f64."""
    return Ks.dim() == 5 and (dtype != torch.float64 or Ks.shape[2] > BW_MAX)


def _wide(fac: BandFactors) -> BandFactors:
    """The factor in the 5-d layout (a view of the 4-d one)."""
    return fac if fac.L.dim() == 5 else fac._replace(L=fac.L[:, :, None])


def band_factor(Kd: torch.Tensor, Ks: torch.Tensor,
                gemm_dtype=None) -> BandFactors:
    """Block-banded LDL^T of (lanes, nb, 128, 128) diagonal blocks and the
    sub-diagonal blocks ``Ks`` in either layout (f32 in the 5-d one) -> L
    (as ``Ks``), Dinv (lanes, nb, 128, 128) and d (lanes, nb, 128), in the
    type of ``Kd``.  ``Ks[:, 0]`` (``Ks[:, k, j-1]`` for k < j) is ignored.
    ``gemm_dtype`` is the scan's product type (module doc)."""
    if scan(Ks, Kd.dtype):
        return band_ldl_factor(Kd, Ks, gemm_dtype)
    if Ks.dim() == 5:
        return band_factor_bw(Kd, Ks)
    if kernels.on_cpu(Kd):
        return band_factor_plain(Kd, Ks)
    fac = band_factor_bw(Kd, Ks[:, :, None])
    return fac._replace(L=fac.L[:, :, 0])


def _check_bw(bw: int) -> None:
    if not 1 <= bw <= BW_MAX:
        raise ValueError(f"block bandwidth {bw}: the wide band kernels take "
                         f"1..{BW_MAX}")


def band_factor_bw(Kd: torch.Tensor, Ksubs: torch.Tensor) -> BandFactors:
    """The wide band factor: ``Kd`` (lanes, nb, 128, 128), ``Ksubs``
    (lanes, nb, bw, 128, 128) f64 with ``Ksubs[:, k, j-1] = K[k, k-j]``,
    1 <= bw <= 6 -> L (layout of ``Ksubs``), Dinv, d.  ``Ksubs[:, k, j-1]``
    for k < j (a block left of block column 0) is ignored whatever it
    holds, and ``L[:, k, j-1]`` is written as zeros there, so the sweeps
    need no test."""
    bw = Ksubs.shape[2]
    _check_bw(bw)
    if kernels.on_cpu(Kd):
        return band_factor_bw_plain(Kd, Ksubs)
    lanes, nb = Kd.shape[0], Kd.shape[1]
    kernels.check("Kd", Kd, (lanes, nb, B, B), Kd.device)
    kernels.check("Ksubs", Ksubs, (lanes, nb, bw, B, B), Kd.device)
    L = torch.empty_like(Ksubs)
    Dinv = torch.empty_like(Kd)
    d = torch.empty((lanes, nb, B), dtype=Kd.dtype, device=Kd.device)
    with torch.cuda.device(Kd.device):
        kernels.launch(kernels.lib("band_factor_bw").eicos_band_factor_bw,
                       Kd.data_ptr(), Ksubs.data_ptr(), L.data_ptr(),
                       Dinv.data_ptr(), d.data_ptr(), lanes, nb, bw,
                       kernels.stream(Kd))
    kernels.COUNTS["band_factor_bw"] += 1
    return BandFactors(L=L, Dinv=Dinv, d=d)


def _check_fac(fac: BandFactors, rhs: torch.Tensor):
    lanes, nb = fac.L.shape[0], fac.L.shape[1]
    k = rhs.shape[1]
    if not 1 <= k <= KP:
        raise ValueError(f"band solve takes 1..{KP} right-hand sides, got {k}")
    kernels.check("L", fac.L, (lanes, nb, *fac.L.shape[2:-2], B, B),
                  rhs.device)
    kernels.check("Dinv", fac.Dinv, (lanes, nb, B, B), rhs.device)
    kernels.check("d", fac.d, (lanes, nb, B), rhs.device)
    kernels.check("rhs", rhs, (lanes, k, nb * B), rhs.device)
    return lanes, nb, k


def band_fwd(fac: BandFactors, rhs: torch.Tensor,
             gemm_dtype=None) -> torch.Tensor:
    """Forward sweep and pivot scaling: rhs (lanes, k, Dp) -> w with
    y_k = Dinv_k (x_k - sum_j L[k,k-j] y_{k-j}), w = y / d."""
    if scan(fac.L, fac.d.dtype):
        return band_ldl_fwd(fac, rhs, gemm_dtype)
    if fac.L.dim() == 5:
        return band_fwd_bw(fac, rhs)
    if kernels.on_cpu(rhs):
        return band_fwd_plain(fac, rhs)
    return band_fwd_bw(_wide(fac), rhs)


def band_bwd(fac: BandFactors, w: torch.Tensor,
             gemm_dtype=None) -> torch.Tensor:
    """Backward sweep: w (lanes, k, Dp) -> z with
    z_k = Dinv_k^T (w_k - sum_j L[k+j,k]^T z_{k+j})."""
    if scan(fac.L, fac.d.dtype):
        return band_ldl_bwd(fac, w, gemm_dtype)
    if fac.L.dim() == 5:
        return band_bwd_bw(fac, w)
    if kernels.on_cpu(w):
        return band_bwd_plain(fac, w)
    return band_bwd_bw(_wide(fac), w)


def band_fwd_bw(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """The wide forward sweep: ``fac.L`` (lanes, nb, bw, 128, 128), rhs
    (lanes, k, Dp), k <= 16 -> w."""
    bw = fac.L.shape[2]
    _check_bw(bw)
    if kernels.on_cpu(rhs):
        return band_fwd_bw_plain(fac, rhs)
    lanes, nb, k = _check_fac(fac, rhs)
    out = torch.empty_like(rhs)
    with torch.cuda.device(rhs.device):
        kernels.launch(kernels.lib("band_solve_bw").eicos_band_fwd_bw,
                       fac.L.data_ptr(), fac.Dinv.data_ptr(), fac.d.data_ptr(),
                       rhs.data_ptr(), out.data_ptr(), lanes, nb, bw, k,
                       kernels.stream(rhs))
    kernels.COUNTS["band_fwd_bw"] += 1
    return out


def band_bwd_bw(fac: BandFactors, w: torch.Tensor) -> torch.Tensor:
    """The wide backward sweep: w (lanes, k, Dp) -> z."""
    bw = fac.L.shape[2]
    _check_bw(bw)
    if kernels.on_cpu(w):
        return band_bwd_bw_plain(fac, w)
    lanes, nb, k = _check_fac(fac, w)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        kernels.launch(kernels.lib("band_solve_bw").eicos_band_bwd_bw,
                       fac.L.data_ptr(), fac.Dinv.data_ptr(), w.data_ptr(),
                       out.data_ptr(), lanes, nb, bw, k, kernels.stream(w))
    kernels.COUNTS["band_bwd_bw"] += 1
    return out


def band_solve(fac: BandFactors, rhs: torch.Tensor,
               gemm_dtype=None) -> torch.Tensor:
    """K x = rhs for rhs (lanes, k, Dp), k <= 16: the (KP, D) per-lane
    layout of ``eicos_tpu``'s ``band_solve_ds``."""
    return band_bwd(fac, band_fwd(fac, rhs, gemm_dtype), gemm_dtype)
