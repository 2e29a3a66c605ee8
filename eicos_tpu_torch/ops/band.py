"""Wrappers of the band LDL^T kernels (``csrc/band_factor.cu``,
``csrc/band_solve.cu``): the port of ``eicos_tpu.ops.pallas_band_ds`` at
bwb = 1.

For a CUDA tensor each wrapper checks its inputs, allocates its outputs
with ``torch.empty``, launches its kernel on the current stream and counts
the launch in ``kernels.COUNTS``; a launch error raises.  For a CPU tensor
it runs the plain twin of ``ops/band_ldl.py``.  Nothing falls back from
the kernel to the twin.
"""

from __future__ import annotations

import torch

from . import kernels
from .band_ldl import (B, KP, BandFactors, band_bwd_plain,
                       band_factor_plain, band_fwd_plain)


def band_factor(Kd: torch.Tensor, Ks: torch.Tensor) -> BandFactors:
    """Block-tridiagonal LDL^T of (lanes, nb, 128, 128) f64 diagonal and
    sub-diagonal blocks (Ks[:, 0] is ignored) -> L, Dinv (lanes, nb, 128,
    128) and d (lanes, nb, 128)."""
    if kernels.on_cpu(Kd):
        return band_factor_plain(Kd, Ks)
    lanes, nb = Kd.shape[0], Kd.shape[1]
    kernels.check("Kd", Kd, (lanes, nb, B, B), Kd.device)
    kernels.check("Ks", Ks, (lanes, nb, B, B), Kd.device)
    L = torch.empty_like(Kd)
    Dinv = torch.empty_like(Kd)
    d = torch.empty((lanes, nb, B), dtype=Kd.dtype, device=Kd.device)
    with torch.cuda.device(Kd.device):
        kernels.launch(kernels.lib("band_factor").eicos_band_factor,
                       Kd.data_ptr(), Ks.data_ptr(), L.data_ptr(),
                       Dinv.data_ptr(), d.data_ptr(), lanes, nb,
                       kernels.stream(Kd))
    kernels.COUNTS["band_factor"] += 1
    return BandFactors(L=L, Dinv=Dinv, d=d)


def _check_fac(fac: BandFactors, rhs: torch.Tensor):
    lanes, nb = fac.L.shape[0], fac.L.shape[1]
    k = rhs.shape[1]
    if not 1 <= k <= KP:
        raise ValueError(f"band solve takes 1..{KP} right-hand sides, got {k}")
    kernels.check("L", fac.L, (lanes, nb, B, B), rhs.device)
    kernels.check("Dinv", fac.Dinv, (lanes, nb, B, B), rhs.device)
    kernels.check("d", fac.d, (lanes, nb, B), rhs.device)
    kernels.check("rhs", rhs, (lanes, k, nb * B), rhs.device)
    return lanes, nb, k


def band_fwd(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Forward sweep and pivot scaling: rhs (lanes, k, Dp) -> w with
    y_k = Dinv_k (x_k - L_k y_{k-1}), w = y / d."""
    if kernels.on_cpu(rhs):
        return band_fwd_plain(fac, rhs)
    lanes, nb, k = _check_fac(fac, rhs)
    out = torch.empty_like(rhs)
    with torch.cuda.device(rhs.device):
        kernels.launch(kernels.lib("band_solve").eicos_band_fwd,
                       fac.L.data_ptr(), fac.Dinv.data_ptr(), fac.d.data_ptr(),
                       rhs.data_ptr(), out.data_ptr(), lanes, nb, k,
                       kernels.stream(rhs))
    kernels.COUNTS["band_fwd"] += 1
    return out


def band_bwd(fac: BandFactors, w: torch.Tensor) -> torch.Tensor:
    """Backward sweep: w (lanes, k, Dp) -> z with
    z_k = Dinv_k^T (w_k - L_{k+1}^T z_{k+1})."""
    if kernels.on_cpu(w):
        return band_bwd_plain(fac, w)
    lanes, nb, k = _check_fac(fac, w)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        kernels.launch(kernels.lib("band_solve").eicos_band_bwd,
                       fac.L.data_ptr(), fac.Dinv.data_ptr(), w.data_ptr(),
                       out.data_ptr(), lanes, nb, k, kernels.stream(w))
    kernels.COUNTS["band_bwd"] += 1
    return out


def band_solve(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """K x = rhs for rhs (lanes, k, Dp), k <= 16: the (KP, D) per-lane
    layout of ``eicos_tpu``'s ``band_solve_ds``."""
    return band_bwd(fac, band_fwd(fac, rhs))
