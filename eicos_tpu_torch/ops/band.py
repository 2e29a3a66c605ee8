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


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"band kernels run on cuda or cpu, got {t.device}")
    return False


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name}: dtype {t.dtype}, expected float64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def band_factor(Kd: torch.Tensor, Ks: torch.Tensor) -> BandFactors:
    """Block-tridiagonal LDL^T of (lanes, nb, 128, 128) f64 diagonal and
    sub-diagonal blocks (Ks[:, 0] is ignored) -> L, Dinv (lanes, nb, 128,
    128) and d (lanes, nb, 128)."""
    if _is_cpu(Kd):
        return band_factor_plain(Kd, Ks)
    lanes, nb = Kd.shape[0], Kd.shape[1]
    _check("Kd", Kd, (lanes, nb, B, B), Kd.device)
    _check("Ks", Ks, (lanes, nb, B, B), Kd.device)
    L = torch.empty_like(Kd)
    Dinv = torch.empty_like(Kd)
    d = torch.empty((lanes, nb, B), dtype=Kd.dtype, device=Kd.device)
    with torch.cuda.device(Kd.device):
        _launch(kernels.lib("band_factor").eicos_band_factor,
                Kd.data_ptr(), Ks.data_ptr(), L.data_ptr(), Dinv.data_ptr(),
                d.data_ptr(), lanes, nb, _stream(Kd))
    kernels.COUNTS["band_factor"] += 1
    return BandFactors(L=L, Dinv=Dinv, d=d)


def _check_fac(fac: BandFactors, rhs: torch.Tensor):
    lanes, nb = fac.L.shape[0], fac.L.shape[1]
    k = rhs.shape[1]
    if not 1 <= k <= KP:
        raise ValueError(f"band solve takes 1..{KP} right-hand sides, got {k}")
    _check("L", fac.L, (lanes, nb, B, B), rhs.device)
    _check("Dinv", fac.Dinv, (lanes, nb, B, B), rhs.device)
    _check("d", fac.d, (lanes, nb, B), rhs.device)
    _check("rhs", rhs, (lanes, k, nb * B), rhs.device)
    return lanes, nb, k


def band_fwd(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Forward sweep and pivot scaling: rhs (lanes, k, Dp) -> w with
    y_k = Dinv_k (x_k - L_k y_{k-1}), w = y / d."""
    if _is_cpu(rhs):
        return band_fwd_plain(fac, rhs)
    lanes, nb, k = _check_fac(fac, rhs)
    out = torch.empty_like(rhs)
    with torch.cuda.device(rhs.device):
        _launch(kernels.lib("band_solve").eicos_band_fwd,
                fac.L.data_ptr(), fac.Dinv.data_ptr(), fac.d.data_ptr(),
                rhs.data_ptr(), out.data_ptr(), lanes, nb, k, _stream(rhs))
    kernels.COUNTS["band_fwd"] += 1
    return out


def band_bwd(fac: BandFactors, w: torch.Tensor) -> torch.Tensor:
    """Backward sweep: w (lanes, k, Dp) -> z with
    z_k = Dinv_k^T (w_k - L_{k+1}^T z_{k+1})."""
    if _is_cpu(w):
        return band_bwd_plain(fac, w)
    lanes, nb, k = _check_fac(fac, w)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        _launch(kernels.lib("band_solve").eicos_band_bwd,
                fac.L.data_ptr(), fac.Dinv.data_ptr(), w.data_ptr(),
                out.data_ptr(), lanes, nb, k, _stream(w))
    kernels.COUNTS["band_bwd"] += 1
    return out


def band_solve(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """K x = rhs for rhs (lanes, k, Dp), k <= 16: the (KP, D) per-lane
    layout of ``eicos_tpu``'s ``band_solve_ds``."""
    return band_bwd(fac, band_fwd(fac, rhs))
