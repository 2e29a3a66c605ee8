"""Block-banded LDL^T factor and solves in plain torch f64: block
bandwidth 1 (``band_factor_plain`` ...) and any block bandwidth
(``band_factor_bw_plain`` ...).

This module is the plain twin of the CUDA kernels in ``ops/band.py``: it
computes the same function, and runs wherever a tensor lies on the CPU (the
tests, and the solver on ``device="cpu"``).  It follows
``eicos_tpu.ops.band_ldl.band_ldl_factor`` / ``band_ldl_solve``, with the
leaf of ``eicos_tpu.ops.ldl`` (``_unblocked_ldl``: unpivoted rank-1
elimination, pivots clamped at +-1e-150; ``_unit_lower_inv``:
Newton-Schulz doubling), written over an explicit leading lane axis; the
reference's ``lax.scan`` with ring carries is a Python loop over block
rows here.

Factor of one lane, block rows k = 0..nb-1 (Ks[0] is never read):

    L_k    = Ks_k Dinv_{k-1}^T / d_{k-1}        (L_0 = 0)
    M      = Kd_k - (L_k d_{k-1}) L_k^T
    M      = Lkk diag(d_k) Lkk^T                 (unpivoted leaf)
    Dinv_k = Lkk^{-1}

Solve: forward  y_k = Dinv_k (x_k - L_k y_{k-1}),  w = y / d;
       backward z_k = Dinv_k^T (w_k - L_{k+1}^T z_{k+1}).

At block bandwidth bw, with L[k, k-j] stored at ``L[:, k, j-1]`` and terms
that reach above block row 0 left out (the reference's ring starts them at
L = 0, Dinv = I, d = 1, which contributes exact zeros):

    for j = bw..1:  S = Ksubs[k, j-1]
                        - sum_{q=j+1..bw} (L[k,k-q] d_{k-q}) L[k-j,k-q]^T
                    L[k,k-j] = S Dinv_{k-j}^T / d_{k-j}
    M = Kd_k - sum_{q=1..bw} (L[k,k-q] d_{k-q}) L[k,k-q]^T, then the leaf

    forward  y_k = Dinv_k (x_k - sum_j L[k,k-j] y_{k-j}),  w = y / d
    backward z_k = Dinv_k^T (w_k - sum_j L[k+j,k]^T z_{k+j})
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

B = 128       # band block size
KP = 16       # most right-hand sides one band solve takes


class BandFactors(NamedTuple):
    # (lanes, nb, B, B) sub-diagonal blocks L[k, k-1] at block bandwidth 1;
    # (lanes, nb, bw, B, B) with L[:, k, j-1] = L[k, k-j] from the bw forms
    L: torch.Tensor
    Dinv: torch.Tensor   # (lanes, nb, B, B) inverses of the unit-lower leaves
    d: torch.Tensor      # (lanes, nb, B) pivots


def pad_to_block(D: int, block: int = 128) -> int:
    return max(block, ((D + block - 1) // block) * block)


def band_blocks(bw: int, block: int = 128) -> int:
    """Block bandwidth covering scalar bandwidth ``bw``."""
    return int(np.ceil((bw + 1) / block))


def _unblocked_ldl(M: torch.Tensor):
    """LDL^T of (lanes, B, B) symmetric blocks -> (L unit-lower, d).

    Pivots are clamped away from zero at +-1e-150 (the reference's f64
    clamp; 1e-20 for f32 blocks): a clamped pivot yields an inaccurate
    direction that iterative refinement absorbs, where 0 would poison the
    solve with inf/NaN."""
    Bn = M.shape[-1]
    M = M.clone()
    L = torch.zeros_like(M)
    d = torch.zeros(M.shape[:-1], dtype=M.dtype, device=M.device)
    tiny = torch.tensor(1e-20 if M.dtype == torch.float32 else 1e-150,
                        dtype=M.dtype, device=M.device)
    for j in range(Bn):
        dj = M[:, j, j]
        dj = torch.where(dj.abs() < tiny, torch.where(dj < 0, -tiny, tiny),
                         dj)
        l = M[:, j + 1:, j] / dj[:, None]
        # rows/cols <= j see l = 0 in the reference's full-matrix update,
        # which leaves them exactly unchanged
        M[:, j + 1:, j + 1:] -= (dj[:, None, None] * l[:, :, None]
                                 ) * l[:, None, :]
        L[:, j + 1:, j] = l
        d[:, j] = dj
    L = L + torch.eye(Bn, dtype=M.dtype, device=M.device)
    return L, d


def _unit_lower_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of unit lower-triangular (lanes, B, B) blocks by Newton-Schulz
    doubling: X <- X (2I - L X) from X = 2I - L, exact after ceil(log2 B)
    steps up to rounding."""
    Bn = L.shape[-1]
    steps = max(1, int(np.ceil(np.log2(Bn))))
    eye2 = 2.0 * torch.eye(Bn, dtype=L.dtype, device=L.device)
    X = eye2 - L
    for _ in range(steps):
        X = X @ (eye2 - L @ X)
    return X


def band_factor_plain(Kd: torch.Tensor, Ks: torch.Tensor) -> BandFactors:
    """Plain twin of the ``band_factor`` kernel: (lanes, nb, B, B) f64
    diagonal and sub-diagonal blocks -> ``BandFactors``."""
    lanes, nb = Kd.shape[0], Kd.shape[1]
    Ls, Dinvs, ds = [], [], []
    for k in range(nb):
        if k == 0:
            Lk = torch.zeros_like(Kd[:, 0])
            M = Kd[:, 0]
        else:
            Lk = (Ks[:, k] @ Dinvs[-1].transpose(-1, -2)
                  ) / ds[-1][:, None, :]
            M = Kd[:, k] - (Lk * ds[-1][:, None, :]) @ Lk.transpose(-1, -2)
        Lkk, dk = _unblocked_ldl(M)
        Ls.append(Lk)
        Dinvs.append(_unit_lower_inv(Lkk))
        ds.append(dk)
    return BandFactors(L=torch.stack(Ls, 1), Dinv=torch.stack(Dinvs, 1),
                       d=torch.stack(ds, 1))


def band_fwd_plain(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``band_fwd``: rhs (lanes, k, Dp) -> w (lanes, k, Dp)
    with y_k = Dinv_k (x_k - L_k y_{k-1}) and w = y / d."""
    nb = fac.L.shape[1]
    out = torch.empty_like(rhs)
    y = None
    for b in range(nb):
        acc = rhs[:, :, b * B:(b + 1) * B].transpose(-1, -2)
        if b:
            acc = acc - fac.L[:, b] @ y
        y = fac.Dinv[:, b] @ acc
        out[:, :, b * B:(b + 1) * B] = (y / fac.d[:, b, :, None]
                                        ).transpose(-1, -2)
    return out


def band_bwd_plain(fac: BandFactors, w: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``band_bwd``: w (lanes, k, Dp) -> z (lanes, k, Dp)
    with z_k = Dinv_k^T (w_k - L_{k+1}^T z_{k+1}), bottom block first."""
    nb = fac.L.shape[1]
    out = torch.empty_like(w)
    z = None
    for b in range(nb - 1, -1, -1):
        acc = w[:, :, b * B:(b + 1) * B].transpose(-1, -2)
        if b < nb - 1:
            acc = acc - fac.L[:, b + 1].transpose(-1, -2) @ z
        z = fac.Dinv[:, b].transpose(-1, -2) @ acc
        out[:, :, b * B:(b + 1) * B] = z.transpose(-1, -2)
    return out


def band_solve_plain(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``band_solve``: K x = rhs for rhs (lanes, k, Dp), the
    layout of ``eicos_tpu``'s ``band_solve_ds`` (KP, D) per lane."""
    return band_bwd_plain(fac, band_fwd_plain(fac, rhs))


def band_factor_bw_plain(Kd: torch.Tensor, Ksubs: torch.Tensor) -> BandFactors:
    """Plain twin of the ``band_factor_bw`` kernel: f64 diagonal blocks
    (lanes, nb, B, B) and sub-diagonal blocks (lanes, nb, bw, B, B) with
    ``Ksubs[:, k, j-1] = K[k, k-j]`` -> ``BandFactors`` with L of the same
    5-d layout.  ``Ksubs[:, k, j-1]`` for k < j is never read, and
    ``L[:, k, j-1]`` is zero there."""
    nb, bw = Ksubs.shape[1], Ksubs.shape[2]
    rows, Dinvs, ds = [], [], []
    for k in range(nb):
        row = [None] * bw
        for j in range(bw, 0, -1):
            if k < j:
                row[j - 1] = torch.zeros_like(Kd[:, 0])
                continue
            S = Ksubs[:, k, j - 1]
            for q in range(j + 1, min(bw, k) + 1):
                S = S - (row[q - 1] * ds[k - q][:, None, :]
                         ) @ rows[k - j][q - j - 1].transpose(-1, -2)
            row[j - 1] = (S @ Dinvs[k - j].transpose(-1, -2)
                          ) / ds[k - j][:, None, :]
        M = Kd[:, k]
        for q in range(1, min(bw, k) + 1):
            M = M - (row[q - 1] * ds[k - q][:, None, :]
                     ) @ row[q - 1].transpose(-1, -2)
        Lkk, dk = _unblocked_ldl(M)
        rows.append(row)
        Dinvs.append(_unit_lower_inv(Lkk))
        ds.append(dk)
    return BandFactors(L=torch.stack([torch.stack(r, 1) for r in rows], 1),
                       Dinv=torch.stack(Dinvs, 1), d=torch.stack(ds, 1))


def band_fwd_bw_plain(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``band_fwd_bw``: rhs (lanes, k, Dp) -> w (lanes, k, Dp)
    with y_k = Dinv_k (x_k - sum_j L[k,k-j] y_{k-j}) and w = y / d."""
    nb, bw = fac.L.shape[1], fac.L.shape[2]
    out = torch.empty_like(rhs)
    ys = []
    for b in range(nb):
        acc = rhs[:, :, b * B:(b + 1) * B].transpose(-1, -2)
        for j in range(1, min(bw, b) + 1):
            acc = acc - fac.L[:, b, j - 1] @ ys[b - j]
        ys.append(fac.Dinv[:, b] @ acc)
        out[:, :, b * B:(b + 1) * B] = (ys[b] / fac.d[:, b, :, None]
                                        ).transpose(-1, -2)
    return out


def band_bwd_bw_plain(fac: BandFactors, w: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``band_bwd_bw``: w (lanes, k, Dp) -> z (lanes, k, Dp)
    with z_k = Dinv_k^T (w_k - sum_j L[k+j,k]^T z_{k+j}), bottom block
    first."""
    nb, bw = fac.L.shape[1], fac.L.shape[2]
    out = torch.empty_like(w)
    zs = [None] * nb
    for b in range(nb - 1, -1, -1):
        acc = w[:, :, b * B:(b + 1) * B].transpose(-1, -2)
        for j in range(1, min(bw, nb - 1 - b) + 1):
            acc = acc - fac.L[:, b + j, j - 1].transpose(-1, -2) @ zs[b + j]
        zs[b] = fac.Dinv[:, b].transpose(-1, -2) @ acc
        out[:, :, b * B:(b + 1) * B] = zs[b].transpose(-1, -2)
    return out
