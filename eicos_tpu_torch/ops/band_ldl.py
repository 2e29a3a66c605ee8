"""Block-banded LDL^T factor and solves as loops of torch products:
block bandwidth 1 (``band_factor_plain`` ...) and any block bandwidth
(the scan, ``band_ldl_factor`` / ``band_ldl_solve``, and its f64 twins
``band_factor_bw_plain`` ...).

The scan is the port of ``eicos_tpu.ops.band_ldl.band_ldl_factor`` /
``band_ldl_solve``, the path the reference takes where its band kernels do
not (block bandwidth above 6, an f32 factor): the reference's ``lax.scan``
with ring carries is a Python loop over block rows here, written over an
explicit leading lane axis, the products ``torch.matmul`` (XLA dots
outside any kernel in the reference too), in ``gemm_dtype`` when it is
given, and each diagonal leaf through ``ops/leaf.leaf_ldl``: the leaf
kernel on a CUDA tensor, the plain leaf on a CPU one.  The up to bw
corrections of one block are one product batched over the lanes and the
blocks, then summed, where the reference subtracts them one by one: a
block row costs O(bw) launches, not O(bw^2), and a solve's launches, not
its arithmetic, bound the scan on the card.

The ``*_plain`` functions are the plain twins of the CUDA kernels in
``ops/band.py``: the same function, in f64, with the plain leaf of
``eicos_tpu.ops.ldl`` (``_unblocked_ldl``: unpivoted rank-1 elimination,
pivots clamped at +-1e-150; ``_unit_lower_inv``: Newton-Schulz doubling)
on every device.  They run wherever a tensor lies on the CPU (the tests,
and the solver on ``device="cpu"``), and ``chip_smoke.py`` holds the
kernels against them on the card.

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


def _product(dtype, gemm_dtype):
    """The scan's block product: ``a @ b`` in ``gemm_dtype`` (None: in
    ``dtype``), cast back to ``dtype``."""
    gdt = dtype if gemm_dtype is None else gemm_dtype
    return lambda a, b: (a.to(gdt) @ b.to(gdt)).to(dtype)


def _corr(mm, A, X):
    """sum_i A[:, i] X[:, i] over the second axis: one product batched over
    the lanes and i, then the sum; a single pair is the product alone (the
    same bits, two launches fewer)."""
    if A.shape[1] == 1:
        return mm(A[:, 0], X[:, 0])
    return mm(A, X).sum(1)


def band_ldl_factor(Kd: torch.Tensor, Ksubs: torch.Tensor, gemm_dtype=None,
                    leaf=None) -> BandFactors:
    """The scan factor (``eicos_tpu.ops.band_ldl.band_ldl_factor``) at any
    block bandwidth: diagonal blocks (lanes, nb, B, B) and sub-diagonal
    blocks (lanes, nb, bw, B, B) with ``Ksubs[:, k, j-1] = K[k, k-j]``, f64
    or f32 -> ``BandFactors`` with L of the same 5-d layout, in the type of
    ``Kd``.  Block rows in the reference's order: the left blocks (the
    leftmost first), the diagonal Schur update, then the leaf.  The
    corrections of one block, sum_q (L[k,k-q] d_{k-q}) L[k-j,k-q]^T, are
    one ``torch.matmul`` batched over the lanes and q and then summed over
    q (the reference subtracts them one by one: the same sum in another
    order), in ``gemm_dtype`` when it is given,
    ``(a.to(gdt) @ b.to(gdt)).to(dtype)``.  ``leaf`` factors the (lanes, B,
    B) Schur blocks into (Linv, d): by default ``ops/leaf.leaf_ldl``, which
    launches the leaf kernel of the blocks' type on a CUDA tensor and runs
    the plain leaf on a CPU one.  ``Ksubs[:, k, j-1]`` for k < j is never
    read, and ``L[:, k, j-1]`` is zero there."""
    if leaf is None:
        from .leaf import leaf_ldl as leaf
    mm = _product(Kd.dtype, gemm_dtype)
    lanes, nb, bw = Ksubs.shape[:3]
    L = Kd.new_zeros(lanes, nb, bw, B, B)
    Dinv = torch.empty_like(Kd)
    d = Kd.new_empty(lanes, nb, B)
    # rd[:, q-1] = L[k,k-q] d_{k-q} of the current row; zero for q > k
    rd = Kd.new_zeros(lanes, bw, B, B)
    for k in range(nb):
        kq = min(bw, k)
        for j in range(kq, 0, -1):
            S = Ksubs[:, k, j - 1]
            if j < kq:          # q = j+1..kq
                S = S - _corr(mm, rd[:, j:kq],
                              L[:, k - j, :kq - j].transpose(-1, -2))
            dj = d[:, k - j][:, None, :]
            torch.div(mm(S, Dinv[:, k - j].transpose(-1, -2)), dj,
                      out=L[:, k, j - 1])
            torch.mul(L[:, k, j - 1], dj, out=rd[:, j - 1])
        M = Kd[:, k]
        if kq:
            M = M - _corr(mm, rd[:, :kq], L[:, k, :kq].transpose(-1, -2))
        Dinv[:, k], d[:, k] = leaf(M)
    return BandFactors(L=L, Dinv=Dinv, d=d)


def band_ldl_fwd(fac: BandFactors, rhs: torch.Tensor,
                 gemm_dtype=None) -> torch.Tensor:
    """The scan's forward sweep and pivot scaling at any block bandwidth
    (``eicos_tpu.ops.band_ldl.band_ldl_solve``, first half): rhs (lanes,
    k, Dp) -> w with y_k = Dinv_k (x_k - sum_j L[k,k-j] y_{k-j}), w = y / d;
    the sum over j one product batched over the lanes and j, in
    ``gemm_dtype`` when it is given."""
    mm = _product(rhs.dtype, gemm_dtype)
    lanes, k = rhs.shape[:2]
    nb, bw = fac.L.shape[1], fac.L.shape[2]
    out = torch.empty_like(rhs)
    Y = rhs.new_empty(lanes, nb, B, k)
    for b in range(nb):
        acc = rhs[:, :, b * B:(b + 1) * B].transpose(-1, -2)
        kq = min(bw, b)
        if kq:                  # y_{b-j}, j = 1..kq
            ys = Y[:, b - kq:b]
            acc = acc - _corr(mm, fac.L[:, b, :kq],
                              ys.flip(1) if kq > 1 else ys)
        Y[:, b] = mm(fac.Dinv[:, b], acc)
        out[:, :, b * B:(b + 1) * B] = (Y[:, b] / fac.d[:, b, :, None]
                                        ).transpose(-1, -2)
    return out


def band_ldl_bwd(fac: BandFactors, w: torch.Tensor,
                 gemm_dtype=None) -> torch.Tensor:
    """The scan's backward sweep: w (lanes, k, Dp) -> z with
    z_k = Dinv_k^T (w_k - sum_j L[k+j,k]^T z_{k+j}), bottom block first;
    the sum over j one product batched over the lanes and j, in
    ``gemm_dtype`` when it is given."""
    mm = _product(w.dtype, gemm_dtype)
    lanes, k = w.shape[:2]
    nb, bw = fac.L.shape[1], fac.L.shape[2]
    out = torch.empty_like(w)
    Z = w.new_empty(lanes, nb, B, k)
    for b in range(nb - 1, -1, -1):
        acc = w[:, :, b * B:(b + 1) * B].transpose(-1, -2)
        kq = min(bw, nb - 1 - b)
        if kq:                  # L[b+j, b] = L[:, b+j, j-1], j = 1..kq
            Lc = fac.L[:, b + 1:b + 1 + kq].diagonal(dim1=1, dim2=2)
            acc = acc - _corr(mm, Lc.permute(0, 3, 2, 1),
                              Z[:, b + 1:b + 1 + kq])
        Z[:, b] = mm(fac.Dinv[:, b].transpose(-1, -2), acc)
        out[:, :, b * B:(b + 1) * B] = Z[:, b].transpose(-1, -2)
    return out


def band_ldl_solve(fac: BandFactors, rhs: torch.Tensor,
                   gemm_dtype=None) -> torch.Tensor:
    """K x = rhs through the scan's sweeps, rhs (lanes, k, Dp)."""
    return band_ldl_bwd(fac, band_ldl_fwd(fac, rhs, gemm_dtype), gemm_dtype)


def leaf_ldl_plain(Ms: torch.Tensor):
    """Plain version of ``ops/leaf.leaf_ldl``: (L, 128, 128) -> (Linv, d)
    by ``_unblocked_ldl`` and ``_unit_lower_inv``."""
    L, d = _unblocked_ldl(Ms)
    return _unit_lower_inv(L), d


def band_factor_bw_plain(Kd: torch.Tensor, Ksubs: torch.Tensor) -> BandFactors:
    """Plain twin of the ``band_factor_bw`` kernel: the scan factor in f64
    with the plain leaf on every device."""
    return band_ldl_factor(Kd, Ksubs, leaf=leaf_ldl_plain)


# the plain twins of the ``band_fwd_bw`` / ``band_bwd_bw`` kernels: the
# scan's sweeps in f64
band_fwd_bw_plain = band_ldl_fwd
band_bwd_bw_plain = band_ldl_bwd
