"""Block-banded LDL^T factor and solves as loops of torch products at any
block bandwidth: the scan, ``band_ldl_factor`` / ``band_ldl_solve``, and
its f64 twins of the band kernels, ``band_factor_bw_plain`` ...

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
pivots clamped at +-1e-150) and the unit-lower inverse by substitution, as
the leaf kernel computes it (``_unit_lower_inv``; the reference doubles by
Newton-Schulz), on every device.  They run wherever a tensor lies on the
CPU (the tests, and the solver on ``device="cpu"``), and the card tests
(``tests/test_torch_cuda.py``) hold the kernels against them.

Factor of one lane at block bandwidth bw, block rows k = 0..nb-1, with
L[k, k-j] stored at ``L[:, k, j-1]`` and terms that reach above block row
0 left out (the reference's ring starts them at L = 0, Dinv = I, d = 1,
which contributes exact zeros):

    for j = bw..1:  S = Ksubs[k, j-1]
                        - sum_{q=j+1..bw} (L[k,k-q] d_{k-q}) L[k-j,k-q]^T
                    L[k,k-j] = S Dinv_{k-j}^T / d_{k-j}
    M = Kd_k - sum_{q=1..bw} (L[k,k-q] d_{k-q}) L[k,k-q]^T
    M = Lkk diag(d_k) Lkk^T  (unpivoted leaf),  Dinv_k = Lkk^{-1}

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
    L: torch.Tensor      # (lanes, nb, bw, B, B), L[:, k, j-1] = L[k, k-j]
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
    # filled on the device: a CUDA graph captures no host-to-device copy
    tiny = M.new_full((), 1e-20 if M.dtype == torch.float32 else 1e-150)
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
    """Inverse of unit lower-triangular (lanes, B, B) blocks by
    substitution (a triangular solve against I), as the leaf kernel
    inverts (``csrc/leaf.cuh``).  The reference's Newton-Schulz doubling,
    X <- X (2I - L X), forms products of L's and X's largest entries: once
    an ill-conditioned KKT block puts entries of 1e8 and more in L, their
    rounding swamps X's small entries and a band solve loses every digit,
    where substitution keeps the solve's error at the matrix's condition
    number (a second-order cone program near its optimum)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False,
                                         unitriangular=True)


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
    the plain leaf on a CPU one, and at a block size other than 128 the
    plain leaf on every device (the JAX package's ``_band_leaf`` takes its
    kernel only at 128).  ``Ksubs[:, k, j-1]`` for k < j is never read, and
    ``L[:, k, j-1]`` is zero there."""
    blk = Kd.shape[-1]
    if leaf is None and blk != B:
        leaf = leaf_ldl_plain
    elif leaf is None:
        from .leaf import leaf_ldl as leaf
    mm = _product(Kd.dtype, gemm_dtype)
    lanes, nb, bw = Ksubs.shape[:3]
    L = Kd.new_zeros(lanes, nb, bw, blk, blk)
    Dinv = torch.empty_like(Kd)
    d = Kd.new_empty(lanes, nb, blk)
    # rd[:, q-1] = L[k,k-q] d_{k-q} of the current row; zero for q > k
    rd = Kd.new_zeros(lanes, bw, blk, blk)
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
    nb, bw, B = fac.L.shape[1], fac.L.shape[2], fac.d.shape[-1]
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
    nb, bw, B = fac.L.shape[1], fac.L.shape[2], fac.d.shape[-1]
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
    """Plain version of ``ops/leaf.leaf_ldl``: (L, B, B) -> (Linv, d) by
    ``_unblocked_ldl`` and ``_unit_lower_inv``, at any block size B."""
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
