"""Dense LDL^T batched over lanes, with an explicit unit-lower inverse
(``ldl_factor``) or in substitution form (``ldl_factor_subst``): the port
of ``eicos_tpu.ops.ldl`` (``ldl_factor``, ``_ldl_rec``, ``_ldl_rec_subst``,
``ldl_factor_subst``, ``_leaf``, ``_mm``, ``ldl_solve``).

The factor is the reference's recursive half-splitting: a node of size D
(a multiple of 128) splits at h = (nb // 2) 128, factors its leading half,
forms L21 = K21 L11^{-T} / d1, updates the trailing half with the Schur
complement K22 - (L21 d1) L21^T, factors that, and assembles its inverse
[L11inv 0; -L22inv L21 L11inv  L22inv].  Leaves of 128 go to
``leaf.leaf_ldl`` and the four products of a node to ``gemm.matmul``, so
for a CUDA f64 tensor the recursion and the solves run in the kernels
only.  Each product names its structure, so the kernel skips known zeros:
L11inv^T is upper triangular in L21 = K21 L11inv^T, L11inv lower in
X = L21 L11inv, L22inv lower in -L22inv X, and the Schur update writes
only K22's lower triangle.  Both recursions pass the same flags in the
same calls, so their pivots and leaf inverses keep the same bits.

The substitution form keeps L itself: the same recursion, the same calls
in the same order for L21, the Schur update and the leaves, so its pivots
and leaf inverses have the bits of ``ldl_factor``'s.  A node assembles its
inverse only where something reads it (the reference's ``need_inv``): a
left child always (its parent's L21 product), a right child only if its
parent assembles.  The root and its right spine skip their two assembly
products.  The solves then run the substitution sweeps of ``ops/dense.py``
on the packed blocks of L.

At float32 (``Settings.factor_dtype``) the leaf is the f32 leaf kernel and
every product and the two passes of a solve are ``torch.matmul``, as the
reference leaves them to XLA's f32 dots outside any Pallas kernel; there
is no f32 substitution form.

Departures from the JAX code, none of which changes a value:

* The factor is built in place.  One (L, Dp, Dp) ``Linv`` is allocated
  zeroed, each leaf and each L21inv product is written straight into its
  block of it, and the Schur update overwrites K22 in the caller's K (the
  ``beta`` form of ``matmul``), where JAX builds zeros and ``.at[].set``
  copies at every level.  Only K's lower triangle is read.
* There is no ``ldl_prechunk``: the TPU needs a bf16 chunk decomposition
  of Linv for its double-single solve kernel, while the solve kernels here
  read the f64 Linv as it is, so ``kkt`` calls ``ldl_solve`` on the
  factor directly.
* The counterpart of ``_mm_sym`` (the reference's half-work symmetric
  Schur product, which it runs on the TPU's double-single path only) is
  ``matmul(..., c_lower=True)`` in both recursions: half the work, and
  without ``_mm_sym``'s mirror, because nothing reads K22's upper
  triangle.  K's strict upper triangle is left stale.
* The substitution recursion leaves L where K was: each L21 overwrites the
  K21 block it was computed from, so the consumed K is the reference's
  ``Loff`` and no second (L, Dp, Dp) buffer exists.  Leaf inverses go
  straight into one (L, nb, 128, 128) tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .band_ldl import B, leaf_ldl_plain, pad_to_block  # noqa: F401
from .dense import DenseFac, dense_solve, pack_dense
from .gemm import (linv_bwd, linv_bwd_plain, linv_fwd, linv_fwd_plain,
                   matmul)
from .leaf import leaf_ldl


class LDLFactors(NamedTuple):
    Linv: torch.Tensor   # (L, Dp, Dp) inverse of the unit-lower factor
    d: torch.Tensor      # (L, Dp) pivots


class LDLSubstFactors(NamedTuple):
    """Substitution-form factor: the packed blocks of L and the leaf
    inverses (``dense.DenseFac``) for the sweeps of ``ops/dense.py``."""

    pre: DenseFac
    d: torch.Tensor      # (L, Dp) pivots


def _leaf(K: torch.Tensor, out: tuple, block: int) -> None:
    """A leaf of the recursion into ``out`` = (Linv, d): the leaf kernel
    at 128 (``leaf.leaf_ldl``), the plain leaf on every device at any other
    block, where the JAX package reaches no Pallas leaf either
    (``eicos_tpu.ops.ldl._leaf``)."""
    if block == B:
        leaf_ldl(K, out=out)
        return
    Linv, d = leaf_ldl_plain(K)
    out[0].copy_(Linv)
    out[1].copy_(d)


def _ldl_rec(K: torch.Tensor, Linv: torch.Tensor, d: torch.Tensor,
             block: int = B) -> None:
    """Factor the (L, D, D) view K, D a multiple of ``block``, into the
    views Linv (L, D, D) and d (L, D); K's trailing blocks are
    overwritten."""
    D = K.shape[-1]
    if D <= block:
        _leaf(K, (Linv, d), block)
        return
    h = (D // block // 2) * block
    L11inv = Linv[:, :h, :h]
    d1 = d[:, :h]
    _ldl_rec(K[:, :h, :h], L11inv, d1, block)
    # K21 = L21 D1 L11^T  =>  L21 = K21 L11^{-T} D1^{-1}
    L21 = matmul(K[:, h:, :h], L11inv.transpose(-1, -2), b_tri="upper")
    L21 /= d1[:, None, :]
    K22 = K[:, h:, h:]
    matmul(L21 * d1[:, None, :], L21.transpose(-1, -2), c=K22, alpha=-1.0,
           beta=1.0, c_lower=True)
    L22inv = Linv[:, h:, h:]
    _ldl_rec(K22, L22inv, d[:, h:], block)
    # [L11 0; L21 L22]^{-1} = [L11inv 0; -L22inv L21 L11inv, L22inv]
    matmul(L22inv, matmul(L21, L11inv, b_tri="lower"), c=Linv[:, h:, :h],
           alpha=-1.0, a_tri="lower")


def _ldl_rec_subst(K: torch.Tensor, Linv, Xinv: torch.Tensor,
                   d: torch.Tensor) -> None:
    """``_ldl_rec`` that keeps L: factor the (L, D, D) view K into the
    leaf inverses Xinv (L, D / 128, 128, 128) and d (L, D), leaving every
    L21 in the block of K it came from; with ``Linv`` (an (L, D, D) zeroed
    view) the node's inverse is assembled there too, without it (None) the
    node needs none."""
    D = K.shape[-1]
    if D <= B:
        leaf_ldl(K, out=(Xinv[:, 0], d))
        if Linv is not None:
            Linv.copy_(Xinv[:, 0])
        return
    h = (D // B // 2) * B
    d1 = d[:, :h]
    if Linv is None:
        L11inv = K.new_zeros(K.shape[0], h, h)
    else:
        L11inv = Linv[:, :h, :h]
    _ldl_rec_subst(K[:, :h, :h], L11inv, Xinv[:, :h // B], d1)
    L21 = matmul(K[:, h:, :h], L11inv.transpose(-1, -2), b_tri="upper")
    L21 /= d1[:, None, :]
    K22 = K[:, h:, h:]
    matmul(L21 * d1[:, None, :], L21.transpose(-1, -2), c=K22, alpha=-1.0,
           beta=1.0, c_lower=True)
    K[:, h:, :h] = L21
    if Linv is None:
        del L11inv, L21       # nothing reads them again
        _ldl_rec_subst(K22, None, Xinv[:, h // B:], d[:, h:])
        return
    L22inv = Linv[:, h:, h:]
    _ldl_rec_subst(K22, L22inv, Xinv[:, h // B:], d[:, h:])
    matmul(L22inv, matmul(L21, L11inv, b_tri="lower"), c=Linv[:, h:, :h],
           alpha=-1.0, a_tri="lower")


def _check_padded(K: torch.Tensor, block: int = B):
    lanes, Dp = K.shape[0], K.shape[-1]
    if Dp % block or K.shape[-2] != Dp:
        raise ValueError(f"K must be (L, Dp, Dp) with Dp a multiple of "
                         f"{block}, got {tuple(K.shape)}")
    return lanes, Dp


def ldl_factor_subst(K: torch.Tensor) -> LDLSubstFactors:
    """Factor the padded symmetric f64 (L, Dp, Dp) K into the substitution
    form.  K is consumed: afterwards its strictly-block-lower blocks hold
    L, which ``dense.pack_dense`` packs, its strict upper triangle is
    stale, and the caller can free it."""
    lanes, Dp = _check_padded(K)
    if K.dtype != torch.float64:
        raise ValueError(f"the substitution form is f64, got {K.dtype}")
    Xinv = K.new_empty(lanes, Dp // B, B, B)
    d = K.new_empty(lanes, Dp)
    _ldl_rec_subst(K, None, Xinv, d)
    return LDLSubstFactors(pre=pack_dense(K, Xinv, d), d=d)


def ldl_factor(K: torch.Tensor, block: int = B) -> LDLFactors:
    """Factor the padded symmetric (L, Dp, Dp) K, f64 or f32, Dp a
    multiple of ``block`` (the reference's ``Settings.block``), into
    ``LDLFactors``.  K is consumed: its blocks below the leading one hold
    Schur complements afterwards, of which only the lower triangles are
    current (the strict upper triangle of K is left stale).

    The inverse solves take multiples of 128, as the JAX package's
    prechunked operands pad to them: where Dp is not one, the factor is
    held padded to the next, Linv with zero rows and columns and d with
    ones there, and ``ldl_solve`` pads the right-hand sides with zeros,
    which adds exact zeros to every sum."""
    lanes, Dp = _check_padded(K, block)
    P = pad_to_block(Dp, B)
    # strictly upper blocks are never written and stay exact zeros
    Linv = K.new_zeros(lanes, P, P)
    d = K.new_ones(lanes, P)
    _ldl_rec(K, Linv[:, :Dp, :Dp], d[:, :Dp], block)
    return LDLFactors(Linv=Linv, d=d)


def ldl_solve(fac, rhs: torch.Tensor) -> torch.Tensor:
    """K x = rhs for rhs (L, k, Dp), k <= 16 (the port's (k, Dp)-per-lane
    layout).  ``LDLSubstFactors``: the two substitution sweeps.
    ``LDLFactors``: x = Linv^T ((Linv rhs) / d), two passes over Linv,
    which at f32 are two ``torch.matmul``."""
    if isinstance(fac, LDLSubstFactors):
        return dense_solve(fac.pre, rhs)
    Dp, P = rhs.shape[-1], fac.Linv.shape[-1]
    if P != Dp:
        rhs = torch.cat([rhs, rhs.new_zeros(*rhs.shape[:-1], P - Dp)], -1)
    if fac.Linv.dtype == torch.float32:
        x = linv_bwd_plain(fac.Linv, linv_fwd_plain(fac.Linv, fac.d, rhs))
    else:
        x = linv_bwd(fac.Linv, linv_fwd(fac.Linv, fac.d, rhs))
    return x[..., :Dp] if P != Dp else x
