"""Dense LDL^T with an explicit unit-lower inverse, batched over lanes: the
port of ``eicos_tpu.ops.ldl`` (``ldl_factor``, ``_ldl_rec``, ``_leaf``,
``_mm``, ``ldl_solve``) on its float64 inverse path.

The factor is the reference's recursive half-splitting: a node of size D
(a multiple of 128) splits at h = (nb // 2) 128, factors its leading half,
forms L21 = K21 L11^{-T} / d1, updates the trailing half with the Schur
complement K22 - (L21 d1) L21^T, factors that, and assembles its inverse
[L11inv 0; -L22inv L21 L11inv  L22inv].  Leaves of 128 go to
``leaf.leaf_ldl`` and the four products of a node to ``gemm.matmul``, so
for a CUDA tensor the recursion and the solves run in the kernels only.

Two departures from the JAX code, neither of which changes a value:

* The factor is built in place.  One (L, Dp, Dp) ``Linv`` is allocated
  zeroed, each leaf and each L21inv product is written straight into its
  block of it, and the Schur update overwrites K22 in the caller's K (the
  ``beta`` form of ``matmul``), where JAX builds zeros and ``.at[].set``
  copies at every level.  Only K's lower triangle is read.
* There is no ``ldl_prechunk``: the TPU needs a bf16 chunk decomposition
  of Linv for its double-single solve kernel, while the solve kernels here
  read the f64 Linv as it is, so ``kkt`` calls ``ldl_solve`` on the
  factor directly.  ``_mm_sym`` (the TPU's half-work symmetric Schur
  product) is not ported either: the reference's f64 path runs ``_mm``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .band_ldl import B, pad_to_block  # noqa: F401  (re-exported)
from .gemm import linv_bwd, linv_fwd, matmul
from .leaf import leaf_ldl


class LDLFactors(NamedTuple):
    Linv: torch.Tensor   # (L, Dp, Dp) inverse of the unit-lower factor
    d: torch.Tensor      # (L, Dp) pivots


def _ldl_rec(K: torch.Tensor, Linv: torch.Tensor, d: torch.Tensor) -> None:
    """Factor the (L, D, D) view K, D a multiple of 128, into the views
    Linv (L, D, D) and d (L, D); K's trailing blocks are overwritten."""
    D = K.shape[-1]
    if D <= B:
        leaf_ldl(K, out=(Linv, d))
        return
    h = (D // B // 2) * B
    L11inv = Linv[:, :h, :h]
    d1 = d[:, :h]
    _ldl_rec(K[:, :h, :h], L11inv, d1)
    # K21 = L21 D1 L11^T  =>  L21 = K21 L11^{-T} D1^{-1}
    L21 = matmul(K[:, h:, :h], L11inv.transpose(-1, -2))
    L21 /= d1[:, None, :]
    K22 = K[:, h:, h:]
    matmul(L21 * d1[:, None, :], L21.transpose(-1, -2), c=K22, alpha=-1.0,
           beta=1.0)
    L22inv = Linv[:, h:, h:]
    _ldl_rec(K22, L22inv, d[:, h:])
    # [L11 0; L21 L22]^{-1} = [L11inv 0; -L22inv L21 L11inv, L22inv]
    matmul(L22inv, matmul(L21, L11inv), c=Linv[:, h:, :h], alpha=-1.0)


def ldl_factor(K: torch.Tensor) -> LDLFactors:
    """Factor the padded symmetric (L, Dp, Dp) K, Dp a multiple of 128
    (the reference's ``block``), into ``LDLFactors``.  K is consumed: its
    blocks below the leading one hold Schur complements afterwards."""
    lanes, Dp = K.shape[0], K.shape[-1]
    if Dp % B or K.shape[-2] != Dp:
        raise ValueError(f"K must be (L, Dp, Dp) with Dp a multiple of {B}, "
                         f"got {tuple(K.shape)}")
    # strictly upper blocks are never written and stay exact zeros
    Linv = torch.zeros_like(K)
    d = K.new_empty(lanes, Dp)
    _ldl_rec(K, Linv, d)
    return LDLFactors(Linv=Linv, d=d)


def ldl_solve(fac: LDLFactors, rhs: torch.Tensor) -> torch.Tensor:
    """K x = rhs for rhs (L, k, Dp), k <= 16 (the port's (k, Dp)-per-lane
    layout): x = Linv^T ((Linv rhs) / d), two passes over Linv."""
    return linv_bwd(fac.Linv, linv_fwd(fac.Linv, fac.d, rhs))
