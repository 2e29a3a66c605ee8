"""Substitution solves against the dense LDL^T factor: the port of
``eicos_tpu.ops.pallas_dense_ds`` (``prechunk_dense``, ``dense_solve_ds``).

With K = L diag(d) L^T, L unit lower triangular in 128-blocks, a solve is

    L y = b    forward:   y_k = Xinv_k (b_k - sum_{c<k} L[k,c] y_c)
    w = y / d
    L' z = w   backward:  z_j = Xinv_j' (w_j - sum_{r>j} L[r,j]' z_r)

where Xinv_k is the inverse of the unit-lower diagonal block L[k,k] (the
leaf inverse of the dense recursion).  The factor is the ``DenseFac``:

    Lp    (L, nb (nb-1) / 2, 128, 128)  the strictly-block-lower blocks of
          L, each contiguous, in row-major block order: block [k, c], c <
          k, at index k (k-1) / 2 + c.  The row panel L[k, :k] is one
          contiguous stretch, and the panels follow each other.
    Xinv  (L, nb, 128, 128)             the leaf inverses
    d     (L, Dp)                       the pivots

Both sweeps read whole row panels.  The forward sweep is left-looking: at
block row k it reads panel k and the y blocks before it, so it streams
``Lp`` forward in memory from its first byte to its last.  The backward
sweep is right-looking: once z_j is known it subtracts L[j,c]' z_j from
every w_c, c < j, reading the same panel j, so it streams the same memory
panel by panel from the last to the first.  Neither needs a transposed
copy of the factor (the TPU kernels keep one chunk stack per contraction
orientation, ``lc1`` and ``lc0``).

``pack_dense`` (K15, ``csrc/dense_pack.cu``) builds ``Lp`` once per factor
from the (L, Dp, Dp) matrix whose strictly-block-lower blocks hold L; the
TPU kernel it replaces turns the same panels into bf16 chunk stacks and
f32 scales for want of f64, and none of that is carried over.
``dense_fwd`` and ``dense_bwd`` (K16, ``csrc/dense_solve.cu``) are the two
sweeps.  Right-hand sides keep the port's (k, Dp)-per-lane layout, k <=
16, as the band sweeps and the inverse solves do.

For a CUDA tensor each wrapper checks its inputs, launches its kernel on
the current stream and counts the launch in ``kernels.COUNTS``; for a CPU
tensor it runs the plain version beside it.  Nothing falls back from a
kernel to its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
from .band_ldl import B, KP

# the sweeps keep k columns of the right-hand side in one CTA's shared
# memory, (Dp + 2 B) f64 a column; a single column must fit
SMEM_BYTES = 232448
MAX_DP = SMEM_BYTES // 8 - 2 * B


class DenseFac(NamedTuple):
    Lp: torch.Tensor     # (L, nb (nb-1) / 2, B, B) packed blocks of L
    Xinv: torch.Tensor   # (L, nb, B, B) leaf inverses
    d: torch.Tensor      # (L, Dp) pivots


def _n_blocks(nb: int) -> int:
    return nb * (nb - 1) // 2


def pack_dense_plain(Loff: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``dense_pack`` kernel: (L, Dp, Dp) -> the
    packed blocks (L, nb (nb-1) / 2, B, B)."""
    lanes, Dp = Loff.shape[0], Loff.shape[-1]
    nb = Dp // B
    rows, cols = torch.tril_indices(nb, nb, -1, device=Loff.device)
    blocks = Loff.view(lanes, nb, B, nb, B).permute(0, 1, 3, 2, 4)
    return blocks[:, rows, cols].contiguous()


def pack_dense(Loff: torch.Tensor, Xinv: torch.Tensor,
               d: torch.Tensor) -> DenseFac:
    """The packed substitution factor of ``Loff`` (L, Dp, Dp), whose
    strictly-block-lower 128-blocks hold L (its other blocks are not
    read), the leaf inverses ``Xinv`` (L, nb, B, B) and the pivots ``d``
    (L, Dp).  ``Xinv`` and ``d`` are already in the sweeps' layout and are
    kept as they are; ``Loff`` can be freed afterwards."""
    lanes, Dp = Loff.shape[0], Loff.shape[-1]
    if Dp % B or Loff.shape[-2] != Dp:
        raise ValueError(f"Loff must be (L, Dp, Dp) with Dp a multiple of "
                         f"{B}, got {tuple(Loff.shape)}")
    nb = Dp // B
    if kernels.on_cpu(Loff):
        return DenseFac(Lp=pack_dense_plain(Loff), Xinv=Xinv, d=d)
    dev = Loff.device
    kernels.check("Loff", Loff, (lanes, Dp, Dp), dev)
    kernels.check("Xinv", Xinv, (lanes, nb, B, B), dev)
    kernels.check("d", d, (lanes, Dp), dev)
    Lp = torch.empty((lanes, _n_blocks(nb), B, B), dtype=Loff.dtype,
                     device=dev)
    if nb > 1:
        with torch.cuda.device(dev):
            kernels.launch(kernels.lib("dense_pack").eicos_dense_pack,
                           Loff.data_ptr(), Lp.data_ptr(), lanes, Dp,
                           kernels.stream(Loff))
        kernels.count("dense_pack")
    return DenseFac(Lp=Lp, Xinv=Xinv, d=d)


def _panel(fac: DenseFac, k: int) -> torch.Tensor:
    """Row panel L[k, :k] as an (L, B, k B) matrix."""
    lanes = fac.Lp.shape[0]
    off = _n_blocks(k)
    return fac.Lp[:, off:off + k].permute(0, 2, 1, 3).reshape(lanes, B,
                                                              k * B)


def dense_fwd_plain(fac: DenseFac, rhs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dense_fwd``: w = (L^{-1} rhs) / d, block row by
    block row."""
    nb = fac.Xinv.shape[1]
    y = torch.empty_like(rhs)
    for k in range(nb):
        t = rhs[..., k * B:(k + 1) * B]
        if k:
            t = t - y[..., :k * B] @ _panel(fac, k).transpose(-1, -2)
        y[..., k * B:(k + 1) * B] = t @ fac.Xinv[:, k].transpose(-1, -2)
    return y / fac.d[:, None, :]


def dense_bwd_plain(fac: DenseFac, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dense_bwd``: z = L^{-T} w, from the last block
    row to the first; each z_j is subtracted from the rows above it."""
    nb = fac.Xinv.shape[1]
    z = w.clone()
    for j in range(nb - 1, -1, -1):
        zj = z[..., j * B:(j + 1) * B] @ fac.Xinv[:, j]
        z[..., j * B:(j + 1) * B] = zj
        if j:
            z[..., :j * B] -= zj @ _panel(fac, j)
    return z


def _check_solve(fac: DenseFac, vecs: torch.Tensor):
    lanes, nb = fac.Xinv.shape[0], fac.Xinv.shape[1]
    Dp = nb * B
    k = vecs.shape[1]
    if not 1 <= k <= KP:
        raise ValueError(f"the substitution solve takes 1..{KP} right-hand "
                         f"sides, got {k}")
    if Dp > MAX_DP:
        raise ValueError(f"the substitution solve takes Dp <= {MAX_DP}, "
                         f"got {Dp}")
    dev = vecs.device
    kernels.check("Lp", fac.Lp, (lanes, _n_blocks(nb), B, B), dev)
    kernels.check("Xinv", fac.Xinv, (lanes, nb, B, B), dev)
    kernels.check("d", fac.d, (lanes, Dp), dev)
    kernels.check("rhs", vecs, (lanes, k, Dp), dev)
    return lanes, Dp, k


def dense_fwd(fac: DenseFac, rhs: torch.Tensor) -> torch.Tensor:
    """w = (L^{-1} rhs) / d for rhs (L, k, Dp), k <= 16."""
    if kernels.on_cpu(rhs):
        return dense_fwd_plain(fac, rhs)
    lanes, Dp, k = _check_solve(fac, rhs)
    out = torch.empty_like(rhs)
    with torch.cuda.device(rhs.device):
        kernels.launch(kernels.lib("dense_solve").eicos_dense_fwd,
                       fac.Lp.data_ptr(), fac.Xinv.data_ptr(),
                       fac.d.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                       lanes, Dp, k, kernels.stream(rhs))
    kernels.count("dense_fwd")
    return out


def dense_bwd(fac: DenseFac, w: torch.Tensor) -> torch.Tensor:
    """z = L^{-T} w for w (L, k, Dp), k <= 16."""
    if kernels.on_cpu(w):
        return dense_bwd_plain(fac, w)
    lanes, Dp, k = _check_solve(fac, w)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        kernels.launch(kernels.lib("dense_solve").eicos_dense_bwd,
                       fac.Lp.data_ptr(), fac.Xinv.data_ptr(), w.data_ptr(),
                       out.data_ptr(), lanes, Dp, k, kernels.stream(w))
    kernels.count("dense_bwd")
    return out


def dense_solve(fac: DenseFac, rhs: torch.Tensor) -> torch.Tensor:
    """K x = rhs for rhs (L, k, Dp), k <= 16: the two sweeps."""
    return dense_bwd(fac, dense_fwd(fac, rhs))
