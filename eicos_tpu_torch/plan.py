"""Host-side symbolic planning for the banded KKT strategy: a port of
``eicos_tpu.plan``.

A Reverse-Cuthill-McKee ordering of the reduced KKT pattern, [x | y] or
with kept cones [z_soc | x | y] (native library, SciPy fallback), and a
block bandwidth: the numeric factorization is then a regular block-banded
LDL^T.  Runs once per sparsity pattern; the ``BandPlan`` is hashable and
lives on the ``ProblemStructure``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import native
from .ops.band_ldl import band_blocks, pad_to_block
from .structure import ProblemStructure


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """RCM permutation (over the padded reduced dimension) + block band.

    ``keep_soc``: the plan covers [z_soc | x | y] (ms + n + p) with the
    per-cone SOC blocks kept in the factor (in each cone's eigenbasis of
    W^2, ``kkt._soc_kept_vals``): eliminating the cones squares their
    conditioning.  False: [x | y] (n + p) with every G row
    eliminated."""

    perm: tuple   # (Dp,) new->old index map; identity on padding rows
    bwb: int      # block bandwidth (in 128-blocks)
    block: int = 128
    keep_soc: bool = False

    @property
    def dim(self) -> int:
        return len(self.perm)


def make_band_plan(st: ProblemStructure, G, A, block: int = 128,
                   keep_soc: bool = False) -> BandPlan:
    """The banded plan from the problem's sparsity pattern.

    ``keep_soc=False``: the fully eliminated KKT, H = G'G (plus diag) and
    the A blocks over [x | y].  ``keep_soc=True`` (needs cones): the
    partially eliminated KKT over [z_soc | x | y], per-cone dense blocks,
    the coupling on each cone's union column support (the eigenbasis
    mixes the rows within a cone), H_lp = G_lp'G_lp and the A blocks.  The
    permutation covers the padded dimension (identity on padding)."""
    import scipy.sparse as sp

    n, p = st.n, st.p
    keep_soc = bool(keep_soc and st.n_sc)
    if keep_soc:
        l, ms = st.l, st.cone.ms
        D = ms + n + p
        Glp = sp.csc_matrix(np.asarray(G)[:l] != 0)
        Gsc = sp.csc_matrix(np.asarray(G)[l:] != 0)
        H = (Glp.T @ Glp).astype(bool) + sp.eye(n, dtype=bool)
        Wp = sp.block_diag([sp.coo_matrix(np.ones((d, d), dtype=bool))
                            for d in st.q], format="csc")
        Gsc = (Wp @ Gsc).astype(bool)
        blocks = [[Wp, Gsc, None], [Gsc.T, H, None], [None, None, None]]
        if p:
            As = sp.csc_matrix(np.asarray(A) != 0)
            blocks[1][2] = As.T
            blocks[2][1] = As
            blocks[2][2] = sp.eye(p, dtype=bool)
        else:
            blocks = [r[:2] for r in blocks[:2]]
        K = sp.bmat(blocks, format="csc")
    else:
        D = n + p
        Gs = sp.csc_matrix(np.asarray(G) != 0)
        H = (Gs.T @ Gs).astype(bool) + sp.eye(n, dtype=bool)
        if p:
            As = sp.csc_matrix(np.asarray(A) != 0)
            K = sp.bmat([[H, As.T], [As, None]], format="csc")
        else:
            K = H.tocsc()
    K = (K + K.T + sp.eye(D, dtype=bool)).tocsc()
    perm = native.rcm_order(D, K.indptr.astype(np.int64),
                            K.indices.astype(np.int64))
    iperm = np.empty(D, dtype=np.int64)
    iperm[perm] = np.arange(D)
    bw, _ = native.band_stats(D, K.indptr.astype(np.int64),
                              K.indices.astype(np.int64), iperm)
    Dp = pad_to_block(D, block)
    full_perm = np.concatenate([perm, np.arange(D, Dp)])
    return BandPlan(perm=tuple(int(v) for v in full_perm),
                    bwb=min(band_blocks(int(bw), block), Dp // block),
                    block=block, keep_soc=keep_soc)
