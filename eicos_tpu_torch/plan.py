"""Host-side symbolic planning for the banded KKT strategy: a port of
``eicos_tpu.plan`` (the ``keep_soc=False`` layout).

A Reverse-Cuthill-McKee ordering of the reduced KKT pattern [x | y]
(native library, SciPy fallback) and a block bandwidth: the numeric
factorization is then a regular block-banded LDL^T.  Runs once per
sparsity pattern; the ``BandPlan`` is hashable and lives on the
``ProblemStructure``.
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

    ``keep_soc`` mirrors the reference's field; a plan that keeps the SOC
    blocks in the factor belongs to the SOCP slice and is refused here."""

    perm: tuple   # (Dp,) new->old index map; identity on padding rows
    bwb: int      # block bandwidth (in 128-blocks)
    block: int = 128
    keep_soc: bool = False

    @property
    def dim(self) -> int:
        return len(self.perm)


def make_band_plan(st: ProblemStructure, G, A, block: int = 128,
                   keep_soc: bool = False) -> BandPlan:
    """The banded plan of the fully eliminated KKT pattern: H = G'G (plus
    diag) and the A blocks over [x | y].  Returns a plan whose permutation
    covers the padded dimension (identity on padding)."""
    import scipy.sparse as sp

    if keep_soc and st.n_sc:
        raise NotImplementedError(
            "make_band_plan(keep_soc=True): the SOCP kept-cone layout is "
            "the next slice of the port")
    n, p = st.n, st.p
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
                    block=block, keep_soc=False)
