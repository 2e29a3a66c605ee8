"""Static problem structure: a copy of ``eicos_tpu.structure``.

The split of EiCOS's mutable ``Solver`` object (include/eicos.hpp:116-266)
into

  * **structure** — dimensions, cone layout and the host-computed symbolic
    plans: hashable, so the port keys its per-structure caches (index
    tensors on the device) on it, and
  * **values** — the tensors (G, A, c, h, b) in ``problem.py``.

The cone layout replaces the reference's per-cone C++ loops
(``for (SOCone &sc : so_cones)`` all over EiCOS src/eicos.cpp)
with precomputed flat index arrays so that every cone operation is a single
fused vector op over the full conic dimension ``m``:

  m-vector layout: [ l LP entries | SOC_0 | SOC_1 | ... | SOC_{N-1} ]

For the SOC part (length ms = m - l) we precompute the segment id of each
entry, head masks, and gather maps, all NumPy; ``cones.py`` moves them to
the device once per structure.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class ConeStructure:
    """Cone layout: l LP (positive-orthant) rows followed by SOCs of dims q."""

    l: int
    q: tuple  # tuple of ints, SOC dimensions

    def __post_init__(self):
        object.__setattr__(self, "q", tuple(int(d) for d in self.q))
        for d in self.q:
            if d < 1:
                raise ValueError(f"SOC dimension must be >= 1, got {d}")

    @property
    def n_sc(self) -> int:
        return len(self.q)

    @property
    def ms(self) -> int:
        return int(sum(self.q))

    @property
    def m(self) -> int:
        return self.l + self.ms

    # ---- cached flat index arrays (host constants) ----

    @functools.cached_property
    def seg(self) -> np.ndarray:
        """(ms,) int32: cone id of each SOC entry."""
        return np.repeat(np.arange(self.n_sc, dtype=np.int32),
                         np.asarray(self.q, dtype=np.int64))

    @functools.cached_property
    def is_head(self) -> np.ndarray:
        """(ms,) bool: True at the first entry of each SOC."""
        mask = np.zeros(self.ms, dtype=bool)
        mask[self.head_offsets] = True
        return mask

    @functools.cached_property
    def head_offsets(self) -> np.ndarray:
        """(n_sc,) int64: offset of each cone head within the SOC part."""
        return np.concatenate(
            [[0], np.cumsum(np.asarray(self.q, dtype=np.int64))[:-1]]
        ).astype(np.int64) if self.n_sc else np.zeros(0, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class GSplit:
    """Static split of G's LP-cone rows into singleton rows (exactly one
    nonzero — bound constraints, ubiquitous in LP-form MPC and netlib
    problems) and the dense remainder.

    Used by the reduced KKT strategy: a singleton row r with column j
    contributes ``G[r,j]^2 / (v_lp[r] + delta)`` to H[j,j] only, so those
    rows can be dropped from the H = G'(W^2+dI)^{-1}G matmul — the
    dominant per-iteration matmul (n^2*m flops) shrinks to n^2*m_dense.
    The reference gets the same effect implicitly from sparse arithmetic
    (Eigen CSC products); this is the dense-MXU analogue: one segment-sum
    onto the diagonal plus a smaller GEMM.

    Only the row *pattern* is static; coefficients stay traced (gathered
    from G inside the jitted solve), so ``update_data`` with new values on
    the same pattern reuses the compiled executable.  Row/column
    equilibration preserves the pattern.  SOC rows are never split:
    (W^2+dI)^{-1} mixes entries within a cone block.
    """

    sing_rows: tuple   # LP rows of G with exactly one structural nonzero
    sing_cols: tuple   # their column indices
    dense_rows: tuple  # LP rows with nnz > spr_width (SOC rows appended
    #                    by users)
    # LP rows with 2 <= nnz <= spr_width ("scatter rows"): their H
    # contribution w_r * g_i g_j lands on at most spr_width^2 entries,
    # assembled by one static scatter-add instead of the GEMM.  For
    # MPC-class problems (box rows singleton, rate rows 2-nnz) this
    # removes the H = G'W^{-2}G GEMM — the dominant per-iteration matmul
    # AND the dominant HBM consumer under XLA's float64 emulation —
    # entirely.  The reference gets this for free from CSC sparse
    # products; this is the dense-MXU analogue.
    spr_rows: tuple = ()
    spr_cols: tuple = ()   # (n_spr * spr_width,) flattened, pad col = n
    spr_width: int = 0

    SPR_WIDTH_MAX = 4

    @staticmethod
    def from_dense(G, l: int, n: int = None) -> "GSplit":
        """Detect the split from a concrete G's nonzero pattern; rows
        beyond ``l`` (SOC rows) always go dense."""
        G = np.asarray(G)
        n = G.shape[1] if n is None else n
        nnz_per_row = (G[:l] != 0).sum(axis=1)
        sing = np.flatnonzero(nnz_per_row == 1)
        cols = np.argmax(G[sing] != 0, axis=1) if sing.size else sing
        # "scatter rows" must be genuinely sparse: tiny problems whose
        # rows touch every column gain nothing from the scatter form
        wmax = min(GSplit.SPR_WIDTH_MAX, G.shape[1] - 1)
        spr = np.flatnonzero((nnz_per_row >= 2) & (nnz_per_row <= wmax))
        # dense = everything not singleton and not a scatter row.  The
        # threshold must never drop below 1: at n = 1, wmax = 0 and a
        # plain nnz > wmax test put the singleton rows in BOTH lists —
        # H double-counted those rows, the factor solved ~2H while
        # refinement targeted H, and the slow ~x0.5/round contraction
        # tripped the weak-progress stop: knife-thin certificates
        # (infeasible1) diverged to CLOSE_TO_DUAL_INFEASIBLE under the
        # gsplit strategies where "full" certified PINF in 5 iterations.
        dense = np.flatnonzero(nnz_per_row > max(wmax, 1))
        if spr.size:
            width = int(nnz_per_row[spr].max())
            spr_cols = np.full((spr.size, width), n, dtype=np.int64)
            for t, r in enumerate(spr):
                cc = np.flatnonzero(G[r] != 0)
                spr_cols[t, :cc.size] = cc
            spr_cols = tuple(int(c) for c in spr_cols.ravel())
        else:
            width = 0
            spr_cols = ()
        return GSplit(sing_rows=tuple(int(r) for r in sing),
                      sing_cols=tuple(int(c) for c in cols),
                      dense_rows=tuple(int(r) for r in dense),
                      spr_rows=tuple(int(r) for r in spr),
                      spr_cols=spr_cols, spr_width=width)

    @property
    def n_sing(self) -> int:
        return len(self.sing_rows)

    @property
    def n_spr(self) -> int:
        return len(self.spr_rows)


@dataclasses.dataclass(frozen=True)
class SOCSplit:
    """Static per-cone column support of G's SOC rows.

    A cone q touching columns J contributes
    ``Gq' (W^2 + dI)^{-1} Gq = b Gq'Gq - b^2 [v1 v2] Minv [v1 v2]'``
    (the closed form of cones.scale2reg_inv_soc with v1 = Gq' e,
    v2 = Gq' q) — entirely supported on J x J.  When every cone's
    support is narrow (|J| <= WIDTH_MAX), the banded KKT strategy
    scatters these values straight into the band blocks and the SOC
    share of the dense H GEMM disappears, exactly like GSplit does for
    LP scatter rows.  Pattern-static; coefficients stay traced."""

    cols: tuple   # (n_sc * width,) flattened per-cone columns, pad = n
    width: int

    WIDTH_MAX = 8

    @staticmethod
    def from_dense(G, cone: ConeStructure, n: int = None):
        """None if any cone's column support exceeds WIDTH_MAX."""
        if not cone.n_sc:
            return None
        G = np.asarray(G)
        n = G.shape[1] if n is None else n
        Gs = G[cone.l:]
        offs = cone.head_offsets
        supports = []
        for c in range(cone.n_sc):
            rows = Gs[offs[c]:offs[c] + cone.q[c]]
            cols = np.flatnonzero(np.any(rows != 0, axis=0))
            if cols.size > SOCSplit.WIDTH_MAX:
                return None
            supports.append(cols)
        width = max(max((len(c) for c in supports), default=1), 1)
        flat = []
        for cols in supports:
            flat.extend(int(c) for c in cols)
            flat.extend([n] * (width - len(cols)))
        return SOCSplit(cols=tuple(flat), width=width)

    @property
    def n_sc(self) -> int:
        return len(self.cols) // max(self.width, 1)


@dataclasses.dataclass(frozen=True)
class MatvecPattern:
    """Static nonzero patterns of G and A for the TPU kernel path's
    big matvecs (residual products, LP-row elimination).

    The reference's computeResiduals runs CSC SpMVs
    (EiCOS src/eicos.cpp:643-689); the dense double-single
    GEMV kernel that replaced them streams the full operand per product
    — ~4.5 ms at 128 bench lanes for matrices with <= 8 nonzeros per
    row/column.  With the pattern static, each product becomes an exact
    float64 padded-CSC gather + weighted sum (ops/spmv.SparseOperand).
    Coefficients stay traced (gathered from the equilibrated G/A inside
    the jitted solve), so update_data with new values on the same
    pattern reuses the compiled executable."""

    g_rows: tuple
    g_cols: tuple
    a_rows: tuple
    a_cols: tuple
    has_a: bool  # A's pattern was recorded (empty tuples then mean A==0,
    #              not "unknown" — the A-involving operands stay dense
    #              when False and p > 0)

    @staticmethod
    def from_dense(G, A=None) -> "MatvecPattern":
        gr, gc = np.nonzero(np.asarray(G))
        has_a = A is not None
        if has_a and np.asarray(A).size:
            ar, ac = np.nonzero(np.asarray(A))
        else:
            ar, ac = (), ()
        return MatvecPattern(
            g_rows=tuple(int(v) for v in gr),
            g_cols=tuple(int(v) for v in gc),
            a_rows=tuple(int(v) for v in ar),
            a_cols=tuple(int(v) for v in ac),
            has_a=has_a)


@dataclasses.dataclass(frozen=True)
class ProblemStructure:
    """Full static description: dimensions + cone layout.

    Mirrors the dimension bookkeeping of the reference
    (EiCOS src/eicos.cpp:148-165) minus ``dim_K``'s ``+ 2*n_sc``
    SOC expansion — the expansion exists only to keep a *sparse* pattern
    constant; our dense-block KKT representation doesn't need it.

    ``band`` optionally carries the host-computed symbolic plan for the
    banded KKT strategy (plan.BandPlan: RCM permutation + block
    bandwidth); it is hashable, so it stays a static part of the compiled
    program — the analogue of Eigen's symbolic factorization being
    computed once and reused.
    """

    n: int  # number of variables
    p: int  # number of equality constraints
    cone: ConeStructure
    band: object = None    # Optional[plan.BandPlan]
    gsplit: object = None  # Optional[GSplit]
    socsplit: object = None  # Optional[SOCSplit]
    matvec: object = None  # Optional[MatvecPattern]

    @property
    def m(self) -> int:
        return self.cone.m

    @property
    def l(self) -> int:
        return self.cone.l

    @property
    def q(self) -> tuple:
        return self.cone.q

    @property
    def n_sc(self) -> int:
        return self.cone.n_sc

    @property
    def dim_kkt(self) -> int:
        return self.n + self.p + self.m

    @property
    def degrees(self) -> int:
        """Barrier degree: n_lc + n_sc (+1 for tau/kappa added by callers).

        Used for mu = (s'z + kap*tau) / (degrees + 1)
        (EiCOS src/eicos.cpp:694).
        """
        return self.l + self.n_sc

    @staticmethod
    def create(n: int, p: int, m: int, l: int, q=()) -> "ProblemStructure":
        q = tuple(int(d) for d in (q if q is not None else ()))
        if l + sum(q) != m:
            raise ValueError(f"l + sum(q) = {l + sum(q)} != m = {m}")
        return ProblemStructure(n=int(n), p=int(p),
                                cone=ConeStructure(l=int(l), q=q))

    def with_band_plan(self, plan) -> "ProblemStructure":
        """Attach a banded-KKT symbolic plan (plan.make_band_plan)."""
        return dataclasses.replace(self, band=plan)

    def with_gsplit(self, G, A=None) -> "ProblemStructure":
        """Attach the singleton-row split detected from a concrete G (used
        by the reduced KKT strategy's H formation).  Only worthwhile when a
        meaningful fraction of LP rows are bound constraints.

        Passing ``A`` as well also records the full G/A nonzero patterns
        (MatvecPattern): the TPU kernel path then runs its residual /
        elimination matvecs as static-pattern sparse gathers wherever the
        pattern is narrow enough (ops/spmv)."""
        split = GSplit.from_dense(G, self.l, self.n)
        new = self
        if split.n_sing or split.n_spr:
            new = dataclasses.replace(new, gsplit=split)
        if self.n_sc:
            soc = SOCSplit.from_dense(G, self.cone, self.n)
            if soc is not None:
                new = dataclasses.replace(new, socsplit=soc)
        new = dataclasses.replace(
            new, matvec=MatvecPattern.from_dense(G, A))
        return new
