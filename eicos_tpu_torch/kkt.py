"""KKT assembly, factor and solve with iterative refinement: the "banded"
strategy of ``eicos_tpu.kkt`` on its ``direct_band`` path (LP cone) and
its "reduced" strategy on the dense float64 inverse path.

Both factor a quasidefinite system in which the LP rows of G are
eliminated exactly ((W^2 + dI)^{-1} is diagonal on the LP cone, d =
deltastat), with H = G_lp' (W_lp^2 + dI)^{-1} G_lp + dI:

banded   K = [ H  A' ; A  -dI ] over [x | y], RCM-permuted by the
         structure's ``BandPlan`` into 128-blocks with block bandwidth 1.
         H is never formed: its contributions (one per singleton row of G
         on the diagonal, a w x w outer product per few-nnz "scatter row",
         and dI) are summed straight into the per-lane diagonal and
         sub-diagonal band blocks, on top of a lane-invariant base of A, -dI
         and identity padding pivots (``eicos_tpu.kkt._band_scatter_idx`` and
         ``_band_gather_split``).  Contributions that land above the band or
         on a padding column, which the reference sends to a dump slot the
         band factor never reads, are dropped.  The factor and the two
         sweeps of each solve run in ``ops/band.py``.

reduced  the dense (Dp, Dp) matrix over [z_soc | x | y], SOC rows kept,

             [ -(W_soc^2 + dI)   G_soc   0  ]
             [  G_soc'           H       A' ]
             [  0                A      -dI ]

         on a lane-invariant base ``K0`` (``eicos_tpu.kkt.make_context``),
         with H written in per factor: the singleton and scatter rows of
         the gsplit summed straight into K, the gsplit's dense rows (or
         every LP row without a gsplit) by one ``torch.matmul`` (an XLA dot
         on the TPU too), then dI; the kept SOC block from
         ``cones.w2_soc_dense``.  The factor and the solves run in
         ``ops/ldl.py`` (the leaf, GEMM and inverse-solve kernels).

Every sum over a static index map runs in a fixed order (``segsum``), so
a solve on the card gives the same bits on every run.

Iterative refinement runs against the exact regularized operator with the
dense equilibrated G and A (``torch.matmul``, as the JAX package computes
them on the CPU), in the reference's residual-first order, with per-lane
and per-column stopping.

Other configurations raise ``NotImplementedError`` naming the slice they
belong to; nothing falls back silently.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cones
from .ops.band import band_factor, band_solve
from .ops.band_ldl import B, KP
from .ops.ldl import ldl_factor, ldl_solve, pad_to_block
from .segsum import SegmentSum, segment_map, segment_sum
from .structure import ProblemStructure

# host synchronisations of the solve loops (one per ``all_true`` call)
host_syncs = 0


def all_true(t: torch.Tensor) -> bool:
    """``bool(t.all())``: the one host synchronisation a solve loop makes
    per trip, counted in ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return bool(t.all())


def require_slice(st: ProblemStructure, settings) -> None:
    """Raise unless (structure, settings) lies on the ported slices: f64,
    128-blocks, and either "reduced" on the inverse solve path or
    "banded" with an LP cone, block bandwidth 1 and every G row in the
    gsplit's singleton or scatter rows."""
    if settings.kkt_strategy in ("full", "normal"):
        raise NotImplementedError(
            f"kkt_strategy={settings.kkt_strategy!r}: the 'full' and "
            "'normal' dense strategies are a later slice of the port (only "
            "'banded' and 'reduced' are ported)")
    if settings.factor_dtype != "float64":
        raise NotImplementedError(
            "factor_dtype='float32': the mixed-precision slice (the f32 "
            "leaf kernel K11) is not ported yet")
    if settings.block != B:
        raise NotImplementedError(f"LDL^T block size must be {B}")
    if settings.kkt_strategy == "reduced":
        if settings.dense_solve == "subst":
            raise NotImplementedError(
                "dense_solve='subst': the substitution kernels (K15/K16, "
                "pallas_dense_ds) are a later slice of the port; 'inverse' "
                "and 'auto' run the inverse path")
        return
    plan = st.band
    if plan is None:
        raise ValueError(
            "kkt_strategy='banded' needs structure.with_band_plan(...)")
    if getattr(plan, "keep_soc", False) or st.n_sc:
        raise NotImplementedError(
            "second-order cones under 'banded' (keep_soc plans included): "
            "the SOCP lane is the next slice of the port")
    if plan.bwb != 1:
        raise NotImplementedError(
            f"block bandwidth {plan.bwb}: the bwb 2-6 band kernels are a "
            "later slice of the port (only bwb = 1 is ported)")
    if plan.block != B:
        raise NotImplementedError(f"band block size must be {B}")
    if plan.dim != pad_to_block(st.n + st.p, B):
        raise ValueError(f"band plan covers {plan.dim} rows, expected "
                         f"{pad_to_block(st.n + st.p, B)}")
    split = st.gsplit
    if split is None or not (split.n_sing or split.n_spr):
        raise NotImplementedError(
            "banded strategy without singleton/scatter rows "
            "(structure.with_gsplit): the dense H assembly is a later "
            "slice of the port")
    if split.dense_rows:
        raise NotImplementedError(
            "gsplit dense rows (LP rows with more than spr_width nonzeros): "
            "the dense H assembly is a later slice of the port")


# ------------------------------------------------------ static index maps

def _band_gather(n: int, p: int, Dp: int, perm: np.ndarray):
    """Static maps of the lane-invariant band base: for each position of
    the (nb, B, B) diagonal and sub-diagonal blocks, whether it holds an H
    entry (``from_h``, filled by the scatter) and otherwise its index into
    the flat [A.ravel() | (-delta, 0, 1)] source
    (``eicos_tpu.kkt._band_gather_split`` at bwb = 1, ms = 0)."""
    D = n + p
    base_A = n * n
    c_negd = base_A + p * n
    c_zero, c_one = c_negd + 1, c_negd + 2

    def src_block(ivec, jvec):
        ii = ivec[:, None].astype(np.int64)
        jj = jvec[None, :].astype(np.int64)
        is_x_i, is_x_j = ii < n, jj < n
        is_y_i = (ii >= n) & (ii < D)
        is_y_j = (jj >= n) & (jj < D)
        out = np.full((len(ivec), len(jvec)), c_zero, np.int64)
        out = np.where(is_x_i & is_x_j, ii * n + jj, out)
        out = np.where(is_x_i & is_y_j, base_A + (jj - n) * n + ii, out)
        out = np.where(is_y_i & is_x_j, base_A + (ii - n) * n + jj, out)
        diag = ii == jj
        out = np.where(diag & is_y_i, c_negd, out)
        return np.where(diag & (ii >= D), c_one, out)

    nb = Dp // B
    idx_diag = np.empty((nb, B, B), np.int64)
    idx_sub = np.full((nb, B, B), c_zero, np.int64)
    for k in range(nb):
        rows = perm[k * B:(k + 1) * B]
        idx_diag[k] = src_block(rows, rows)
        if k:
            idx_sub[k] = src_block(rows, perm[(k - 1) * B:k * B])

    def split(idx):
        from_h = idx < base_A
        return from_h, np.where(from_h, 0, idx - base_A)

    return split(idx_diag), split(idx_sub)


def _band_scatter_idx(n: int, Dp: int, perm: np.ndarray, split) -> np.ndarray:
    """Flat targets in a per-lane [diag | sub] buffer of 2 nb B B values
    for the H contributions [spr (n_spr w w) | sing (n_sing) | dI (n)]
    (``eicos_tpu.kkt._band_scatter_idx``, LP part).  Contributions above
    the band or on a padding column go to the dump slot nb B B."""
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    nbb = (Dp // B) * B * B
    dump = nbb

    def pos(i, j):
        bad = (i >= n) | (j >= n)
        pi = iperm[np.minimum(i, n - 1)]
        pj = iperm[np.minimum(j, n - 1)]
        bi, bj = pi // B, pj // B
        flat = (bi * B + pi % B) * B + pj % B
        out = np.where(bi == bj, flat,
                       np.where(bi == bj + 1, nbb + flat, dump))
        return np.where(bad, dump, out)

    parts = []
    if split.spr_width:
        cols2 = np.asarray(split.spr_cols, np.int64).reshape(
            -1, split.spr_width)
        parts.append(pos(cols2[:, :, None], cols2[:, None, :]).ravel())
    sc = np.asarray(split.sing_cols, np.int64)
    if sc.size:
        parts.append(pos(sc, sc))
    parts.append(pos(np.arange(n), np.arange(n)))
    return np.concatenate(parts)


class SplitMaps(NamedTuple):
    """The gsplit's row lists on the device."""

    sing: torch.Tensor    # singleton rows of G and their columns
    scol: torch.Tensor
    spr: torch.Tensor     # scatter rows of G and their (padded) columns
    cols2: torch.Tensor
    dense: torch.Tensor   # the remaining LP rows


@functools.lru_cache(maxsize=16)
def split_maps(st: ProblemStructure, device: str) -> Optional[SplitMaps]:
    split = st.gsplit
    if split is None:
        return None

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), dtype=torch.int64,
                               device=device)

    return SplitMaps(
        sing=t(split.sing_rows), scol=t(split.sing_cols),
        spr=t(split.spr_rows),
        cols2=t(np.asarray(split.spr_cols, np.int64).reshape(
            -1, max(split.spr_width, 1))),
        dense=t(split.dense_rows))


class BandMaps(NamedTuple):
    Dp: int
    perm: torch.Tensor    # (Dp,) new -> old
    iperm: torch.Tensor   # (Dp,) old -> new
    scatter: SegmentSum   # the H contributions' sums, dump slot dropped
    dmask: torch.Tensor   # (nb, B, B) True where the diag block holds H
    dio: torch.Tensor     # (nb, B, B) index into [A.ravel() | consts]
    smask: torch.Tensor   # same for the sub-diagonal blocks
    sio: torch.Tensor


@functools.lru_cache(maxsize=16)
def band_maps(st: ProblemStructure, device: str) -> BandMaps:
    """The static maps of ``st``'s banded plan, on ``device``."""
    n, p = st.n, st.p
    perm = np.asarray(st.band.perm, np.int64)
    Dp = len(perm)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(Dp)
    (dmask, dio), (smask, sio) = _band_gather(n, p, Dp, perm)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    idx = _band_scatter_idx(n, Dp, perm, st.gsplit)
    dump = (Dp // B) * B * B
    return BandMaps(
        Dp=Dp, perm=t(perm), iperm=t(iperm),
        scatter=segment_map(idx, device, keep=idx != dump),
        dmask=t(dmask, torch.bool), dio=t(dio),
        smask=t(smask, torch.bool), sio=t(sio))


class DenseMaps(NamedTuple):
    """Static layout of the reduced strategy's dense K over
    [z_soc | x | y]: ms kept SOC rows, me eliminated (LP) rows, and the
    fixed-order sums of the gsplit's H contributions: ``hs`` of the
    scatter rows' flattened (n_spr, w, w) values into flat (Dp * Dp)
    positions of K, those whose two columns are real (a padded column
    contributes 0 to a row and column that the reference crops), and
    ``hd`` of the singleton rows' values onto the diagonal of H."""

    Dp: int
    ms: int
    me: int
    hs: Optional[SegmentSum]
    hd: Optional[SegmentSum]


@functools.lru_cache(maxsize=16)
def dense_maps(st: ProblemStructure, device: str) -> DenseMaps:
    n, p = st.n, st.p
    ms = st.m - st.l          # "reduced" keeps every SOC row
    Dp = pad_to_block(ms + n + p, B)
    split = st.gsplit
    hs = hd = None
    if split is not None and split.n_spr:
        cols2 = np.asarray(split.spr_cols, np.int64).reshape(
            -1, split.spr_width)
        ci = np.broadcast_to(cols2[:, :, None], (*cols2.shape,
                                                 split.spr_width)).ravel()
        cj = np.broadcast_to(cols2[:, None, :], (*cols2.shape[:1],
                                                 split.spr_width,
                                                 split.spr_width)).ravel()
        hs = segment_map((ms + ci) * Dp + ms + cj, device,
                         keep=(ci < n) & (cj < n))
    if split is not None and split.n_sing:
        hd = segment_map(split.sing_cols, device)
    return DenseMaps(Dp=Dp, ms=ms, me=st.l, hs=hs, hd=hd)


# ---------------------------------------------------------------- context

class KKTContext(NamedTuple):
    """Per-solve constants: equilibrated G, A ((m, n), (p, n) shared or
    with a leading lane axis), the static maps, the lane-invariant base of
    the factored matrix (``Kd0``/``Ks0`` for "banded", ``K0`` for
    "reduced") and the iteration-invariant coefficients of the gsplit's
    H contributions."""

    G: torch.Tensor
    A: torch.Tensor
    split: Optional[SplitMaps]
    spr_outer: Optional[torch.Tensor]   # ([L,] n_spr, w, w) g_i g_j
    sing_sq: Optional[torch.Tensor]     # ([L,] n_sing) g^2
    band: Optional[BandMaps] = None
    Kd0: Optional[torch.Tensor] = None  # ([L,] nb, B, B) A, -dI, padding
    Ks0: Optional[torch.Tensor] = None
    dense: Optional[DenseMaps] = None
    K0: Optional[torch.Tensor] = None   # ([L,] Dp, Dp)


def make_context(st: ProblemStructure, G, A, settings) -> KKTContext:
    require_slice(st, settings)
    dev = str(G.device)
    split = split_maps(st, dev)
    spr_outer = sing_sq = None
    if split is not None and st.gsplit.n_spr:
        Gpad = torch.cat([G, G.new_zeros(*G.shape[:-1], 1)], -1)
        C = Gpad[..., split.spr[:, None], split.cols2]   # ([L,] n_spr, w)
        spr_outer = C[..., :, :, None] * C[..., :, None, :]
    if split is not None and st.gsplit.n_sing:
        coef = G[..., split.sing, split.scol]
        sing_sq = coef * coef
    ctx = KKTContext(G=G, A=A, split=split, spr_outer=spr_outer,
                     sing_sq=sing_sq)
    delta = settings.deltastat
    lead = A.shape[:-2]
    if settings.kkt_strategy == "reduced":
        dm = dense_maps(st, dev)
        n, p, ms, l = st.n, st.p, dm.ms, st.l
        D = ms + n + p
        # z_soc and x diagonals are written per factor; -dI on y; 1 padding
        diag0 = G.new_zeros(dm.Dp)
        diag0[ms + n:D] = -delta
        diag0[D:] = 1.0
        K0 = torch.diag_embed(diag0.expand(*lead, dm.Dp)).contiguous()
        if ms:
            K0[..., :ms, ms:ms + n] = G[..., l:, :]
            K0[..., ms:ms + n, :ms] = G[..., l:, :].transpose(-1, -2)
        if p:
            K0[..., ms:ms + n, ms + n:D] = A.transpose(-1, -2)
            K0[..., ms + n:D, ms:ms + n] = A
        return ctx._replace(dense=dm, K0=K0)
    maps = band_maps(st, dev)
    consts = torch.tensor([-delta, 0.0, 1.0], dtype=G.dtype, device=G.device)
    other = torch.cat([A.reshape(*lead, -1), consts.expand(*lead, 3)], -1)
    return ctx._replace(band=maps,
                        Kd0=torch.where(maps.dmask, 0.0, other[..., maps.dio]),
                        Ks0=torch.where(maps.smask, 0.0,
                                        other[..., maps.sio]))


def _band_scatter_vals(st, ctx: KKTContext, winv_lp, delta):
    """Per-lane H contributions ordered as the scatter targets:
    [spr | sing | dI]."""
    lanes = winv_lp.shape[0]
    vals = []
    if ctx.spr_outer is not None:
        vals.append(_spr_vals(ctx, winv_lp).reshape(lanes, -1))
    if ctx.sing_sq is not None:
        vals.append(_sing_vals(ctx, winv_lp))
    vals.append(winv_lp.new_full((lanes, st.n), delta))
    return torch.cat(vals, -1)


def _spr_vals(ctx: KKTContext, winv_lp):
    """(L, n_spr, w, w): w_r g_i g_j of every scatter row r."""
    return ctx.spr_outer * winv_lp[:, ctx.split.spr][:, :, None, None]


def _sing_vals(ctx: KKTContext, winv_lp):
    """(L, n_sing): w_r g^2 of every singleton row r."""
    return (ctx.sing_sq * winv_lp[:, ctx.split.sing]).expand(
        winv_lp.shape[0], -1)


def band_blocks(st, ctx: KKTContext, winv_lp, delta):
    """The per-lane band blocks (Kd, Ks), each (L, nb, B, B): the base
    plus the scattered H contributions."""
    lanes = winv_lp.shape[0]
    Dp = ctx.band.Dp
    nbb = (Dp // B) * B * B
    buf = winv_lp.new_zeros(lanes, 2 * nbb)
    buf[:, ctx.band.scatter.targets] = segment_sum(
        ctx.band.scatter, _band_scatter_vals(st, ctx, winv_lp, delta))
    bufb = buf.view(lanes, 2, Dp // B, B, B)
    return ctx.Kd0 + bufb[:, 0], ctx.Ks0 + bufb[:, 1]


def dense_matrix(st, ctx: KKTContext, scal: Optional[cones.Scaling],
                 winv_lp, delta):
    """The per-lane reduced K (L, Dp, Dp) for the current scaling
    (``eicos_tpu.kkt``'s H assembly and ``_assemble_dense``), in the
    reference's order of summation: H = [Gd' W^-1 Gd] + Hs + diag(hdiag
    + d), where Hs (the scatter rows) and hdiag (the singleton rows)
    are sums into zeros."""
    lanes = winv_lp.shape[0]
    dm = ctx.dense
    n, ms, me = st.n, dm.ms, dm.me
    G = ctx.G
    K = ctx.K0.expand(lanes, dm.Dp, dm.Dp).clone()
    Hx = K[:, ms:ms + n, ms:ms + n]          # zero in K0
    split = ctx.split
    hdiag = 0.0
    if me and (split is None or not (st.gsplit.n_sing or st.gsplit.n_spr)):
        Ge = G[..., :me, :]
        Hx.copy_(Ge.transpose(-1, -2) @ (Ge * winv_lp[:, :, None]))
    elif me:
        if split.dense.numel():
            Gd = G[..., split.dense, :]
            Hx.copy_(Gd.transpose(-1, -2)
                     @ (Gd * winv_lp[:, split.dense][:, :, None]))
        if dm.hs is not None:
            Kf = K.view(lanes, -1)
            Kf[:, dm.hs.targets] += segment_sum(
                dm.hs, _spr_vals(ctx, winv_lp).reshape(lanes, -1))
        hdiag = winv_lp.new_zeros(lanes, n)
        if dm.hd is not None:
            hdiag[:, dm.hd.targets] = segment_sum(dm.hd,
                                                  _sing_vals(ctx, winv_lp))
    Hx.diagonal(dim1=-2, dim2=-1).add_(hdiag + delta)
    if ms:
        eye = torch.eye(ms, dtype=K.dtype, device=K.device)
        W2s = eye if scal is None else cones.w2_soc_dense(st.cone, scal)
        K[:, :ms, :ms] = -(W2s + delta * eye)
    return K


def factor(st: ProblemStructure, ctx: KKTContext,
           scal: Optional[cones.Scaling], settings, lanes: int):
    """Assemble and factor for the current NT scaling (None = identity
    scalings, the init factorization).  Returns
    ``solve_exact(rhs) -> (dx, dy, dz)`` for packed right-hand sides
    (L, k, n+p+m), one solve of the factored system without refinement."""
    n, p = st.n, st.p
    delta = settings.deltastat
    G = ctx.G
    if scal is None:
        winv_lp = G.new_full((lanes, st.l), 1.0 / (1.0 + delta))
    else:
        winv_lp = 1.0 / (scal.v_lp + delta)
    if settings.kkt_strategy == "reduced":
        return _factor_reduced(st, ctx, scal, winv_lp, delta)

    maps = ctx.band
    D = n + p
    Kd, Ks = band_blocks(st, ctx, winv_lp, delta)
    fac = band_factor(Kd, Ks)
    Gt = G.transpose(-1, -2)

    def solve_exact(rhs):
        k = rhs.shape[1]
        if k > KP:
            raise ValueError(f"at most {KP} right-hand sides, got {k}")
        bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]
        r1 = bx + (bz * winv_lp[:, None, :]) @ G
        rr = torch.cat([r1, by, rhs.new_zeros(*rhs.shape[:-1], maps.Dp - D)],
                       -1)
        x = band_solve(fac, rr[..., maps.perm])[..., maps.iperm]
        dx, dy = x[..., :n], x[..., n:D]
        dz = (dx @ Gt - bz) * winv_lp[:, None, :]
        return dx, dy, dz

    return solve_exact


def _factor_reduced(st, ctx: KKTContext, scal, winv_lp, delta):
    """The "reduced" arm of ``eicos_tpu.kkt.factor``: dense K over
    [z_soc | x | y], ``ldl_factor``, and a ``solve_exact`` that eliminates
    the LP rows around ``ldl_solve``."""
    n, p = st.n, st.p
    dm = ctx.dense
    ms, me = dm.ms, dm.me
    D = ms + n + p
    fac = ldl_factor(dense_matrix(st, ctx, scal, winv_lp, delta))
    Ge = ctx.G[..., :me, :]

    def solve_exact(rhs):
        k = rhs.shape[1]
        if k > KP:
            raise ValueError(f"at most {KP} right-hand sides, got {k}")
        bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]
        bz_e, bz_s = bz[..., :me], bz[..., me:]
        r1 = bx + (bz_e * winv_lp[:, None, :]) @ Ge if me else bx
        rr = torch.cat([bz_s, r1, by,
                        rhs.new_zeros(*rhs.shape[:-1], dm.Dp - D)], -1)
        x = ldl_solve(fac, rr)
        dx, dy = x[..., ms:ms + n], x[..., ms + n:D]
        if me:
            dz_e = (dx @ Ge.transpose(-1, -2) - bz_e) * winv_lp[:, None, :]
        else:
            dz_e = bz_e
        return dx, dy, torch.cat([dz_e, x[..., :ms]], -1)

    return solve_exact


class KKTSolveResult(NamedTuple):
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    nitref: torch.Tensor  # (L, k) int32 refinement count


def solve_refined(st: ProblemStructure, ctx: KKTContext, solve_exact,
                  scal: Optional[cones.Scaling], rhs, settings,
                  active: Optional[torch.Tensor] = None) -> KKTSolveResult:
    """Backsolve + iterative refinement against the exact regularized
    operator (EiCOS solveKKT): up to ``nitref`` corrections per column,
    undo on regression, threshold and weak-progress stops.

    ``rhs`` is (L, k, n+p+m).  Each column of each lane stops on its own,
    as the JAX package's vmapped loop does; ``active`` (L,) marks the lanes
    whose result is used (the others start stopped)."""
    n, p, m = st.n, st.p, st.m
    delta = settings.deltastat
    G, A = ctx.G, ctx.A
    Gt, At = G.transpose(-1, -2), A.transpose(-1, -2)
    lanes, K = rhs.shape[0], rhs.shape[1]
    bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]

    def residual(dx, dy, dz):
        # ex = bx - G'dz - d dx - A'dy;  ey = by - A dx + d dy;
        # ez = bz - G dx + W^2 dz + d dz
        ex = bx - (dz @ G if m else 0.0) - delta * dx
        if p:
            ex = ex - dy @ A
        ey = (by - dx @ At + delta * dy) if p else by
        if m:
            Wdz = dz if scal is None else cones.scale2(st.cone, scal, dz)
            ez = bz - dx @ Gt + Wdz + delta * dz
        else:
            ez = bz
        nerr = ex.abs().amax(-1) if n else rhs.new_zeros(lanes, K)
        if m:
            nerr = torch.maximum(nerr, ez.abs().amax(-1))
        if p:
            nerr = torch.maximum(nerr, ey.abs().amax(-1))
        return ex, ey, ez, nerr

    dx, dy, dz = solve_exact(rhs)
    thresh = (1.0 + rhs.abs().amax(-1)) * settings.linsysacc
    nitref = settings.nitref
    irerrfact = settings.irerrfact

    cx, cy, cz = (torch.zeros_like(dx), torch.zeros_like(dy),
                  torch.zeros_like(dz))
    nerr_prev = rhs.new_full((lanes, K), torch.inf)
    kk = torch.zeros((lanes, 1), dtype=torch.int32, device=rhs.device)
    kout = torch.zeros((lanes, K), dtype=torch.int32, device=rhs.device)
    done = torch.zeros((lanes, K), dtype=torch.bool, device=rhs.device)
    if active is not None:
        done = done | ~active[:, None]
    while not all_true(done):
        ex, ey, ez, nerr = residual(dx, dy, dz)
        act = ~done
        undo = act & (kk > 0) & (nerr > nerr_prev)
        stop = act & (undo | (kk == nitref) | (nerr < thresh)
                      | ((kk > 0) & (nerr_prev < irerrfact * nerr)))
        rx, ry, rz = solve_exact(torch.cat([ex, ey, ez], -1))
        um = undo[..., None]
        advm = (act & ~stop)[..., None]

        def step(cur, corr_old, corr_new):
            new = torch.where(um, cur - corr_old,
                              torch.where(advm, cur + corr_new, cur))
            return new, torch.where(advm, corr_new, corr_old)

        dx, cx = step(dx, cx, rx)
        dy, cy = step(dy, cy, ry)
        dz, cz = step(dz, cz, rz)
        nerr_prev = torch.where(act, nerr, nerr_prev)
        kout = torch.where(act, torch.where(undo, kk - 1, kk), kout)
        # a lane's loop counter only runs while one of its columns does
        kk = kk + act.any(-1, keepdim=True).to(kk.dtype)
        done = done | stop
    return KKTSolveResult(dx=dx, dy=dy, dz=dz, nitref=kout)
