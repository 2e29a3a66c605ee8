"""KKT assembly, band factor and solve with iterative refinement: the
banded strategy of ``eicos_tpu.kkt`` on its ``direct_band`` path, LP cone.

The factored system is the reduced quasidefinite KKT over [x | y],

    K = [ H    A' ]     H = G' (W^2 + dI)^{-1} G + dI,   d = deltastat
        [ A   -dI ]

with every G row eliminated exactly ((W^2 + dI)^{-1} is diagonal on the LP
cone), RCM-permuted by the structure's ``BandPlan`` into 128-blocks with
block bandwidth 1.  H is never formed: its contributions (one per
singleton row of G on the diagonal, a w x w outer product per few-nnz
"scatter row", and dI) are scattered straight into the per-lane diagonal
and sub-diagonal band blocks, on top of a lane-invariant base of A, -dI and
identity padding pivots (``eicos_tpu.kkt._band_scatter_idx`` and
``_band_gather_split``).  Contributions that land above the band or on a
padding column go to the dump slot, element (0, 0) of sub-diagonal block 0,
which the band factor never reads.

The factor and the two sweeps of each solve run in the kernels of
``ops/band.py`` for CUDA tensors and in their plain twins for CPU tensors.
Iterative refinement runs against the exact regularized operator with the
dense equilibrated G and A (``torch.matmul``, as the JAX package computes
them on the CPU), in the reference's residual-first order, with per-lane
and per-column stopping.

Other structures raise ``NotImplementedError`` naming the slice they
belong to; nothing falls back silently.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cones
from .ops.band import band_factor, band_solve
from .ops.band_ldl import B, KP, pad_to_block
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
    """Raise unless (structure, settings) lies on the ported slice: the
    banded strategy, f64, LP cone, block bandwidth 1 and every G row in
    the gsplit's singleton or scatter rows."""
    if settings.kkt_strategy != "banded":
        raise NotImplementedError(
            f"kkt_strategy={settings.kkt_strategy!r}: the dense strategies "
            "are the next slice of the port (only 'banded' is ported)")
    if settings.factor_dtype != "float64":
        raise NotImplementedError(
            "factor_dtype='float32': the mixed-precision slice is not "
            "ported yet")
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
    if plan.block != B or settings.block != B:
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


class BandMaps(NamedTuple):
    Dp: int
    perm: torch.Tensor    # (Dp,) new -> old
    iperm: torch.Tensor   # (Dp,) old -> new
    scatter: torch.Tensor  # flat scatter targets of the H contributions
    dmask: torch.Tensor   # (nb, B, B) True where the diag block holds H
    dio: torch.Tensor     # (nb, B, B) index into [A.ravel() | consts]
    smask: torch.Tensor   # same for the sub-diagonal blocks
    sio: torch.Tensor
    sing: torch.Tensor    # singleton rows of G and their columns
    scol: torch.Tensor
    spr: torch.Tensor     # scatter rows of G and their (padded) columns
    cols2: torch.Tensor


@functools.lru_cache(maxsize=16)
def band_maps(st: ProblemStructure, device: str) -> BandMaps:
    """The static maps of ``st``'s banded plan, on ``device``."""
    n, p = st.n, st.p
    perm = np.asarray(st.band.perm, np.int64)
    Dp = len(perm)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(Dp)
    split = st.gsplit
    (dmask, dio), (smask, sio) = _band_gather(n, p, Dp, perm)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BandMaps(
        Dp=Dp, perm=t(perm), iperm=t(iperm),
        scatter=t(_band_scatter_idx(n, Dp, perm, split)),
        dmask=t(dmask, torch.bool), dio=t(dio),
        smask=t(smask, torch.bool), sio=t(sio),
        sing=t(np.asarray(split.sing_rows, np.int64)),
        scol=t(np.asarray(split.sing_cols, np.int64)),
        spr=t(np.asarray(split.spr_rows, np.int64)),
        cols2=t(np.asarray(split.spr_cols, np.int64).reshape(
            -1, max(split.spr_width, 1))))


# ---------------------------------------------------------------- context

class KKTContext(NamedTuple):
    """Per-solve constants: equilibrated G, A ((m, n), (p, n) shared or
    with a leading lane axis), the static maps, the lane-invariant band
    base and the iteration-invariant coefficients of the H scatter."""

    G: torch.Tensor
    A: torch.Tensor
    maps: BandMaps
    Kd0: torch.Tensor    # ([L,] nb, B, B) A, -dI and padding pivots
    Ks0: torch.Tensor
    spr_outer: Optional[torch.Tensor]   # ([L,] n_spr, w, w) g_i g_j
    sing_sq: Optional[torch.Tensor]     # ([L,] n_sing) g^2


def make_context(st: ProblemStructure, G, A, settings) -> KKTContext:
    require_slice(st, settings)
    maps = band_maps(st, str(G.device))
    delta = settings.deltastat
    consts = torch.tensor([-delta, 0.0, 1.0], dtype=G.dtype,
                          device=G.device)
    other = torch.cat([A.reshape(*A.shape[:-2], -1),
                       consts.expand(*A.shape[:-2], 3)], -1)
    Kd0 = torch.where(maps.dmask, 0.0, other[..., maps.dio])
    Ks0 = torch.where(maps.smask, 0.0, other[..., maps.sio])
    split = st.gsplit
    spr_outer = sing_sq = None
    if split.n_spr:
        Gpad = torch.cat([G, G.new_zeros(*G.shape[:-1], 1)], -1)
        C = Gpad[..., maps.spr[:, None], maps.cols2]     # ([L,] n_spr, w)
        spr_outer = C[..., :, :, None] * C[..., :, None, :]
    if split.n_sing:
        coef = G[..., maps.sing, maps.scol]
        sing_sq = coef * coef
    return KKTContext(G=G, A=A, maps=maps, Kd0=Kd0, Ks0=Ks0,
                      spr_outer=spr_outer, sing_sq=sing_sq)


def _band_scatter_vals(st, ctx: KKTContext, winv_lp, delta):
    """Per-lane H contributions ordered as the scatter targets:
    [spr | sing | dI]."""
    lanes = winv_lp.shape[0]
    vals = []
    if ctx.spr_outer is not None:
        P = ctx.spr_outer * winv_lp[:, ctx.maps.spr][:, :, None, None]
        vals.append(P.reshape(lanes, -1))
    if ctx.sing_sq is not None:
        vals.append((ctx.sing_sq * winv_lp[:, ctx.maps.sing]).expand(
            lanes, -1))
    vals.append(winv_lp.new_full((lanes, st.n), delta))
    return torch.cat(vals, -1)


def band_blocks(st, ctx: KKTContext, winv_lp, delta):
    """The per-lane band blocks (Kd, Ks), each (L, nb, B, B): the base
    plus the scattered H contributions."""
    lanes = winv_lp.shape[0]
    Dp = ctx.maps.Dp
    nbb = (Dp // B) * B * B
    buf = winv_lp.new_zeros(lanes, 2 * nbb).index_add_(
        1, ctx.maps.scatter, _band_scatter_vals(st, ctx, winv_lp, delta))
    bufb = buf.view(lanes, 2, Dp // B, B, B)
    return ctx.Kd0 + bufb[:, 0], ctx.Ks0 + bufb[:, 1]


def factor(st: ProblemStructure, ctx: KKTContext,
           scal: Optional[cones.Scaling], settings, lanes: int):
    """Assemble and factor the band for the current NT scaling (None =
    identity scalings, the init factorization).  Returns
    ``solve_exact(rhs) -> (dx, dy, dz)`` for packed right-hand sides
    (L, k, n+p+m), one band solve without refinement."""
    n, p = st.n, st.p
    D = n + p
    delta = settings.deltastat
    G = ctx.G
    maps = ctx.maps
    if scal is None:
        winv_lp = G.new_full((lanes, st.l), 1.0 / (1.0 + delta))
    else:
        winv_lp = 1.0 / (scal.v_lp + delta)

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
