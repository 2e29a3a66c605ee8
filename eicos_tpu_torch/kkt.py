"""KKT assembly, factor and solve with iterative refinement: the four
strategies of ``eicos_tpu.kkt``: "banded" (LP and second-order cones, any
block bandwidth, f64 or f32) and the dense "reduced", "normal" and
"full".

"banded", "reduced" and "normal" factor a quasidefinite system over
[z_soc | x | y] in which the rows of G whose cone block has a closed-form
inverse are eliminated exactly: the LP rows always ((W^2 + dI)^{-1} is
diagonal there, d = deltastat), and under "normal" and under "banded"
without a ``keep_soc`` plan the SOC rows too (a 2x2 Woodbury per cone,
``cones.scale2reg_inv_soc``).  With G_e the eliminated and G_s the kept
rows, H = G_e' (W_e^2 + dI)^{-1} G_e + dI:

             [ -(W_s^2 + dI)   G_s   0  ]
         K = [  G_s'           H     A' ]
             [  0              A    -dI ]

banded   K is RCM-permuted by the structure's ``BandPlan`` into blocks of
         ``Settings.block`` with block bandwidth bwb, factored and solved
         in ``ops/band.py``: by the band kernels at 128-blocks, bwb 1..6,
         in f64, and by the scan of ``ops/band_ldl.py`` (batched
         ``torch.matmul`` products and the leaf kernel, the plain leaf off
         128) where the reference runs its XLA scan, at bwb above 6, off
         128 or under ``factor_dtype="float32"``; ``Settings.band_gemm``
         sets the scan's product type and nothing else, as in the
         reference.  Three ways to the band blocks, as in
         ``eicos_tpu.kkt.factor``:

         direct scatter (f64, 128-blocks, bwb 1..6, the band kernels'
         widths, every eliminated LP row a singleton or scatter row of
         the gsplit, cones on narrow ``SOCSplit`` supports):
         H is never formed; its contributions (one per singleton row on
         the diagonal, a w x w outer product per scatter row, dI, and per
         cone either the eliminating closed form or, on a ``keep_soc``
         plan, the kept block and its coupling) are summed straight into
         the diagonal and the bwb sub-diagonal blocks, on top of a
         lane-invariant base of A, -dI and identity padding pivots.
         Contributions that land above the band or on a padding column,
         which the reference sends to a dump slot the band factor never
         reads, are dropped.  The JAX package scatters at bwb 1 only; the
         port's maps and sums at bwb 1 are the reference's.
         The kept rows are in each cone's eigenbasis of W_s^2: the factor
         holds R K R', R = diag(rot, I, I), a diagonal kept block
         -(diag(lam) + dI) and the coupling rot G_s, and ``solve_exact``
         rotates the kept rows in and out (``_soc_kept_vals``; the JAX
         package factors the NT-scaled S K S, S = diag(W_s^-1, I, I), on
         its TPU path and the unscaled K on its CPU).

         gathered from H (any bwb, no kept cones): the dense per-lane
         H (n, n) is assembled as for "reduced" and the blocks Kd (L, nb,
         B, B), Ksubs (L, nb, bwb, B, B) are gathered from H.ravel() and
         the shared [A.ravel() | (-d, 0, 1)] by static maps.

         gathered from K (a ``keep_soc`` plan off the scatter path: bwb
         above 6, an f32 factor, no gsplit): the unscaled dense K of
         "reduced", its permuted blocks gathered.

reduced  the dense (Dp, Dp) K with the SOC rows kept, on a lane-invariant
         base ``K0`` (``eicos_tpu.kkt.make_context``).  The factor and the
         solves run in ``ops/ldl.py``.

normal   the same with every cone row eliminated: K over [x | y].

full     nothing eliminated: the dense K over [z | x | y] (the
         reference's elimination order), -(W^2 + dI) from
         ``cones.w2_dense`` on a base that holds G, A, dI and -dI.

The dense strategies solve on one of two paths (``_use_subst``, as
``eicos_tpu.kkt._use_subst``): the explicit inverse (``ldl_factor``: the
leaf, GEMM and inverse-solve kernels) or the substitution form
(``ldl_factor_subst``: the leaf and GEMM kernels, the pack and the two
sweeps of ``ops/dense.py``).  ``dense_solve="auto"`` follows the device of
the tensors, as every dispatch of the port does: on a CUDA tensor "reduced"
and "normal" take the substitution form, as on the TPU, and on a CPU
tensor the inverse, as the JAX package does there; "full" stays on the
inverse unless "subst" is asked for.  "subst" on a CPU tensor runs the
plain versions of the pack and the sweeps.

``factor_dtype="float32"`` factors and solves in f32: G, the scalings, H
and K (or the band blocks) are cast as the reference casts them, the leaf
is the f32 leaf kernel, the products are ``torch.matmul``, the dense
strategies take the inverse path, "banded" the scan, and the directions
are cast back for the f64 refinement.

The dense H is written per factor in the reference's order of summation:
the gsplit's dense rows (or every eliminated row without a gsplit) by one
``torch.matmul`` (an XLA dot outside any kernel on the TPU too), then the
scatter rows, the singleton rows and dI.

Every sum over a static index map runs in a fixed order (``segsum``), so
a solve on the card gives the same bits on every run.

The dense strategies run at any ``Settings.block`` as the JAX package
does: off 128 the recursion's leaves are the plain leaf on every device
(the reference reaches no Pallas leaf there) and the solves take the
inverse path.

Iterative refinement runs against the exact regularized operator with
per-lane and per-column stopping.  Its big products, and those of the
LP-row elimination and of computeResiduals, take the operands of
``make_sliced`` on a CUDA tensor, as the JAX package's TPU path does: the
gather kernel (``ops/spmv.py``) where the pattern is narrow, dgemm where it
is not, and the refinement loop rotated.  On a CPU tensor they are the
dense equilibrated G and A (``torch.matmul``, as the JAX package computes
them on its CPU) in the reference's residual-first order.  Nothing falls
back silently.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cones, graphs
from .ops.band import (BW_MAX, band_factor, band_solve, scan, sweep_kt,
                       sweep_ring)
from .ops.band_ldl import B, KP
from .ops import kernels, soc
from .ops.gemm import matmul
from .ops.ldl import ldl_factor, ldl_factor_subst, ldl_solve, pad_to_block
from .ops.spmv import SparseOperand, SparsePattern, csc_table, fused_tail
from .segsum import SegmentSum, segment_map, segment_sum
from .structure import ProblemStructure

# host synchronisations of the solve loops (one per ``all_true`` call; a
# sharded solve counts from one thread per device, under the lock)
host_syncs = 0
_SYNC_LOCK = threading.Lock()


def all_true(t: torch.Tensor) -> bool:
    """``bool(t.all())``: the one host synchronisation a solve loop driven
    from the host makes per trip, counted in ``host_syncs``.  A kept
    program's composed solve makes none: S2 tests the same flag on the card
    (``ops/graph_loop.py``)."""
    global host_syncs
    with _SYNC_LOCK:
        host_syncs += 1
    return bool(t.all())


def _keep_soc(st: ProblemStructure, settings) -> bool:
    """"reduced" keeps the SOC blocks in the factor, as does "banded" when
    its plan was built with ``keep_soc=True``; "normal" and a banded plan
    without it eliminate every cone row."""
    if st.n_sc == 0:
        return False
    if settings.kkt_strategy == "reduced":
        return True
    return bool(settings.kkt_strategy == "banded"
                and getattr(st.band, "keep_soc", False))


def _direct_band(st: ProblemStructure, settings) -> bool:
    """True where the H contributions scatter straight into the band
    blocks (``eicos_tpu.kkt.factor``'s ``direct_band``, which the JAX
    package takes at bandwidth 1 only): an f64 factor at a block
    bandwidth the band kernels take (1..``BW_MAX``), every eliminated LP
    row a singleton or scatter row of the gsplit, and narrow per-cone
    column supports (``SOCSplit``) where there are cones; blocks of 128,
    as the band kernels take."""
    split = st.gsplit
    return bool(1 <= st.band.bwb <= BW_MAX and st.band.block == B
                and settings.factor_dtype == "float64"
                and split is not None
                and not split.dense_rows and (split.n_sing or split.n_spr)
                and (st.n_sc == 0 or st.socsplit is not None))


def require_slice(st: ProblemStructure, settings) -> None:
    """Raise unless (structure, settings) can be solved: under "banded" a
    plan of ``settings.block``-blocks that covers the factored system."""
    if settings.kkt_strategy != "banded":
        return
    plan = st.band
    if plan is None:
        raise ValueError(
            "kkt_strategy='banded' needs structure.with_band_plan(...)")
    if plan.block != settings.block:
        raise ValueError(f"band plan of {plan.block}-blocks under "
                         f"Settings(block={settings.block})")
    ms = st.m - st.l if _keep_soc(st, settings) else 0
    want = pad_to_block(ms + st.n + st.p, plan.block)
    if plan.dim != want:
        raise ValueError(f"band plan covers {plan.dim} rows, expected "
                         f"{want}")


# ------------------------------------------------------ static index maps

def _band_gather_split(n: int, p: int, Dp: int, perm: np.ndarray,
                       bwb: int = 1, ms: int = 0, block: int = B):
    """Static maps of the gathered band blocks
    (``eicos_tpu.kkt._band_gather_idx`` and ``_band_gather_split``): for
    each position of the (nb, B, B) diagonal blocks and of the (nb, bwb, B,
    B) sub-diagonal blocks (block [k, j-1] is K[k, k-j]), a mask of the
    positions that hold an H entry, their index into the per-lane
    H.ravel(), and the others' index into the shared
    [A.ravel() | (-delta, 0, 1)].  Returns (diag maps, sub maps).

    ms == 0: K = [[H, A'], [A, -delta I]] over [x | y].  ms > 0 (kept
    cones): K over [z_soc | x | y]; the per-lane kept blocks at the
    z_soc coordinates map to the shared zero, and the direct scatter adds
    them.  Padding rows get identity pivots.  B is ``block``."""
    D = ms + n + p
    base_A = n * n
    c_negd = base_A + p * n
    c_zero, c_one = c_negd + 1, c_negd + 2
    x0, y0 = ms, ms + n

    def src_block(ivec, jvec):
        ii = ivec[:, None].astype(np.int64)
        jj = jvec[None, :].astype(np.int64)
        is_x_i, is_x_j = (ii >= x0) & (ii < y0), (jj >= x0) & (jj < y0)
        is_y_i, is_y_j = (ii >= y0) & (ii < D), (jj >= y0) & (jj < D)
        out = np.full((len(ivec), len(jvec)), c_zero, np.int64)
        out = np.where(is_x_i & is_x_j, (ii - x0) * n + (jj - x0), out)
        out = np.where(is_x_i & is_y_j, base_A + (jj - y0) * n + (ii - x0),
                       out)
        out = np.where(is_y_i & is_x_j, base_A + (ii - y0) * n + (jj - x0),
                       out)
        diag = ii == jj
        out = np.where(diag & is_y_i, c_negd, out)
        return np.where(diag & (ii >= D), c_one, out)

    nb = Dp // block
    idx_diag = np.empty((nb, block, block), np.int64)
    idx_subs = np.full((nb, bwb, block, block), c_zero, np.int64)
    for k in range(nb):
        rows = perm[k * block:(k + 1) * block]
        idx_diag[k] = src_block(rows, rows)
        for j in range(1, min(bwb, k) + 1):
            idx_subs[k, j - 1] = src_block(
                rows, perm[(k - j) * block:(k - j + 1) * block])

    def split(idx):
        from_h = idx < base_A
        return (from_h, np.where(from_h, idx, 0),
                np.where(from_h, 0, idx - base_A))

    return split(idx_diag), split(idx_subs)


def _soc_pad_maps(q: tuple, ms: int):
    """Static (n_sc, dmax) pad maps of the per-cone block assembly
    (``eicos_tpu.kkt._soc_pad_maps``): ``qidx`` maps (cone, slot) to its
    offset in the SOC segment (a pad to ms, where a zero-extended array
    reads 0) and ``valid`` marks the live slots."""
    qa = np.asarray(q, np.int64)
    dmax = int(qa.max())
    offs = np.concatenate([[0], np.cumsum(qa)[:-1]])
    slot = np.arange(dmax)[None, :]
    valid = slot < qa[:, None]
    return np.where(valid, offs[:, None] + slot, ms), valid


def _band_scatter_idx(n: int, Dp: int, perm: np.ndarray, split,
                      socsplit=None, keep_q: tuple = (),
                      bwb: int = 1) -> np.ndarray:
    """Flat targets in a per-lane [diag | subs] buffer of (1 + bwb) nb B B
    values for the contributions [spr (n_spr w w) | sing (n_sing) | dI (n)
    | soc] (``eicos_tpu.kkt._band_scatter_idx``, bwb 1): ``diag`` is laid
    out as the diagonal blocks (nb, B, B) and ``subs`` as the sub-diagonal
    blocks (nb, bwb, B, B), so that an entry at block distance
    bi - bj = j in 1..bwb lands in block [bi, j - 1].  Contributions above
    the band or on a padding column go to the dump slot nb B B (block
    [0, 0] of ``subs``, left of block column 0, which the factor never
    reads).  At bwb 1 the targets and the buffer are the reference's.

    The soc part is either the H contributions on the ``SOCSplit`` column
    supports (eliminating layout, (n_sc, w, w)) or, with ``keep_q`` (the
    cone dimensions of a ``keep_soc`` plan), the kept layout:
    the per-cone blocks (n_sc, dmax, dmax) at the z_soc coordinates and
    the coupling (n_sc, dmax, w) in both orientations, of which the one
    inside the stored band survives; x coordinates shift by
    ms = sum(keep_q)."""
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    nbb = (Dp // B) * B * B
    dump = nbb
    ms = int(sum(keep_q))

    def gpos(gi, gj, bad):
        # gi, gj: coordinates of K (arrays); bad marks pads
        pi = iperm[np.minimum(gi, len(perm) - 1)]
        pj = iperm[np.minimum(gj, len(perm) - 1)]
        bi, bj = pi // B, pj // B
        dist = bi - bj
        inner = (pi % B) * B + pj % B
        sub = nbb + ((bi * bwb + dist - 1) * B * B + inner)
        out = np.where(dist == 0, bi * B * B + inner,
                       np.where((dist >= 1) & (dist <= bwb), sub, dump))
        return np.where(bad, dump, out)

    def pos(i, j):
        # i, j: coordinates of H (the x block); n marks a padding column
        return gpos(ms + np.minimum(i, n - 1), ms + np.minimum(j, n - 1),
                    (i >= n) | (j >= n))

    parts = []
    if split.spr_width:
        cols2 = np.asarray(split.spr_cols, np.int64).reshape(
            -1, split.spr_width)
        parts.append(pos(cols2[:, :, None], cols2[:, None, :]).ravel())
    sc = np.asarray(split.sing_cols, np.int64)
    if sc.size:
        parts.append(pos(sc, sc))
    parts.append(pos(np.arange(n), np.arange(n)))
    if socsplit is not None:
        colsS = np.asarray(socsplit.cols, np.int64).reshape(
            -1, socsplit.width)
    if ms:
        qidx, valid = _soc_pad_maps(keep_q, ms)
        bad1 = ~valid                                    # (n_sc, dmax)
        zi = np.minimum(qidx, ms - 1)
        parts.append(gpos(zi[:, :, None], zi[:, None, :],
                          bad1[:, :, None] | bad1[:, None, :]).ravel())
        xj = ms + np.minimum(colsS, n - 1)
        bad2 = bad1[:, :, None] | (colsS >= n)[:, None, :]
        parts.append(gpos(zi[:, :, None], xj[:, None, :], bad2).ravel())
        parts.append(gpos(xj[:, None, :], zi[:, :, None], bad2).ravel())
    elif socsplit is not None:
        parts.append(pos(colsS[:, :, None], colsS[:, None, :]).ravel())
    return np.concatenate(parts)


class SplitMaps(NamedTuple):
    """The gsplit's row lists on the device."""

    sing: torch.Tensor    # singleton rows of G and their columns
    scol: torch.Tensor
    spr: torch.Tensor     # scatter rows of G and their (padded) columns
    cols2: torch.Tensor
    dense: torch.Tensor   # the remaining LP rows


def _t(a, device, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def split_maps(st: ProblemStructure, device: str) -> Optional[SplitMaps]:
    split = st.gsplit
    if split is None:
        return None
    return SplitMaps(
        sing=_t(split.sing_rows, device), scol=_t(split.sing_cols, device),
        spr=_t(split.spr_rows, device),
        cols2=_t(np.asarray(split.spr_cols, np.int64).reshape(
            -1, max(split.spr_width, 1)), device),
        dense=_t(split.dense_rows, device))


class BandMaps(NamedTuple):
    """Static maps of a banded plan: the permutation, then either the
    direct scatter (``scatter``; the base holds zero under it) or the
    gather of the band blocks from a per-lane flat source (``dih``/``sih``
    where ``dmask``/``smask``, H.ravel() or the dense K.ravel()), and the
    base's index into the shared [A.ravel() | (-delta, 0, 1)] elsewhere."""

    Dp: int
    perm: torch.Tensor    # (Dp,) new -> old
    iperm: torch.Tensor   # (Dp,) old -> new
    dmask: torch.Tensor   # (nb, B, B) True where the per-lane source fills
    smask: torch.Tensor   # (nb, bwb, B, B), same for the sub-diagonals
    scatter: Optional[SegmentSum] = None  # sums of the direct scatter
    dio: Optional[torch.Tensor] = None    # index into [A.ravel() | consts]
    sio: Optional[torch.Tensor] = None    # (None: the base is zero)
    dih: Optional[torch.Tensor] = None    # index into the per-lane source
    sih: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=16)
def band_maps(st: ProblemStructure, device: str, direct: bool) -> BandMaps:
    """The static maps of ``st``'s banded plan, on ``device``: the direct
    scatter's where ``direct`` (``_direct_band``), else the gathers."""
    n, p, plan = st.n, st.p, st.band
    perm = np.asarray(plan.perm, np.int64)
    Dp = len(perm)
    blk = plan.block
    nb = Dp // blk
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(Dp)
    keep = bool(plan.keep_soc and st.n_sc)
    ms = st.cone.ms if keep else 0
    common = dict(Dp=Dp, perm=_t(perm, device), iperm=_t(iperm, device))
    if keep and not direct:
        # blocks of the permuted dense K over [z_soc | x | y]; the base
        # only zeroes the blocks left of block column 0
        rows = perm.reshape(nb, blk)
        dih = rows[:, :, None] * Dp + rows[:, None, :]
        left = np.maximum(np.arange(nb)[:, None]
                          - np.arange(1, plan.bwb + 1)[None, :], 0)
        sih = rows[:, None, :, None] * Dp + rows[left][:, :, None, :]
        smask = np.broadcast_to(
            (np.arange(nb)[:, None] >= np.arange(1, plan.bwb + 1)[None, :]
             )[:, :, None, None], sih.shape).copy()
        return BandMaps(dmask=_t(dih >= 0, device, torch.bool),
                        smask=_t(smask, device, torch.bool),
                        dih=_t(dih, device), sih=_t(sih, device), **common)
    (dmask, dih, dio), (smask, sih, sio) = _band_gather_split(
        n, p, Dp, perm, plan.bwb, ms, blk)
    maps = dict(dmask=_t(dmask, device, torch.bool), dio=_t(dio, device),
                smask=_t(smask, device, torch.bool), sio=_t(sio, device))
    if direct:
        idx = _band_scatter_idx(n, Dp, perm, st.gsplit, st.socsplit,
                                st.q if keep else (), plan.bwb)
        return BandMaps(scatter=segment_map(idx, device, keep=idx != nb * B * B),
                        **maps, **common)
    return BandMaps(dih=_t(dih, device), sih=_t(sih, device), **maps,
                    **common)


class DenseMaps(NamedTuple):
    """Static layout of a dense matrix that holds H at offset ``ms`` with
    row stride ``Dp`` (the reduced strategy's K over [z_soc | x | y], or H
    alone with ms = 0, Dp = n): ms kept SOC rows, me eliminated rows, and
    the fixed-order sums of the gsplit's H contributions: ``hs`` of the
    scatter rows' flattened (n_spr, w, w) values into flat positions,
    those whose two columns are real (a padded column contributes 0 to a
    row and column that the reference crops), and ``hd`` of the singleton
    rows' values onto the diagonal of H."""

    Dp: int
    ms: int
    me: int
    hs: Optional[SegmentSum]
    hd: Optional[SegmentSum]


@functools.lru_cache(maxsize=16)
def dense_maps(st: ProblemStructure, device: str, h_only: bool = False,
               keep: bool = True, block: int = B) -> DenseMaps:
    """The maps of the dense K that keeps every SOC row, padded to
    ``block``, with ``keep`` false of the K over [x | y] with every row
    eliminated ("normal"), or with ``h_only`` of a bare (n, n) H with
    every row eliminated."""
    n, p = st.n, st.p
    ms = 0 if h_only or not keep else st.m - st.l
    Dp = n if h_only else pad_to_block(ms + n + p, block)
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
    return DenseMaps(Dp=Dp, ms=ms, me=st.m - ms, hs=hs, hd=hd)


class SocMaps(NamedTuple):
    """The per-cone pad maps and column supports on the device."""

    qidx: torch.Tensor    # (n_sc, dmax) offset in the SOC segment, pad ms
    valid: torch.Tensor   # (n_sc, dmax) bool
    head: torch.Tensor    # (n_sc, dmax) bool, the cone's first slot
    cols: torch.Tensor    # (n_sc, w) column support, pad n
    flat: torch.Tensor    # (ms,) each SOC entry's place in (n_sc * dmax)
    offs: torch.Tensor    # (n_sc + 1,) int32 head offsets, then ms


@functools.lru_cache(maxsize=16)
def soc_maps(st: ProblemStructure, device: str) -> SocMaps:
    qidx, valid = _soc_pad_maps(st.q, st.cone.ms)
    head = (np.arange(qidx.shape[1])[None, :] == 0) & valid
    return SocMaps(qidx=_t(qidx, device), valid=_t(valid, device, torch.bool),
                   head=_t(head, device, torch.bool),
                   flat=_t(np.flatnonzero(valid), device),
                   offs=_t(np.append(st.cone.head_offsets, st.cone.ms),
                           device, torch.int32),
                   cols=_t(np.asarray(st.socsplit.cols, np.int64).reshape(
                       st.n_sc, st.socsplit.width), device))


# ---------------------------------------------------------------- context

class KKTContext(NamedTuple):
    """Per-solve constants: equilibrated G, A ((m, n), (p, n) shared or
    with a leading lane axis), the static maps, the lane-invariant base of
    the factored matrix (``Kd0``/``Ks0`` for "banded", ``K0`` for the
    dense strategies and for a banded ``keep_soc`` plan off the scatter
    path) and the iteration-invariant coefficients of the H contributions.
    ``Gf`` is G in the type the factor is assembled in (G itself at f64);
    the coefficients and, under "reduced" and "normal", ``K0`` are in that
    type too.  A solve's prologue makes it (``solver``): a kept program's
    replay rewrites every tensor of it from the new G and A, the
    operands' coefficients included."""

    G: torch.Tensor
    A: torch.Tensor
    Gf: torch.Tensor
    split: Optional[SplitMaps]
    spr_outer: Optional[torch.Tensor]   # ([L,] n_spr, w, w) g_i g_j
    sing_sq: Optional[torch.Tensor]     # ([L,] n_sing) g^2
    keep_soc: bool = False              # SOC rows stay in the factor
    band: Optional[BandMaps] = None
    Kd0: Optional[torch.Tensor] = None  # ([L,] nb, B, B) A, -dI, padding
    Ks0: Optional[torch.Tensor] = None  # ([L,] nb, bwb, B, B)
    dense: Optional[DenseMaps] = None
    K0: Optional[torch.Tensor] = None   # ([L,] Dp, Dp)
    soc: Optional[SocMaps] = None
    soc_gsub: Optional[torch.Tensor] = None  # ([L,] n_sc, dmax, w) G_soc
    soc_gram: Optional[torch.Tensor] = None  # ([L,] n_sc, w, w) Gq'Gq
    # the big products' operands (``make_sliced``; None on a CPU tensor)
    sG: object = None     # x @ G
    sGT: object = None    # x @ G'
    sA: object = None     # x @ A
    sAT: object = None    # x @ A'
    sGe: object = None    # x @ G[:me]  (the eliminated rows)
    sGeT: object = None   # x @ G[:me]'
    sGA: object = None    # [z | y] @ [G; A]
    sAGT: object = None   # x @ [A' | G']


class WideOperand:
    """``x @ M`` for an operand too wide for the gather: ``gemm.matmul``,
    on a CUDA tensor the dgemm kernel, which folds the lanes of a shared
    ``bmat`` into its rows and reads it once (the JAX package's
    ``BigOperand``, K12 ``_gemv_call``)."""

    def __init__(self, bmat: torch.Tensor):
        self.bmat = bmat

    def rmatmul(self, a: torch.Tensor) -> torch.Tensor:
        """x @ M for a (L, k, km) or (L, km)."""
        if a.dim() == 2:
            return matmul(a[:, None], self.bmat)[:, 0]
        return matmul(a, self.bmat)

    def rmatmul_fused(self, a, a2=None, base=None, op="add", w=None,
                      gamma=0.0, x=None, split=None):
        """``SparseOperand.rmatmul_fused``'s function: the product of the
        concatenation, then ``spmv.fused_tail``'s torch ops."""
        ab = a if a2 is None else torch.cat([a, a2], -1)
        return fused_tail(self.rmatmul(ab), base, op, w, gamma, x, split)


def _sliced_live(G: torch.Tensor) -> bool:
    """Where the big products take operands (``make_sliced``): the JAX
    package builds them where its kernels are live and G is f64
    (``eicos_tpu.kkt._make_sliced``), here on a CUDA tensor of f64.  A CPU
    tensor keeps the dense products and the residual-first refinement
    loop, as the JAX package does on its CPU."""
    return G.device.type == "cuda" and G.dtype == torch.float64


@functools.lru_cache(maxsize=16)
def _sliced_patterns(st: ProblemStructure, me: int, device: str) -> dict:
    """The ``SparsePattern`` on ``device`` of every narrow operand of
    ``make_sliced`` (None for a wide one), from the ``csc_table`` of the
    structure's ``MatvecPattern``: built once, so a solve only gathers
    the coefficients."""
    mv = st.matvec
    m, n, p = st.m, st.n, st.p
    gr = np.asarray(mv.g_rows, np.int64)
    gc = np.asarray(mv.g_cols, np.int64)
    ar = np.asarray(mv.a_rows, np.int64)
    ac = np.asarray(mv.a_cols, np.int64)
    with_a = mv.has_a

    # key: (table or None, contraction length km)
    tabs = dict(sG=(csc_table(gr, gc, m, n), m),
                sGT=(csc_table(gc, gr, n, m), n))
    if p:
        tabs.update(
            sA=(csc_table(ar, ac, p, n) if with_a else None, p),
            sAT=(csc_table(ac, ar, n, p) if with_a else None, n),
            sGA=(csc_table(np.concatenate([gr, m + ar]),
                           np.concatenate([gc, ac]), m + p, n)
                 if with_a else None, m + p),
            sAGT=(csc_table(np.concatenate([ac, gc]),
                            np.concatenate([ar, p + gr]), n, p + m)
                  if with_a else None, n))
    if 0 < me < m:
        sel = gr < me
        tabs.update(sGe=(csc_table(gr[sel], gc[sel], me, n), me),
                    sGeT=(csc_table(gc[sel], gr[sel], n, me), n))
    return {key: None if tab is None else SparsePattern(*tab, km, device)
            for key, (tab, km) in tabs.items()}


def make_sliced(st: ProblemStructure, G: torch.Tensor, A: torch.Tensor,
                me: int) -> dict:
    """The operands of the big products, per key of ``KKTContext`` (``sG``
    ... ``sAGT``), as ``eicos_tpu.kkt._make_sliced`` prepares them for its
    TPU path: a ``SparseOperand`` (the spmv kernel) where the structure
    carries the nonzero pattern and the operand's widest column holds at
    most ``spmv.WIDTH_MAX`` nonzeros (the A operands only with A's pattern
    recorded), else a ``WideOperand`` (dgemm).  ``{}`` unless
    ``_sliced_live(G)``.  G and A are the equilibrated matrices, shared
    or with a lane axis."""
    if not _sliced_live(G):
        return {}
    m, p = st.m, st.p
    pats = (_sliced_patterns(st, me, str(G.device))
            if st.matvec is not None else {})

    def operand(key, bmat):
        pat = pats.get(key)
        return SparseOperand(bmat, pattern=pat) if pat is not None else (
            WideOperand(bmat))

    Gt = G.transpose(-1, -2)
    out = dict(sG=operand("sG", G), sGT=operand("sGT", Gt))
    if p:
        At = A.transpose(-1, -2)
        out.update(
            sA=operand("sA", A), sAT=operand("sAT", At),
            sGA=operand("sGA", torch.cat([G, A], -2)),
            sAGT=operand("sAGT", torch.cat([At, Gt], -1)))
    else:
        out.update(sGA=out["sG"], sAGT=out["sGT"])
    if me == m:
        out.update(sGe=out["sG"], sGeT=out["sGT"])
    elif me:
        Ge = G[..., :me, :]
        out.update(sGe=operand("sGe", Ge),
                   sGeT=operand("sGeT", Ge.transpose(-1, -2)))
    return out


def _dense_base(st, dm: DenseMaps, G, A, delta):
    """The lane-invariant part of the dense K over [z_soc | x | y]
    (``eicos_tpu.kkt.make_context``): G_soc, A, -dI on y, 1 on padding;
    the z_soc and x diagonal blocks are written per factor."""
    n, p, ms, l = st.n, st.p, dm.ms, st.l
    D = ms + n + p
    lead = A.shape[:-2]
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
    return K0


def _full_base(st, G, A, delta, block: int):
    """The lane-invariant part of the "full" K over [z | x | y]
    (``eicos_tpu.kkt.make_context``): G, A, +dI on x, -dI on y, 1 on
    padding; the z diagonal block is written per factor."""
    n, p, m = st.n, st.p, st.m
    D = m + n + p
    Dp = pad_to_block(D, block)
    lead = A.shape[:-2]
    diag0 = G.new_zeros(Dp)
    diag0[m:m + n] = delta
    diag0[m + n:D] = -delta
    diag0[D:] = 1.0
    K0 = torch.diag_embed(diag0.expand(*lead, Dp)).contiguous()
    if m:
        K0[..., :m, m:m + n] = G
        K0[..., m:m + n, :m] = G.transpose(-1, -2)
    if p:
        K0[..., m:m + n, m + n:D] = A.transpose(-1, -2)
        K0[..., m + n:D, m:m + n] = A
    return K0


@functools.lru_cache(maxsize=16)
def _base_consts(delta: float, dtype, device: str) -> torch.Tensor:
    """The band base's constants (-delta, 0, 1) on ``device``, made once:
    a captured prologue copies nothing from the host."""
    return torch.tensor([-delta, 0.0, 1.0], dtype=dtype, device=device)


def make_context(st: ProblemStructure, G, A, settings) -> KKTContext:
    require_slice(st, settings)
    dev = str(G.device)
    delta = settings.deltastat
    if settings.kkt_strategy == "full":
        return KKTContext(G=G, A=A, Gf=G, split=None, spr_outer=None,
                          sing_sq=None,
                          K0=_full_base(st, G, A, delta, settings.block),
                          **make_sliced(st, G, A, 0))
    fdtype = (torch.float32 if settings.factor_dtype == "float32"
              else G.dtype)
    Gf = G.to(fdtype)
    split = split_maps(st, dev)
    spr_outer = sing_sq = None
    if split is not None and st.gsplit.n_spr:
        Gpad = torch.cat([Gf, Gf.new_zeros(*Gf.shape[:-1], 1)], -1)
        C = Gpad[..., split.spr[:, None], split.cols2]   # ([L,] n_spr, w)
        spr_outer = C[..., :, :, None] * C[..., :, None, :]
    if split is not None and st.gsplit.n_sing:
        coef = Gf[..., split.sing, split.scol]
        sing_sq = coef * coef
    keep = _keep_soc(st, settings)
    ctx = KKTContext(G=G, A=A, Gf=Gf, split=split, spr_outer=spr_outer,
                     sing_sq=sing_sq, keep_soc=keep,
                     **make_sliced(st, G, A, st.l if keep else st.m))
    lead = A.shape[:-2]
    if settings.kkt_strategy in ("reduced", "normal"):
        dm = dense_maps(st, dev, keep=keep, block=settings.block)
        return ctx._replace(
            dense=dm, K0=_dense_base(st, dm, G, A, delta).to(fdtype))
    direct = _direct_band(st, settings)
    maps = band_maps(st, dev, direct)
    ctx = ctx._replace(band=maps)
    if keep and not direct:
        dm = dense_maps(st, dev, block=settings.block)
        zero = G.new_zeros(())
        return ctx._replace(
            dense=dm, K0=_dense_base(st, dm, G, A, delta).to(fdtype),
            Kd0=zero, Ks0=zero)
    if not direct:
        ctx = ctx._replace(dense=dense_maps(st, dev, h_only=True))
    elif st.n_sc:
        sm = soc_maps(st, dev)
        Gpad = G.new_zeros(*G.shape[:-2], st.m + 1, st.n + 1)
        Gpad[..., :st.m, :st.n] = G
        gsub = Gpad[..., (st.l + sm.qidx)[:, :, None], sm.cols[:, None, :]]
        ctx = ctx._replace(soc=sm, soc_gsub=gsub)
        if not keep:
            ctx = ctx._replace(soc_gram=gsub.transpose(-1, -2) @ gsub)
    consts = _base_consts(delta, G.dtype, str(G.device))
    other = torch.cat([A.reshape(*lead, -1), consts.expand(*lead, 3)], -1)
    return ctx._replace(
        Kd0=torch.where(maps.dmask, 0.0, other[..., maps.dio]).to(fdtype),
        Ks0=torch.where(maps.smask, 0.0, other[..., maps.sio]).to(fdtype))


# ------------------------------------------------------ per-lane values

def _spr_vals(ctx: KKTContext, winv_lp):
    """(L, n_spr, w, w): w_r g_i g_j of every scatter row r."""
    return ctx.spr_outer * winv_lp[:, ctx.split.spr][:, :, None, None]


def _sing_vals(ctx: KKTContext, winv_lp):
    """(L, n_sing): w_r g^2 of every singleton row r."""
    return (ctx.sing_sq * winv_lp[:, ctx.split.sing]).expand(
        winv_lp.shape[0], -1)


def _soc_pad(ctx: KKTContext, x_s):
    """(L, ms) values over the SOC segment -> (L, n_sc, dmax), pads 0."""
    return torch.cat([x_s, x_s.new_zeros(x_s.shape[0], 1)], -1)[
        :, ctx.soc.qidx]


def _soc_eig(ctx: KKTContext, scal, delta=None):
    """Each cone's W^2 in its eigenbasis, in closed form: (rot (L, n_sc,
    dmax, dmax), lam (L, n_sc, dmax)) with W^2 = rot' diag(lam) rot on a
    cone's slots.  With W = eta [a, q'; q, I + qq'/(1+a)], a^2 - q'q = 1,
    and qh = q/|q|: rows (1, qh)/sqrt2 and (1, -qh)/sqrt2 with eigenvalues
    eta^2 (a+|q|)^2 and eta^2 / (a+|q|)^2, then (0, u) for u an orthonormal
    basis of qh's complement (the columns after the first of a Householder
    reflector that maps e1 to -+qh), eigenvalue eta^2.  Pad rows and
    columns are zero, pad eigenvalues 0.

    On CUDA tensors one launch of ``soc.eig`` (``cone_eig``) also computes
    what ``_soc_kept_vals`` (given ``delta``) and ``_soc_coupling_vals``
    make of the result, returned third and fourth: (rot, lam, kept or
    None, coupling)."""
    sm = ctx.soc
    if not kernels.on_cpu(scal.a):
        return soc.eig(sm.offs, sm.qidx.shape[1], scal.q_flat, scal.a,
                       scal.eta2, ctx.soc_gsub, delta)
    dmax = sm.qidx.shape[1]
    if dmax == 1:                       # every cone is its head alone
        return (scal.eta2.new_ones(*scal.eta2.shape, 1, 1),
                scal.eta2[..., None])
    dt, dev = scal.a.dtype, scal.a.device
    valid = sm.valid.to(dt)
    t = _soc_pad(ctx, scal.q_flat)[..., 1:]             # (L, n_sc, dmax-1)
    nq = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    e0 = torch.eye(dmax - 1, dtype=dt, device=dev)[0]
    t = torch.where(nq > 0, t / torch.where(nq > 0, nq, 1.0), e0)
    sgn = torch.where(t[..., :1] >= 0, 1.0, -1.0).to(dt)
    h = t + sgn * e0
    H = (torch.eye(dmax - 1, dtype=dt, device=dev)
         - (2.0 / (h * h).sum(-1, keepdim=True))[..., None]
         * h[..., :, None] * h[..., None, :])
    r = 0.5 ** 0.5
    one = torch.ones_like(t[..., :1])
    rows = [torch.cat([one, t], -1) * r, torch.cat([one, -t], -1) * r]
    if dmax > 2:
        tails = H[..., :, 1:].transpose(-1, -2)         # (.., dmax-2, dmax-1)
        rows.append(torch.cat([torch.zeros_like(tails[..., :1]), tails], -1))
    rot = torch.cat([rows[0][..., None, :], rows[1][..., None, :]]
                    + rows[2:], -2)
    # a cone of dimension one is its head alone
    e = torch.eye(dmax, dtype=dt, device=dev)[0]
    rot = torch.where(sm.valid[:, 1, None, None], rot,
                      torch.where(sm.head[:, :, None], e, 0.0))
    rot = rot * valid[:, :, None] * valid[:, None, :]
    big = (scal.a + nq[..., 0]) ** 2
    lam = torch.cat([(scal.eta2 * big)[..., None],
                     (scal.eta2 / big)[..., None],
                     scal.eta2[..., None].expand(*scal.eta2.shape,
                                                 dmax - 2)], -1)
    lam = torch.where(sm.valid[:, 1, None], lam,
                      torch.where(sm.head, scal.eta2[..., None], 0.0))
    return rot, lam * valid


def _soc_rotate(rot, x_s, ctx: KKTContext, transpose: bool = False):
    """rot x (or rot' x) cone by cone over the SOC segment, x_s (L, k,
    ms): one launch of ``soc.rotate`` (``cone_rotate``) on CUDA tensors."""
    sm = ctx.soc
    if not kernels.on_cpu(x_s):
        return soc.rotate(sm.offs, rot, x_s, transpose)
    xp = torch.cat([x_s, x_s.new_zeros(*x_s.shape[:-1], 1)], -1)[
        ..., sm.qidx]                                   # (L, k, n_sc, dmax)
    R = rot.transpose(-1, -2) if transpose else rot
    y = (R[:, None] @ xp[..., None])[..., 0]
    return y.flatten(-2)[..., sm.flat]


def _soc_kept_vals(st, ctx: KKTContext, scal, delta, lanes: int,
                   eig=None):
    """The per-cone kept blocks as (L, n_sc, dmax, dmax) padded values:
    -(1 + delta) I at the identity scaling, else -(diag(lam) + delta I),
    W^2 + delta I in each cone's eigenbasis (``_soc_eig``; ``eig`` is its
    result, computed here when None).  The factor then holds R K R' with
    R = diag(rot, I, I): its kept block is diagonal and the coupling is
    rot G_soc, of the order of G.  A dense -(W^2 + delta I), whose
    eigenvalues span (a + |q|)^4 ~ mu^-2 near an optimum, loses its small
    eigenvalue to cancellation in the unpivoted elimination once that
    span passes 1/eps, and the band factor's direction with it; the
    NT-scaled S K S, S = diag(W^-1, I, I), moves the span into the
    coupling W^-1 G_soc.  Pad rows and columns are zero and their targets
    are dropped."""
    sm = ctx.soc
    dmax = sm.qidx.shape[1]
    eye = torch.eye(dmax, dtype=ctx.G.dtype, device=ctx.G.device)
    eye_v = eye * (sm.valid[:, :, None] & sm.valid[:, None, :])
    if scal is None:
        return (-(1.0 + delta) * eye_v).expand(lanes, -1, -1, -1)
    if eig is not None and len(eig) > 2 and eig[2] is not None:
        return eig[2]                   # ``cone_eig`` made them
    lam = (eig if eig is not None else _soc_eig(ctx, scal))[1]
    return -(lam[..., None] * eye + delta * eye_v)


def _soc_coupling_vals(ctx: KKTContext, eig, lanes: int):
    """The kept rows' coupling on the ``SOCSplit`` column supports, (L,
    n_sc, dmax, w): G_soc at the identity scaling (``eig`` None), else rot
    G_soc in each cone's eigenbasis (``_soc_eig``)."""
    if eig is not None and len(eig) > 3:
        return eig[3]                   # ``cone_eig`` made it
    g = ctx.soc_gsub if eig is None else eig[0] @ ctx.soc_gsub
    return g.expand(lanes, *g.shape[-3:])


def _soc_band_vals(st, ctx: KKTContext, scal, delta, lanes: int):
    """The per-cone H contributions of the eliminating layout, (L, n_sc,
    w, w) on the ``SOCSplit`` supports (``eicos_tpu.kkt._soc_band_vals``):
    Gq' (W^2 + dI)^{-1} Gq = b Gq'Gq - b^2 [v1 v2] Minv [v1 v2]' with
    v1 = Gq' e, v2 = Gq' q, the closed form of
    ``cones.scale2reg_inv_soc`` (a 2x2 Woodbury)."""
    gram = ctx.soc_gram
    if scal is None:
        return (gram * (1.0 / (1.0 + delta))).expand(lanes,
                                                     *gram.shape[-3:])
    Gsub = ctx.soc_gsub
    qpad = _soc_pad(ctx, scal.q_flat)
    v1 = Gsub[..., 0, :].expand(lanes, -1, -1)          # head row of Gq
    v2 = (qpad[..., None] * Gsub).sum(-2)
    b = 1.0 / (scal.eta2 + delta)
    c11 = scal.eta2 * (2.0 * scal.w)
    c12 = scal.eta2 * scal.cc
    c22 = scal.eta2 * scal.dd
    detC = c11 * c22 - c12 * c12
    m11 = c22 / detC + b
    m12 = -c12 / detC
    m22 = c11 / detC + b * scal.w
    detM = m11 * m22 - m12 * m12
    mi11 = (m22 / detM)[..., None, None]
    mi12 = (-m12 / detM)[..., None, None]
    mi22 = (m11 / detM)[..., None, None]
    o11 = v1[..., :, None] * v1[..., None, :]
    o12 = v1[..., :, None] * v2[..., None, :] + v2[..., :, None] * v1[..., None, :]
    o22 = v2[..., :, None] * v2[..., None, :]
    corr = mi11 * o11 + mi12 * o12 + mi22 * o22
    b1 = b[..., None, None]
    return b1 * gram - b1 * b1 * corr


def _band_scatter_vals(st, ctx: KKTContext, winv_lp, delta, scal=None,
                       eig=None):
    """Per-lane contributions ordered as the scatter targets: [spr | sing
    | dI | soc], the soc part being the eliminating closed form or, on a
    ``keep_soc`` plan, the kept blocks and then the coupling twice (once
    per orientation): G_soc at the identity scaling, else rot G_soc in
    each cone's eigenbasis (``_soc_kept_vals``; ``eig`` is ``_soc_eig``'s
    result, computed here when None)."""
    lanes = winv_lp.shape[0]
    vals = []
    if ctx.spr_outer is not None:
        vals.append(_spr_vals(ctx, winv_lp).reshape(lanes, -1))
    if ctx.sing_sq is not None:
        vals.append(_sing_vals(ctx, winv_lp))
    vals.append(winv_lp.new_full((lanes, st.n), delta))
    if st.n_sc and ctx.keep_soc:
        with graphs.region("cones.kept_blocks"):
            if scal is not None and eig is None:
                eig = _soc_eig(ctx, scal, delta)
            vals.append(_soc_kept_vals(st, ctx, scal, delta, lanes,
                                       eig).reshape(lanes, -1))
            coup = _soc_coupling_vals(ctx, eig, lanes).reshape(lanes, -1)
        vals += [coup] * 2
    elif st.n_sc:
        vals.append(_soc_band_vals(st, ctx, scal, delta,
                                   lanes).reshape(lanes, -1))
    return torch.cat(vals, -1)


def band_blocks(st, ctx: KKTContext, winv_lp, delta, scal=None, eig=None):
    """The per-lane band blocks (Kd (L, nb, B, B), Ks (L, nb, bwb, B, B))
    of the direct scatter: the base plus the scattered contributions (with
    kept cones, their rows in each cone's eigenbasis, ``_soc_kept_vals``),
    read from the [diag | subs] buffer of ``_band_scatter_idx``."""
    lanes = winv_lp.shape[0]
    nb, bwb = ctx.Ks0.shape[-4], ctx.Ks0.shape[-3]
    nbb = nb * B * B
    buf = winv_lp.new_zeros(lanes, (1 + bwb) * nbb)
    buf[:, ctx.band.scatter.targets] = segment_sum(
        ctx.band.scatter,
        _band_scatter_vals(st, ctx, winv_lp, delta, scal, eig))
    return (ctx.Kd0 + buf[:, :nbb].view(lanes, nb, B, B),
            ctx.Ks0 + buf[:, nbb:].view(lanes, nb, bwb, B, B))


def _gathered_blocks(ctx: KKTContext, flat):
    """(Kd (L, nb, B, B), Ksubs (L, nb, bwb, B, B)) gathered from the
    per-lane ``flat`` source (H.ravel() or K.ravel()) and the base."""
    maps = ctx.band
    return (torch.where(maps.dmask, flat[:, maps.dih], ctx.Kd0),
            torch.where(maps.smask, flat[:, maps.sih], ctx.Ks0))


def _elim_soc(st, scal, delta, x_s):
    """(W_soc^2 + dI)^{-1} x over the SOC segment, x_s (L, k, ms): the
    closed form of ``cones.scale2reg_inv_soc`` (identity scalings when
    ``scal`` is None)."""
    if scal is None:
        return x_s * (1.0 / (1.0 + delta))
    return cones.scale2reg_inv_soc(st.cone, scal, delta, x_s)


def _assemble_h(st, ctx: KKTContext, dm: DenseMaps, K, scal, winv_lp, delta):
    """Write H = G_e' (W_e^2 + dI)^{-1} G_e + dI over the ``dm.me``
    eliminated rows into its block of ``K`` (L, Dp, Dp), zero there on
    entry, in the reference's order of summation
    (``eicos_tpu.kkt.factor``): H = [Gd' W^-1 Gd] + Hs + diag(hdiag + d),
    where Hs (the scatter rows) and hdiag (the singleton rows) are sums
    into zeros and Gd holds the gsplit's dense rows and, where the cones
    are eliminated too, the SOC rows; without a gsplit one product over
    every eliminated row.  The products are ``torch.matmul``."""
    lanes = winv_lp.shape[0]
    n, l, ms, me = st.n, st.l, dm.ms, dm.me
    G = ctx.Gf
    Hx = K[:, ms:ms + n, ms:ms + n]
    split = ctx.split
    use_split = split is not None and (st.gsplit.n_sing or st.gsplit.n_spr)
    rows = split.dense if use_split else slice(0, l)
    Gd = G[..., rows, :]
    WiGd = Gd * winv_lp[:, rows][:, :, None]
    if me > l:
        Gs = G[..., l:, :]
        WiGs = _elim_soc(st, scal, delta, Gs.transpose(-1, -2).expand(
            lanes, n, me - l)).transpose(-1, -2)
        Gd = torch.cat([Gd, Gs], -2)
        WiGd = torch.cat([WiGd, WiGs], -2)
    if Gd.shape[-2]:
        Hx.copy_(Gd.transpose(-1, -2) @ WiGd)
    hdiag = 0.0
    if use_split:
        if dm.hs is not None:
            Kf = K.view(lanes, -1)
            Kf[:, dm.hs.targets] += segment_sum(
                dm.hs, _spr_vals(ctx, winv_lp).reshape(lanes, -1))
        hdiag = winv_lp.new_zeros(lanes, n)
        if dm.hd is not None:
            hdiag[:, dm.hd.targets] = segment_sum(dm.hd,
                                                  _sing_vals(ctx, winv_lp))
    Hx.diagonal(dim1=-2, dim2=-1).add_(hdiag + delta)


def dense_matrix(st, ctx: KKTContext, scal: Optional[cones.Scaling],
                 winv_lp, delta):
    """The per-lane dense K (L, Dp, Dp) over [z_soc | x | y] for the
    current scaling (``eicos_tpu.kkt``'s H assembly and
    ``_assemble_dense``): the base, H over the eliminated rows, and the
    kept SOC block -(W_soc^2 + dI); in the type of ``ctx.K0``, with
    ``scal`` and ``winv_lp`` in that type."""
    lanes = winv_lp.shape[0]
    dm = ctx.dense
    ms = dm.ms
    K = ctx.K0.expand(lanes, dm.Dp, dm.Dp).clone()
    _assemble_h(st, ctx, dm, K, scal, winv_lp, delta)
    if ms:
        eye = torch.eye(ms, dtype=K.dtype, device=K.device)
        W2s = eye if scal is None else cones.w2_soc_dense(st.cone, scal)
        K[:, :ms, :ms] = -(W2s + delta * eye)
    return K


def _use_subst(K: torch.Tensor, settings) -> bool:
    """True where the dense factor of ``K`` takes the substitution form
    (``eicos_tpu.kkt._use_subst``, with the tensor's device in the place
    of the TPU gate): f64 and 128-blocks only; never under
    ``dense_solve="inverse"``;
    always under "subst"; under "auto" on a CUDA tensor, except for the
    "full" strategy, which the reference keeps on the inverse path."""
    if (settings.dense_solve == "inverse" or K.dtype != torch.float64
            or settings.block != B):
        return False
    if settings.dense_solve == "subst":
        return True
    return settings.kkt_strategy != "full" and K.device.type == "cuda"


def _factor_dense(K: torch.Tensor, settings):
    """The dense factor of the f64 ``K``, which is consumed: substitution
    form or explicit inverse (``_use_subst``)."""
    if _use_subst(K, settings):
        return ldl_factor_subst(K)
    return ldl_factor(K, block=settings.block)


def _factor_in_dtype(K: torch.Tensor, settings):
    """Factor ``K`` (f64, or already cast) in ``settings.factor_dtype``:
    an f32 factor stays f32 and takes the inverse path."""
    if settings.factor_dtype == "float32":
        return ldl_factor(K.to(torch.float32), block=settings.block)
    return _factor_dense(K, settings)


def _solve_padded(fac, rr: torch.Tensor) -> torch.Tensor:
    """``ldl_solve`` in the factor's type, cast back to the type of rr."""
    return ldl_solve(fac, rr.to(fac.d.dtype)).to(rr.dtype)


def _factor_full(st: ProblemStructure, ctx: KKTContext,
                 scal: Optional[cones.Scaling], settings, lanes: int):
    """``factor`` for the "full" strategy: K over [z | x | y] with
    -(W^2 + dI) written into the base, nothing eliminated."""
    m = st.m
    delta = settings.deltastat
    Dp = ctx.K0.shape[-1]
    K = ctx.K0.expand(lanes, Dp, Dp).clone()
    if m:
        if scal is None:
            blk = K.new_zeros(m, m)
            blk.diagonal().fill_(-1.0 - delta)
        else:
            # -W^2 - dI, in place in the dense W^2
            blk = cones.w2_dense(st.cone, scal).neg_()
            blk.diagonal(dim1=-2, dim2=-1).sub_(delta)
        K[:, :m, :m] = blk
        del blk
    fac = _factor_in_dtype(K, settings)
    del K
    return ExactSolve(kind="full", st=st, ctx=ctx, fac=fac, scal=None,
                      winv_lp=None, delta=delta)


class ExactSolve(NamedTuple):
    """``factor``'s result: the factor and what one solve of the factored
    system reads, as data, so that a captured segment's outputs hold every
    tensor of it (``graphs``).  Calling it runs ``solve_exact``."""

    kind: str                        # "full", "dense" or "band"
    st: ProblemStructure
    ctx: KKTContext
    fac: tuple                       # LDLFactors, LDLSubstFactors, BandFactors
    scal: Optional[cones.Scaling]    # in the factor's type
    winv_lp: Optional[torch.Tensor]  # (L, l) (W_lp^2 + dI)^{-1}
    delta: float
    gemm_dtype: Optional[torch.dtype] = None  # the scan's product type
    rot: Optional[torch.Tensor] = None  # (L, n_sc, dmax, dmax): the kept
    #                                     rows' eigenbases (``_soc_eig``)

    def __call__(self, rhs):
        return solve_exact(self, rhs)


def _welim(es: ExactSolve, v):
    """(W^2 + dI)^{-1} on the eliminated rows of v (L, k, me)."""
    l = es.st.l
    v_lp = v[..., :l] * es.winv_lp[:, None, :]
    if v.shape[-1] == l:
        return v_lp
    return torch.cat([v_lp, _elim_soc(es.st, es.scal, es.delta, v[..., l:])],
                     -1)


def solve_exact(es: ExactSolve, rhs):
    """One solve of the factored system without refinement, for packed
    right-hand sides rhs (L, k, n+p+m) -> (dx, dy, dz) (``factor``)."""
    st, ctx = es.st, es.ctx
    n, p, m, l = st.n, st.p, st.m, st.l
    if es.kind == "full":
        D = m + n + p
        Dp = ctx.K0.shape[-1]
        bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]
        rr = torch.cat([bz, bx, by,
                        rhs.new_zeros(*rhs.shape[:-1], Dp - D)], -1)
        x = _solve_padded(es.fac, rr)
        return x[..., m:m + n], x[..., m + n:D], x[..., :m]
    k = rhs.shape[1]
    if k > KP:
        raise ValueError(f"at most {KP} right-hand sides, got {k}")
    ms = st.m - l if ctx.keep_soc else 0
    me = l if ctx.keep_soc else st.m
    D = ms + n + p
    G = ctx.Gf
    fdtype = G.dtype
    Dp = ctx.dense.Dp if es.kind == "dense" else ctx.band.Dp
    Ge = G[..., :me, :]
    # the eliminated rows' operands, at f64 (``eicos_tpu.kkt``'s ``oz``)
    oz = ctx.sGe is not None and fdtype == torch.float64
    out_dtype = rhs.dtype
    rhs = rhs.to(fdtype)
    bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]
    bz_e, bz_s = bz[..., :me], bz[..., me:]
    if not me:
        r1 = bx
    elif oz:
        r1 = ctx.sGe.rmatmul_fused(_welim(es, bz_e), base=bx)
    else:
        r1 = bx + _welim(es, bz_e) @ Ge
    if es.rot is not None:
        with graphs.region("cones.kept_blocks"):
            bz_s = _soc_rotate(es.rot, bz_s, ctx)
    rr = torch.cat([bz_s, r1, by,
                    rhs.new_zeros(*rhs.shape[:-1], Dp - D)], -1)
    if es.kind == "dense":
        x = ldl_solve(es.fac, rr)
    else:
        maps = ctx.band
        rp = rr[..., maps.perm]
        if rp.is_cuda and not scan(es.fac.L, es.fac.d.dtype):
            bw, kt = es.fac.L.shape[2], sweep_kt(rp.shape[-2])
            graphs.sweep_ring(bw, kt, sweep_ring(bw, kt, rp.device))
        with graphs.region("band.sweeps"):
            x = band_solve(es.fac, rp, gemm_dtype=es.gemm_dtype)
        x = x[..., maps.iperm]
    dzs = x[..., :ms]
    if es.rot is not None:
        with graphs.region("cones.kept_blocks"):
            dzs = _soc_rotate(es.rot, dzs, ctx, transpose=True)
    dx, dy = x[..., ms:ms + n], x[..., ms + n:D]
    if not me:
        dz_e = bz_e
    elif oz:
        dz_e = _welim(es, ctx.sGeT.rmatmul_fused(dx, base=bz_e, op="rsub"))
    else:
        dz_e = _welim(es, dx @ Ge.transpose(-1, -2) - bz_e)
    dz = torch.cat([dz_e, dzs], -1)
    return dx.to(out_dtype), dy.to(out_dtype), dz.to(out_dtype)


def factor(st: ProblemStructure, ctx: KKTContext,
           scal: Optional[cones.Scaling], settings, lanes: int) -> ExactSolve:
    """Assemble and factor for the current NT scaling (None = identity
    scalings, the init factorization).  Returns an ``ExactSolve``:
    ``solve_exact(rhs) -> (dx, dy, dz)`` for packed right-hand sides
    (L, k, n+p+m), one solve of the factored system without refinement.

    Except under "full", the factored system runs over [z_soc | x | y]
    with the ``ms`` kept SOC rows first (none when the cones are
    eliminated), and the ``me`` eliminated rows of G enter through the
    exact Schur complement.  Under ``factor_dtype="float32"`` the
    assembly, the factor and ``solve_exact`` compute in f32 and the
    directions are cast back."""
    if settings.kkt_strategy == "full":
        return _factor_full(st, ctx, scal, settings, lanes)
    n, l = st.n, st.l
    delta = settings.deltastat
    G = ctx.Gf
    fdtype = G.dtype
    if scal is not None and fdtype != ctx.G.dtype:
        scal = cones.Scaling(*[a.to(fdtype) for a in scal])
    if scal is None:
        winv_lp = G.new_full((lanes, l), 1.0 / (1.0 + delta))
    else:
        winv_lp = 1.0 / (scal.v_lp + delta)
    common = dict(st=st, ctx=ctx, scal=scal, winv_lp=winv_lp, delta=delta)

    if settings.kkt_strategy in ("reduced", "normal"):
        K = dense_matrix(st, ctx, scal, winv_lp, delta)
        fac = _factor_in_dtype(K, settings)
        del K
        return ExactSolve(kind="dense", fac=fac, **common)
    maps = ctx.band
    # the scan's product type (``ops/band.py`` reads it only there)
    gdt = torch.float32 if settings.band_gemm == "float32" else None
    if maps.scatter is not None:
        eig = None
        if ctx.keep_soc and scal is not None:
            with graphs.region("cones.kept_blocks"):
                eig = _soc_eig(ctx, scal, delta)
        Kd, Ks = band_blocks(st, ctx, winv_lp, delta, scal, eig)
        return ExactSolve(kind="band", fac=_band_factor(Kd, Ks, gdt),
                          gemm_dtype=gdt,
                          rot=None if eig is None else eig[0], **common)
    if ctx.keep_soc:
        # a keep_soc plan off the scatter path: the unscaled dense K
        src = dense_matrix(st, ctx, scal, winv_lp, delta)
    else:
        src = G.new_zeros(lanes, n, n)
        _assemble_h(st, ctx, ctx.dense, src, scal, winv_lp, delta)
    fac = _band_factor(*_gathered_blocks(ctx, src.view(lanes, -1)), gdt)
    del src
    return ExactSolve(kind="band", fac=fac, gemm_dtype=gdt, **common)


def _band_factor(Kd, Ks, gemm_dtype):
    """``band_factor`` as the region "band.factor", its shape recorded
    (``graphs.band_shape``)."""
    graphs.band_shape(Ks.shape[-4], Ks.shape[-3])
    with graphs.region("band.factor"):
        return band_factor(Kd, Ks, gemm_dtype=gemm_dtype)


class KKTSolveResult(NamedTuple):
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    nitref: torch.Tensor  # (L, k) int32 refinement count


class RefineState(NamedTuple):
    """The state of one refined solve between trips (``refine_start``,
    ``refine_trip``), each field (L, k, ...) with k right-hand sides.
    ``cx, cy, cz`` are the residual of (dx, dy, dz) in the rotated loop
    and the last corrections in the residual-first loop."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    nerr_prev: torch.Tensor  # (L, k)
    kk: torch.Tensor         # (L, 1) int32: the lane's trips so far
    kout: torch.Tensor       # (L, k) int32 refinement count
    done: torch.Tensor       # (L, k) bool
    thresh: torch.Tensor     # (L, k), read only


def _ecos_z(ctx: KKTContext) -> bool:
    """True where refinement targets the unregularized z block, as ECOS's
    kkt_solve does (ez = bz - G dx + W^2 dz): the banded kept-cone layout
    in f64.  Refined against the regularized operator, a direction keeps
    d dz in the primal cone rows, and where a degenerate cone program's
    duals still move near its optimum that d dz slows the primal residual
    (the powered-descent SOCP at 20 steps, 128 lanes on the CPU: 32.7
    iterations a lane against 36.5).  The other layouts, and an f32
    factor, keep the reference's regularized z block, so that their
    refined directions stay the JAX package's; on the LP cells ECOS's rule
    leaves every lane's iterations as they are."""
    return (ctx.keep_soc and ctx.band is not None
            and ctx.Gf.dtype == torch.float64)


def residual(st: ProblemStructure, ctx: KKTContext, scal, rhs, settings,
             dx, dy, dz):
    """The residual of (dx, dy, dz) against the operator that refinement
    targets, and its largest entry per column:
    ex = bx - G'dz - d dx - A'dy;  ey = by - A dx + d dy;
    ez = bz - G dx + W^2 dz + d dz, the exact regularized operator, as in
    the reference; on the banded kept-cone layout (``_ecos_z``) ez = bz -
    G dx + W^2 dz, the unregularized z block of ECOS's kkt_solve.  On the
    operands each product and its tail is one fused call
    (``spmv.fused_tail``: y - d * x as y + (-d) * x, the same bits)."""
    n, p, m = st.n, st.p, st.m
    delta = settings.deltastat
    G, A = ctx.G, ctx.A
    lanes, K = rhs.shape[0], rhs.shape[1]
    bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]
    Wdz = (dz if scal is None or not m
           else cones.scale2(st.cone, scal, dz))
    dz_reg = None if _ecos_z(ctx) else dz     # the d dz term, or none
    if m and p and ctx.sGA is not None:
        ex = ctx.sGA.rmatmul_fused(dz, dy, base=bx, op="sub",
                                   gamma=-delta, x=dx)
        eyz = ctx.sAGT.rmatmul_fused(dx, base=(by, bz), op="sub",
                                     w=(None, Wdz), gamma=delta,
                                     x=(dy, dz_reg), split=p)
        ey, ez = eyz[..., :p], eyz[..., p:]
    elif ctx.sG is not None:
        ex = (ctx.sG.rmatmul_fused(dz, base=bx, op="sub", gamma=-delta,
                                   x=dx) if m else bx - 0.0 - delta * dx)
        if p:
            ex = ctx.sA.rmatmul_fused(dy, base=ex, op="sub")
        ey = (ctx.sAT.rmatmul_fused(dx, base=by, op="sub", gamma=delta,
                                    x=dy) if p else by)
        ez = (ctx.sGT.rmatmul_fused(dx, base=bz, op="sub", w=Wdz,
                                    gamma=delta, x=dz_reg) if m else bz)
    else:
        Gt, At = G.transpose(-1, -2), A.transpose(-1, -2)
        ex = bx - (dz @ G if m else 0.0) - delta * dx
        if p:
            ex = ex - dy @ A
        ey = (by - dx @ At + delta * dy) if p else by
        ez = bz - dx @ Gt + Wdz if m else bz
        if m and dz_reg is not None:
            ez = ez + delta * dz_reg
    nerr = ex.abs().amax(-1) if n else rhs.new_zeros(lanes, K)
    if m:
        nerr = torch.maximum(nerr, ez.abs().amax(-1))
    if p:
        nerr = torch.maximum(nerr, ey.abs().amax(-1))
    return ex, ey, ez, nerr


def refine_start(st: ProblemStructure, ctx: KKTContext, solve_exact,
                 scal: Optional[cones.Scaling], rhs, settings,
                 active: Optional[torch.Tensor] = None) -> RefineState:
    """The first solve of ``solve_refined`` and its stopping threshold;
    in the rotated loop also the first residual and the columns it
    already stops."""
    lanes, K = rhs.shape[0], rhs.shape[1]
    dx, dy, dz = solve_exact(rhs)
    thresh = (1.0 + rhs.abs().amax(-1)) * settings.linsysacc
    kk = torch.zeros((lanes, 1), dtype=torch.int32, device=rhs.device)
    kout = torch.zeros((lanes, K), dtype=torch.int32, device=rhs.device)
    done = torch.zeros((lanes, K), dtype=torch.bool, device=rhs.device)
    if active is not None:
        done = done | ~active[:, None]
    if ctx.sGA is not None:
        ex, ey, ez, nerr_prev = residual(st, ctx, scal, rhs, settings,
                                         dx, dy, dz)
        done = done | (nerr_prev < thresh) | (settings.nitref == 0)
        return RefineState(dx, dy, dz, ex, ey, ez, nerr_prev, kk, kout,
                           done, thresh)
    return RefineState(dx, dy, dz, torch.zeros_like(dx),
                       torch.zeros_like(dy), torch.zeros_like(dz),
                       rhs.new_full((lanes, K), torch.inf), kk, kout, done,
                       thresh)


def refine_trip(st: ProblemStructure, ctx: KKTContext, solve_exact,
                scal: Optional[cones.Scaling], rhs, settings,
                r: RefineState) -> None:
    """One trip of ``solve_refined``'s loop, written into ``r`` in place
    once every new value is computed."""
    nitref = settings.nitref
    irerrfact = settings.irerrfact
    kk, done = r.kk, r.done
    act = ~done
    if ctx.sGA is not None:
        am = act[..., None]
        rx, ry, rz = solve_exact(torch.cat([r.cx, r.cy, r.cz], -1))
        dx1 = torch.where(am, r.dx + rx, r.dx)
        dy1 = torch.where(am, r.dy + ry, r.dy)
        dz1 = torch.where(am, r.dz + rz, r.dz)
        ex, ey, ez, nerr = residual(st, ctx, scal, rhs, settings,
                                    dx1, dy1, dz1)
        t = kk + 1
        undo = act & (nerr > r.nerr_prev)
        stop = act & (undo | (t == nitref) | (nerr < r.thresh)
                      | (r.nerr_prev < irerrfact * nerr))
        um = undo[..., None]
        new = (torch.where(um, r.dx, dx1), torch.where(um, r.dy, dy1),
               torch.where(um, r.dz, dz1), ex, ey, ez,
               torch.where(act, nerr, r.nerr_prev),
               # a lane's loop counter only runs while one of its columns
               # does
               kk + act.any(-1, keepdim=True).to(kk.dtype),
               torch.where(act, torch.where(undo, t - 1, t), r.kout),
               done | stop)
    else:
        ex, ey, ez, nerr = residual(st, ctx, scal, rhs, settings,
                                    r.dx, r.dy, r.dz)
        undo = act & (kk > 0) & (nerr > r.nerr_prev)
        stop = act & (undo | (kk == nitref) | (nerr < r.thresh)
                      | ((kk > 0) & (r.nerr_prev < irerrfact * nerr)))
        rx, ry, rz = solve_exact(torch.cat([ex, ey, ez], -1))
        um = undo[..., None]
        advm = (act & ~stop)[..., None]

        def step(cur, corr_old, corr_new):
            new = torch.where(um, cur - corr_old,
                              torch.where(advm, cur + corr_new, cur))
            return new, torch.where(advm, corr_new, corr_old)

        dx, cx = step(r.dx, r.cx, rx)
        dy, cy = step(r.dy, r.cy, ry)
        dz, cz = step(r.dz, r.cz, rz)
        new = (dx, dy, dz, cx, cy, cz, torch.where(act, nerr, r.nerr_prev),
               kk + act.any(-1, keepdim=True).to(kk.dtype),
               torch.where(act, torch.where(undo, kk - 1, kk), r.kout),
               done | stop)
    for dst, src in zip(r[:len(new)], new):
        dst.copy_(src)


def solve_refined(st: ProblemStructure, ctx: KKTContext, solve_exact,
                  scal: Optional[cones.Scaling], rhs, settings,
                  active: Optional[torch.Tensor] = None) -> KKTSolveResult:
    """Backsolve + iterative refinement against the exact regularized
    operator (EiCOS solveKKT): up to ``nitref`` corrections per column,
    undo on regression, threshold and weak-progress stops.

    ``rhs`` is (L, k, n+p+m).  Each column of each lane stops on its own,
    as the JAX package's vmapped loop does; ``active`` (L,) marks the lanes
    whose result is used (the others start stopped).  ``refine_start``,
    then ``refine_trip`` until every column has stopped (one host read a
    trip): the solver runs the same two as parts of its graphed segments.

    With the context's operands (``make_sliced``, a CUDA tensor) the big
    products go through them, two fused products over the stacks [G; A]
    and [A' | G'] where both exist, and the loop is the JAX package's TPU
    form, rotated: the first residual before the loop, then solve, apply,
    residual and decide, so the trip on which every column stops does no
    corrective solve.  Without them (a CPU tensor) the products are dense
    and the loop is residual-first, the reference's order, as on the JAX
    package's CPU.  The two orders give the same corrections, undo targets
    and counts; their last bits differ."""
    r = refine_start(st, ctx, solve_exact, scal, rhs, settings, active)
    while not all_true(r.done):
        refine_trip(st, ctx, solve_exact, scal, rhs, settings, r)
    return KKTSolveResult(dx=r.dx, dy=r.dy, dz=r.dz, nitref=r.kout)
