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

banded   K is RCM-permuted by the structure's ``BandPlan`` into 128-blocks
         with block bandwidth bwb, factored and solved in ``ops/band.py``:
         by the band kernels at bwb 1..6 in f64, and by the scan of
         ``ops/band_ldl.py`` (batched ``torch.matmul`` products and the
         leaf kernel) where the reference runs its XLA scan, at bwb above
         6 or under ``factor_dtype="float32"``; ``Settings.band_gemm``
         sets the scan's product type and nothing else, as in the
         reference.  Three ways to the band blocks, as in
         ``eicos_tpu.kkt.factor``:

         direct scatter (f64, bwb = 1, every eliminated LP row a singleton
         or scatter row of the gsplit, cones on narrow ``SOCSplit``
         supports):
         H is never formed; its contributions (one per singleton row on
         the diagonal, a w x w outer product per scatter row, dI, and per
         cone either the eliminating closed form or, on a ``keep_soc``
         plan, the NT-scaled kept block and coupling) are summed straight
         into the diagonal and sub-diagonal blocks, on top of a
         lane-invariant base of A, -dI and identity padding pivots.
         Contributions that land above the band or on a padding column,
         which the reference sends to a dump slot the band factor never
         reads, are dropped.  With kept cones the factor holds S K S,
         S = diag(W_s^-1, I, I): kept block -(I + d W^-2), coupling
         W^-1 G_s, and ``solve_exact`` scales the kept rows in and out.

         gathered from H (any bwb, no kept cones): the dense per-lane
         H (n, n) is assembled as for "reduced" and the blocks Kd (L, nb,
         B, B), Ksubs (L, nb, bwb, B, B) are gathered from H.ravel() and
         the shared [A.ravel() | (-d, 0, 1)] by static maps.

         gathered from K (a ``keep_soc`` plan off the scatter path): the
         unscaled dense K of "reduced", its permuted blocks gathered.

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

Iterative refinement runs against the exact regularized operator with the
dense equilibrated G and A (``torch.matmul``, as the JAX package computes
them on the CPU), in the reference's residual-first order, with per-lane
and per-column stopping.

What is not ported raises ``NotImplementedError`` (a block size other
than 128); nothing falls back silently.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cones
from .ops.band import band_factor, band_solve
from .ops.band_ldl import B, KP
from .ops.ldl import ldl_factor, ldl_factor_subst, ldl_solve, pad_to_block
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
    blocks (``eicos_tpu.kkt.factor``'s ``direct_band``): an f64 factor at
    block bandwidth 1, every eliminated LP row a singleton or scatter row
    of the gsplit, and narrow per-cone column supports (``SOCSplit``)
    where there are cones."""
    split = st.gsplit
    return bool(st.band.bwb == 1 and settings.factor_dtype == "float64"
                and split is not None
                and not split.dense_rows and (split.n_sing or split.n_spr)
                and (st.n_sc == 0 or st.socsplit is not None))


def require_slice(st: ProblemStructure, settings) -> None:
    """Raise unless (structure, settings) is ported: 128-blocks, and under
    "banded" a plan of 128-blocks that covers the factored system."""
    if settings.block != B:
        raise NotImplementedError(f"LDL^T block size must be {B}")
    if settings.kkt_strategy != "banded":
        return
    plan = st.band
    if plan is None:
        raise ValueError(
            "kkt_strategy='banded' needs structure.with_band_plan(...)")
    if plan.block != B:
        raise NotImplementedError(f"band block size must be {B}")
    ms = st.m - st.l if _keep_soc(st, settings) else 0
    if plan.dim != pad_to_block(ms + st.n + st.p, B):
        raise ValueError(f"band plan covers {plan.dim} rows, expected "
                         f"{pad_to_block(ms + st.n + st.p, B)}")


# ------------------------------------------------------ static index maps

def _band_gather_split(n: int, p: int, Dp: int, perm: np.ndarray,
                       bwb: int = 1, ms: int = 0):
    """Static maps of the gathered band blocks
    (``eicos_tpu.kkt._band_gather_idx`` and ``_band_gather_split``): for
    each position of the (nb, B, B) diagonal blocks and of the (nb, bwb, B,
    B) sub-diagonal blocks (block [k, j-1] is K[k, k-j]), a mask of the
    positions that hold an H entry, their index into the per-lane
    H.ravel(), and the others' index into the shared
    [A.ravel() | (-delta, 0, 1)].  Returns (diag maps, sub maps).

    ms == 0: K = [[H, A'], [A, -delta I]] over [x | y].  ms > 0 (kept
    cones): K over [z_soc | x | y]; the per-lane NT-scaled blocks at the
    z_soc coordinates map to the shared zero, and the direct scatter adds
    them.  Padding rows get identity pivots."""
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

    nb = Dp // B
    idx_diag = np.empty((nb, B, B), np.int64)
    idx_subs = np.full((nb, bwb, B, B), c_zero, np.int64)
    for k in range(nb):
        rows = perm[k * B:(k + 1) * B]
        idx_diag[k] = src_block(rows, rows)
        for j in range(1, min(bwb, k) + 1):
            idx_subs[k, j - 1] = src_block(rows,
                                           perm[(k - j) * B:(k - j + 1) * B])

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
                      socsplit=None, keep_q: tuple = ()) -> np.ndarray:
    """Flat targets in a per-lane [diag | sub] buffer of 2 nb B B values
    for the contributions [spr (n_spr w w) | sing (n_sing) | dI (n) | soc]
    (``eicos_tpu.kkt._band_scatter_idx``).  Contributions above the band
    or on a padding column go to the dump slot nb B B.

    The soc part is either the H contributions on the ``SOCSplit`` column
    supports (eliminating layout, (n_sc, w, w)) or, with ``keep_q`` (the
    cone dimensions of a ``keep_soc`` plan), the NT-scaled kept layout:
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
        flat = (bi * B + pi % B) * B + pj % B
        out = np.where(bi == bj, flat,
                       np.where(bi == bj + 1, nbb + flat, dump))
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
    nb = Dp // B
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(Dp)
    keep = bool(plan.keep_soc and st.n_sc)
    ms = st.cone.ms if keep else 0
    common = dict(Dp=Dp, perm=_t(perm, device), iperm=_t(iperm, device))
    if keep and not direct:
        # blocks of the permuted dense K over [z_soc | x | y]; the base
        # only zeroes the blocks left of block column 0
        rows = perm.reshape(nb, B)
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
        n, p, Dp, perm, plan.bwb, ms)
    maps = dict(dmask=_t(dmask, device, torch.bool), dio=_t(dio, device),
                smask=_t(smask, device, torch.bool), sio=_t(sio, device))
    if direct:
        idx = _band_scatter_idx(n, Dp, perm, st.gsplit, st.socsplit,
                                st.q if keep else ())
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
               keep: bool = True) -> DenseMaps:
    """The maps of the dense K that keeps every SOC row, with ``keep``
    false of the K over [x | y] with every row eliminated ("normal"), or
    with ``h_only`` of a bare (n, n) H with every row eliminated."""
    n, p = st.n, st.p
    ms = 0 if h_only or not keep else st.m - st.l
    Dp = n if h_only else pad_to_block(ms + n + p, B)
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


@functools.lru_cache(maxsize=16)
def soc_maps(st: ProblemStructure, device: str) -> SocMaps:
    qidx, valid = _soc_pad_maps(st.q, st.cone.ms)
    head = (np.arange(qidx.shape[1])[None, :] == 0) & valid
    return SocMaps(qidx=_t(qidx, device), valid=_t(valid, device, torch.bool),
                   head=_t(head, device, torch.bool),
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
    type too."""

    G: torch.Tensor
    A: torch.Tensor
    Gf: torch.Tensor
    split: Optional[SplitMaps]
    spr_outer: Optional[torch.Tensor]   # ([L,] n_spr, w, w) g_i g_j
    sing_sq: Optional[torch.Tensor]     # ([L,] n_sing) g^2
    keep_soc: bool = False              # SOC rows stay in the factor
    band: Optional[BandMaps] = None
    Kd0: Optional[torch.Tensor] = None  # ([L,] nb, B, B) A, -dI, padding
    Ks0: Optional[torch.Tensor] = None  # ([L,] nb, [bwb,] B, B)
    dense: Optional[DenseMaps] = None
    K0: Optional[torch.Tensor] = None   # ([L,] Dp, Dp)
    soc: Optional[SocMaps] = None
    soc_gsub: Optional[torch.Tensor] = None  # ([L,] n_sc, dmax, w) G_soc
    soc_gram: Optional[torch.Tensor] = None  # ([L,] n_sc, w, w) Gq'Gq


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


def _full_base(st, G, A, delta):
    """The lane-invariant part of the "full" K over [z | x | y]
    (``eicos_tpu.kkt.make_context``): G, A, +dI on x, -dI on y, 1 on
    padding; the z diagonal block is written per factor."""
    n, p, m = st.n, st.p, st.m
    D = m + n + p
    Dp = pad_to_block(D, B)
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


def make_context(st: ProblemStructure, G, A, settings) -> KKTContext:
    require_slice(st, settings)
    dev = str(G.device)
    delta = settings.deltastat
    if settings.kkt_strategy == "full":
        return KKTContext(G=G, A=A, Gf=G, split=None, spr_outer=None,
                          sing_sq=None, K0=_full_base(st, G, A, delta))
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
                     sing_sq=sing_sq, keep_soc=keep)
    lead = A.shape[:-2]
    if settings.kkt_strategy in ("reduced", "normal"):
        dm = dense_maps(st, dev, keep=keep)
        return ctx._replace(
            dense=dm, K0=_dense_base(st, dm, G, A, delta).to(fdtype))
    direct = _direct_band(st, settings)
    maps = band_maps(st, dev, direct)
    ctx = ctx._replace(band=maps)
    if keep and not direct:
        dm = dense_maps(st, dev)
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
    consts = torch.tensor([-delta, 0.0, 1.0], dtype=G.dtype, device=G.device)
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


def _soc_scaled_kept_vals(st, ctx: KKTContext, scal, delta, lanes: int):
    """The per-cone NT-scaled kept blocks -(I + delta W^-2) as (L, n_sc,
    dmax, dmax) padded values (``eicos_tpu.kkt._soc_scaled_kept_vals``),
    with W^-2 = eta^-2 [a^2+w, -c q'; -c q, I + d q q'] per cone.  The
    factor then holds S K S with S = diag(W^-1, I, I): its kept pivot
    block is O(1) and solidly negative, which bounds the growth of the
    unpivoted elimination by ~1/(2 sqrt(delta)).  Pad rows and columns
    are zero and their targets are dropped."""
    sm = ctx.soc
    dmax = sm.qidx.shape[1]
    eye = torch.eye(dmax, dtype=ctx.G.dtype, device=ctx.G.device)
    eye_v = eye * (sm.valid[:, :, None] & sm.valid[:, None, :])
    if scal is None:
        return (-(1.0 + delta) * eye_v).expand(lanes, -1, -1, -1)
    cone = st.cone
    inv_eta2 = 1.0 / scal.eta2
    diag_flat = torch.where(
        cones._k(cone, scal.a).is_head, cones._expand(cone, inv_eta2 * (scal.a * scal.a + scal.w)),
        cones._expand(cone, inv_eta2))
    dpad = _soc_pad(ctx, diag_flat)                     # (L, n_sc, dmax)
    qpad = _soc_pad(ctx, scal.q_flat)
    e = sm.head.to(qpad.dtype)
    ec = (-inv_eta2 * scal.cc)[:, :, None, None]
    ed = (inv_eta2 * scal.dd)[:, :, None, None]
    W2i = (dpad[..., :, None] * eye
           + ec * (e[:, :, None] * qpad[..., None, :]
                   + qpad[..., :, None] * e[:, None, :])
           + ed * qpad[..., :, None] * qpad[..., None, :])
    return -(eye_v + delta * W2i)


def _soc_coupling_vals(st, ctx: KKTContext, scal, lanes: int):
    """The per-cone W^-1 G_soc coupling blocks (L, n_sc, dmax, w) on the
    ``SOCSplit`` column supports (``eicos_tpu.kkt._soc_coupling_vals``).
    W^-1 = eta^-1 [a, -q'; -q, I + qq'/(1+a)] per cone:
    head row  = eta^-1 (a g0 - q'G1),
    tail rows = eta^-1 (G1 - q (g0 - q'G1/(1+a)))."""
    Gsub = ctx.soc_gsub
    if scal is None:
        return Gsub.expand(lanes, *Gsub.shape[-3:])
    qpad = _soc_pad(ctx, scal.q_flat)
    qG = (qpad[..., None] * Gsub).sum(-2)               # q'G1, (L, n_sc, w)
    g0 = Gsub[..., 0, :]
    head = scal.a[..., None] * g0 - qG
    t = -(g0 - qG / (1.0 + scal.a)[..., None])
    tails = Gsub + qpad[..., None] * t[..., None, :]
    out = torch.where(ctx.soc.head[:, :, None], head[..., None, :], tails)
    return out * (1.0 / scal.eta)[..., None, None]


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


def _band_scatter_vals(st, ctx: KKTContext, winv_lp, delta, scal=None):
    """Per-lane contributions ordered as the scatter targets: [spr | sing
    | dI | soc], the soc part being the eliminating closed form or, on a
    ``keep_soc`` plan, the kept blocks and then the coupling twice (once
    per orientation)."""
    lanes = winv_lp.shape[0]
    vals = []
    if ctx.spr_outer is not None:
        vals.append(_spr_vals(ctx, winv_lp).reshape(lanes, -1))
    if ctx.sing_sq is not None:
        vals.append(_sing_vals(ctx, winv_lp))
    vals.append(winv_lp.new_full((lanes, st.n), delta))
    if st.n_sc and ctx.keep_soc:
        vals.append(_soc_scaled_kept_vals(st, ctx, scal, delta,
                                          lanes).reshape(lanes, -1))
        coup = _soc_coupling_vals(st, ctx, scal, lanes).reshape(lanes, -1)
        vals += [coup, coup]
    elif st.n_sc:
        vals.append(_soc_band_vals(st, ctx, scal, delta,
                                   lanes).reshape(lanes, -1))
    return torch.cat(vals, -1)


def band_blocks(st, ctx: KKTContext, winv_lp, delta, scal=None):
    """The per-lane band blocks (Kd, Ks), each (L, nb, B, B), of the
    direct scatter: the base plus the scattered contributions."""
    lanes = winv_lp.shape[0]
    Dp = ctx.band.Dp
    nbb = (Dp // B) * B * B
    buf = winv_lp.new_zeros(lanes, 2 * nbb)
    buf[:, ctx.band.scatter.targets] = segment_sum(
        ctx.band.scatter, _band_scatter_vals(st, ctx, winv_lp, delta, scal))
    bufb = buf.view(lanes, 2, Dp // B, B, B)
    return ctx.Kd0 + bufb[:, 0], ctx.Ks0[..., 0, :, :] + bufb[:, 1]


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
    of the TPU gate): f64 only; never under ``dense_solve="inverse"``;
    always under "subst"; under "auto" on a CUDA tensor, except for the
    "full" strategy, which the reference keeps on the inverse path."""
    if settings.dense_solve == "inverse" or K.dtype != torch.float64:
        return False
    if settings.dense_solve == "subst":
        return True
    return settings.kkt_strategy != "full" and K.device.type == "cuda"


def _factor_dense(K: torch.Tensor, settings):
    """The dense factor of the f64 ``K``, which is consumed: substitution
    form or explicit inverse (``_use_subst``)."""
    if _use_subst(K, settings):
        return ldl_factor_subst(K)
    return ldl_factor(K)


def _factor_in_dtype(K: torch.Tensor, settings):
    """Factor ``K`` (f64, or already cast) in ``settings.factor_dtype``:
    an f32 factor stays f32 and takes the inverse path."""
    if settings.factor_dtype == "float32":
        return ldl_factor(K.to(torch.float32))
    return _factor_dense(K, settings)


def _solve_padded(fac, rr: torch.Tensor) -> torch.Tensor:
    """``ldl_solve`` in the factor's type, cast back to the type of rr."""
    return ldl_solve(fac, rr.to(fac.d.dtype)).to(rr.dtype)


def _factor_full(st: ProblemStructure, ctx: KKTContext,
                 scal: Optional[cones.Scaling], settings, lanes: int):
    """``factor`` for the "full" strategy: K over [z | x | y] with
    -(W^2 + dI) written into the base, nothing eliminated."""
    n, p, m = st.n, st.p, st.m
    delta = settings.deltastat
    D = m + n + p
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

    def solve_exact(rhs):
        bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]
        rr = torch.cat([bz, bx, by,
                        rhs.new_zeros(*rhs.shape[:-1], Dp - D)], -1)
        x = _solve_padded(fac, rr)
        return x[..., m:m + n], x[..., m + n:D], x[..., :m]

    return solve_exact


def factor(st: ProblemStructure, ctx: KKTContext,
           scal: Optional[cones.Scaling], settings, lanes: int):
    """Assemble and factor for the current NT scaling (None = identity
    scalings, the init factorization).  Returns
    ``solve_exact(rhs) -> (dx, dy, dz)`` for packed right-hand sides
    (L, k, n+p+m), one solve of the factored system without refinement.

    Except under "full", the factored system runs over [z_soc | x | y]
    with the ``ms`` kept SOC rows first (none when the cones are
    eliminated), and the ``me`` eliminated rows of G enter through the
    exact Schur complement.  On the banded direct scatter with kept cones
    the factor holds S K S with S = diag(W^-1, I, I), and the kept rows of
    the right-hand side and of the solution pass through
    ``cones.scale_winv_soc``.  Under ``factor_dtype="float32"`` the
    assembly, the factor and ``solve_exact`` compute in f32 and the
    directions are cast back."""
    if settings.kkt_strategy == "full":
        return _factor_full(st, ctx, scal, settings, lanes)
    n, p, l = st.n, st.p, st.l
    delta = settings.deltastat
    G = ctx.Gf
    fdtype = G.dtype
    if scal is not None and fdtype != ctx.G.dtype:
        scal = cones.Scaling(*[a.to(fdtype) for a in scal])
    if scal is None:
        winv_lp = G.new_full((lanes, l), 1.0 / (1.0 + delta))
    else:
        winv_lp = 1.0 / (scal.v_lp + delta)
    ms = st.m - l if ctx.keep_soc else 0
    me = l if ctx.keep_soc else st.m
    D = ms + n + p
    scaled_kept = False

    if settings.kkt_strategy in ("reduced", "normal"):
        Dp = ctx.dense.Dp
        K = dense_matrix(st, ctx, scal, winv_lp, delta)
        fac = _factor_in_dtype(K, settings)
        del K

        def padded_solve(rr):
            return ldl_solve(fac, rr)
    else:
        maps = ctx.band
        Dp = maps.Dp
        # the scan's product type (``ops/band.py`` reads it only there)
        gdt = torch.float32 if settings.band_gemm == "float32" else None
        if maps.scatter is not None:
            scaled_kept = ctx.keep_soc and scal is not None
            fac = band_factor(*band_blocks(st, ctx, winv_lp, delta, scal))
        else:
            if ctx.keep_soc:
                # a keep_soc plan off the scatter path: the unscaled dense K
                src = dense_matrix(st, ctx, scal, winv_lp, delta)
            else:
                src = G.new_zeros(lanes, n, n)
                _assemble_h(st, ctx, ctx.dense, src, scal, winv_lp, delta)
            fac = band_factor(*_gathered_blocks(ctx, src.view(lanes, -1)),
                              gemm_dtype=gdt)
            del src

        def padded_solve(rr):
            return band_solve(fac, rr[..., maps.perm],
                              gemm_dtype=gdt)[..., maps.iperm]

    Ge = G[..., :me, :]

    def welim(v):
        # (W^2 + dI)^{-1} on the eliminated rows of v (L, k, me)
        v_lp = v[..., :l] * winv_lp[:, None, :]
        if me == l:
            return v_lp
        return torch.cat([v_lp, _elim_soc(st, scal, delta, v[..., l:])], -1)

    def solve_exact(rhs):
        k = rhs.shape[1]
        if k > KP:
            raise ValueError(f"at most {KP} right-hand sides, got {k}")
        out_dtype = rhs.dtype
        rhs = rhs.to(fdtype)
        bx, by, bz = rhs[..., :n], rhs[..., n:n + p], rhs[..., n + p:]
        bz_e, bz_s = bz[..., :me], bz[..., me:]
        if scaled_kept:
            bz_s = cones.scale_winv_soc(st.cone, scal, bz_s)
        r1 = bx + welim(bz_e) @ Ge if me else bx
        rr = torch.cat([bz_s, r1, by,
                        rhs.new_zeros(*rhs.shape[:-1], Dp - D)], -1)
        x = padded_solve(rr)
        dzs = x[..., :ms]
        if scaled_kept:
            dzs = cones.scale_winv_soc(st.cone, scal, dzs)
        dx, dy = x[..., ms:ms + n], x[..., ms + n:D]
        dz_e = welim(dx @ Ge.transpose(-1, -2) - bz_e) if me else bz_e
        dz = torch.cat([dz_e, dzs], -1)
        return dx.to(out_dtype), dy.to(out_dtype), dz.to(out_dtype)

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
