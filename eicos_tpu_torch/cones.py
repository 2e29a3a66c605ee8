"""Jordan-algebra operations over K = R^l_+ x SOC(q_1) x ... x SOC(q_N),
batched over a leading lane axis: a port of ``eicos_tpu.cones``.

Every vector is laid out [LP | SOC_0 | ... ] along its last axis, with the
lane axis first: ``s``, ``z``, ``lam`` are (lanes, m).  ``scale2`` also
takes (lanes, k, m) stacks of right-hand sides (iterative refinement).
Per-cone work is segment arithmetic (fixed-order segment sums over the SOC
part, ``segsum``), so no Python loop runs over cones.

Nesterov-Todd scalings keep the unexpanded closed form

    W   = eta   * [ a   q' ; q  I + q q'/(1+a) ]          (per SOC)
    W^2 = eta^2 * [ a^2+w  c q' ; c q  I + d q q' ]

with w = q'q, c = (1+a) + w/(1+a), d = 1 + 2/(1+a) + w/(1+a)^2.

Out-of-cone iterates are not guarded: as in EiCOS, NaNs from the square
roots flow on into the solver's NaN exit.

For a structure with cones on CUDA tensors, ``update_scalings`` and
``line_search`` are one launch each of ``ops/soc.py``'s kernels
(``csrc/cones.cu``); CPU tensors run the torch code below, their plain
twin.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .ops import kernels, soc
from .segsum import SegmentSum, segment_map, segment_sum
from .structure import ConeStructure


class Scaling(NamedTuple):
    """Nesterov-Todd scaling state, each field with a leading lane axis."""

    w_lp: torch.Tensor    # (L, l)    sqrt(s/z)
    v_lp: torch.Tensor    # (L, l)    s/z = w_lp^2
    a: torch.Tensor       # (L, n_sc) wbar_0
    q_flat: torch.Tensor  # (L, ms)   wbar tail, 0 at head positions
    w: torch.Tensor       # (L, n_sc) q'q
    eta: torch.Tensor     # (L, n_sc) (sres/zres)^(1/4)
    eta2: torch.Tensor    # (L, n_sc) eta^2
    cc: torch.Tensor      # (L, n_sc) c = (1+a) + w/(1+a)
    dd: torch.Tensor      # (L, n_sc) d = 1 + 2/(1+a) + w/(1+a)^2


class _ConeConsts(NamedTuple):
    seg: torch.Tensor           # (ms,) int64 cone id of each SOC entry
    is_head: torch.Tensor       # (ms,) bool
    head_offsets: torch.Tensor  # (n_sc,) int64
    segs: SegmentSum            # the per-cone sums over the SOC part
    heads: torch.Tensor         # (ms, n_sc) f64: 1 at each cone's head
    offs: torch.Tensor          # (n_sc + 1,) int32 head offsets, then ms


@functools.lru_cache(maxsize=64)
def _consts(st: ConeStructure, device: str) -> _ConeConsts:
    """The cone layout's index tensors on ``device``, built once: a
    captured CUDA graph copies nothing from the host."""
    head_offsets = torch.as_tensor(st.head_offsets, dtype=torch.int64,
                                   device=device)
    heads = torch.zeros(st.ms, st.n_sc, dtype=torch.float64, device=device)
    heads[head_offsets, torch.arange(st.n_sc, device=device)] = 1.0
    return _ConeConsts(
        seg=torch.as_tensor(st.seg, dtype=torch.int64, device=device),
        is_head=torch.as_tensor(st.is_head, device=device),
        head_offsets=head_offsets, segs=segment_map(st.seg, device),
        heads=heads, offs=torch.as_tensor(
            np.append(st.head_offsets, st.ms), dtype=torch.int32,
            device=device))


def _k(st, x) -> _ConeConsts:
    return _consts(st, str(x.device))


# ---------------------------------------------------------------- helpers

def _bc(t, x):
    """Broadcast a per-lane (L, s) field against x of shape (L, ..., m)."""
    return t.view(t.shape[0], *([1] * (x.dim() - 2)), t.shape[-1])


def seg_sum(st: ConeStructure, x):
    """Per-cone sum over the SOC part: (..., ms) -> (..., n_sc)."""
    return segment_sum(_k(st, x).segs, x)


def _expand(st: ConeStructure, pc):
    """Broadcast per-cone scalars back to entries: (..., n_sc) -> (..., ms)."""
    return pc[..., _k(st, pc).seg]


def _heads(st: ConeStructure, x):
    """Gather cone heads: (..., ms) -> (..., n_sc)."""
    return x[..., _k(st, x).head_offsets]


def _split(st: ConeStructure, x):
    return x[..., :st.l], x[..., st.l:]


# ------------------------------------------------------------- NT scaling

def update_scalings(st: ConeStructure, s, z):
    """NT scalings and lam = W z (EiCOS updateScalings).
    Returns (scaling, lambda)."""
    if st.n_sc and not kernels.on_cpu(s):
        *fields, lam = soc.scalings(st, _k(st, s).offs, s, z)
        return Scaling(*fields), lam
    s_lp, s_s = _split(st, s)
    z_lp, z_s = _split(st, z)

    v_lp = s_lp / z_lp
    w_lp = torch.sqrt(v_lp)

    if st.n_sc:
        is_head = _k(st, s).is_head
        s0 = _heads(st, s_s)
        z0 = _heads(st, z_s)
        sres = 2.0 * s0 * s0 - seg_sum(st, s_s * s_s)
        zres = 2.0 * z0 * z0 - seg_sum(st, z_s * z_s)
        snorm = torch.sqrt(sres)   # NaN if out of cone: propagates
        znorm = torch.sqrt(zres)

        skbar = s_s / _expand(st, snorm)
        zkbar = z_s / _expand(st, znorm)

        eta2 = snorm / znorm
        eta = torch.sqrt(eta2)

        gamma = torch.sqrt(0.5 * (1.0 + seg_sum(st, skbar * zkbar)))
        half_by_gamma = 0.5 / gamma
        a = half_by_gamma * (_heads(st, skbar) + _heads(st, zkbar))
        q_flat = torch.where(
            is_head, 0.0, _expand(st, half_by_gamma) * (skbar - zkbar))
        w = seg_sum(st, q_flat * q_flat)

        one_a = 1.0 + a
        cc = one_a + w / one_a
        dd = 1.0 + 2.0 / one_a + w / (one_a * one_a)
    else:
        zf = s.new_zeros(s.shape[0], 0)
        a = w = eta = eta2 = cc = dd = q_flat = zf

    scal = Scaling(w_lp=w_lp, v_lp=v_lp, a=a, q_flat=q_flat, w=w,
                   eta=eta, eta2=eta2, cc=cc, dd=dd)
    return scal, scale(st, scal, z)


def scale(st: ConeStructure, scal: Scaling, z):
    """lam = W z (EiCOS scale)."""
    z_lp, z_s = _split(st, z)
    lam_lp = _bc(scal.w_lp, z) * z_lp
    if st.n_sc:
        a, eta = _bc(scal.a, z), _bc(scal.eta, z)
        q = _bc(scal.q_flat, z)
        z0 = _heads(st, z_s)
        zeta = seg_sum(st, q * z_s)
        factor = z0 + zeta / (1.0 + a)
        head_val = eta * (a * z0 + zeta)
        lam_s = torch.where(
            _k(st, z).is_head, _expand(st, head_val),
            _expand(st, eta) * (z_s + _expand(st, factor) * q))
    else:
        lam_s = z_s
    return torch.cat([lam_lp, lam_s], -1)


def scale2(st: ConeStructure, scal: Scaling, x):
    """y = W^2 x in the unexpanded closed form (EiCOS scale2add without the
    u/v expansion).  x is (L, m) or (L, k, m)."""
    x_lp, x_s = _split(st, x)
    y_lp = _bc(scal.v_lp, x) * x_lp
    if st.n_sc:
        a, w = _bc(scal.a, x), _bc(scal.w, x)
        eta2, cc, dd = _bc(scal.eta2, x), _bc(scal.cc, x), _bc(scal.dd, x)
        q = _bc(scal.q_flat, x)
        x0 = _heads(st, x_s)
        qx = seg_sum(st, q * x_s)
        head_val = eta2 * ((a * a + w) * x0 + cc * qx)
        tail_coeff = eta2 * (cc * x0 + dd * qx)
        y_s = torch.where(
            _k(st, x).is_head, _expand(st, head_val),
            _expand(st, eta2) * x_s + _expand(st, tail_coeff) * q)
    else:
        y_s = x_s
    return torch.cat([y_lp, y_s], -1)


def scale2_inv(st: ConeStructure, scal: Scaling, x):
    """y = W^{-2} x in closed form: W^2 with q -> -q, eta^2 -> 1/eta^2."""
    x_lp, x_s = _split(st, x)
    y_lp = x_lp / scal.v_lp
    if st.n_sc:
        x0 = _heads(st, x_s)
        qx = seg_sum(st, scal.q_flat * x_s)
        inv_eta2 = 1.0 / scal.eta2
        head_val = inv_eta2 * ((scal.a * scal.a + scal.w) * x0
                               - scal.cc * qx)
        tail_coeff = inv_eta2 * (-scal.cc * x0 + scal.dd * qx)
        y_s = torch.where(
            _k(st, x).is_head, _expand(st, head_val),
            _expand(st, inv_eta2) * x_s + _expand(st, tail_coeff)
            * scal.q_flat)
    else:
        y_s = x_s
    return torch.cat([y_lp, y_s], -1)


def scale2reg_inv(st: ConeStructure, scal: Scaling, delta: float, x):
    """y = (W^2 + delta*I)^{-1} x in closed form (Woodbury over the
    per-cone rank-2 structure; see ``scale2reg_inv_soc``)."""
    x_lp, x_s = _split(st, x)
    y_lp = x_lp / (scal.v_lp + delta)
    y_s = scale2reg_inv_soc(st, scal, delta, x_s) if st.n_sc else x_s
    return torch.cat([y_lp, y_s], -1)


def scale2reg_inv_soc(st: ConeStructure, scal: Scaling, delta: float, x_s):
    """The SOC part of ``scale2reg_inv``: with W^2 = eta^2 I + U C U',
    U = [e, q], C = eta^2 [[2w, c], [c, d]],
    (W^2 + dI)^{-1} = b I - b^2 U (C^{-1} + b U'U)^{-1} U', b = 1/(eta^2+d).
    x_s is (L, ms) or (L, k, ms)."""
    eta2, w = _bc(scal.eta2, x_s), _bc(scal.w, x_s)
    q = _bc(scal.q_flat, x_s)
    b = 1.0 / (eta2 + delta)
    c11 = eta2 * (2.0 * w)
    c12 = eta2 * _bc(scal.cc, x_s)
    c22 = eta2 * _bc(scal.dd, x_s)
    detC = c11 * c22 - c12 * c12
    m11 = c22 / detC + b
    m12 = -c12 / detC
    m22 = c11 / detC + b * w
    detM = m11 * m22 - m12 * m12
    u1 = _heads(st, x_s)
    u2 = seg_sum(st, q * x_s)
    a1 = (m22 * u1 - m12 * u2) / detM
    a2 = (-m12 * u1 + m11 * u2) / detM
    be = _expand(st, b)
    return be * x_s - be * be * (
        torch.where(_k(st, x_s).is_head, _expand(st, a1), 0.0)
        + _expand(st, a2) * q)


# --------------------------------------------------------- Jordan algebra

def conic_product(st: ConeStructure, u, v):
    """w = u o v and mu = sum |w_lp| + sum_cones |w_head| (EiCOS
    conicProduct).  Returns (w (L, m), mu (L,))."""
    u_lp, u_s = _split(st, u)
    v_lp, v_s = _split(st, v)
    w_lp = u_lp * v_lp
    mu = w_lp.abs().sum(-1)
    if st.n_sc:
        u0 = _heads(st, u_s)
        v0 = _heads(st, v_s)
        w0 = seg_sum(st, u_s * v_s)
        mu = mu + w0.abs().sum(-1)
        w_s = torch.where(
            _k(st, u).is_head, _expand(st, w0),
            _expand(st, u0) * v_s + _expand(st, v0) * u_s)
    else:
        w_s = u_s
    return torch.cat([w_lp, w_s], -1), mu


def conic_division(st: ConeStructure, u, w):
    """v = u \\ w, the Jordan inverse product (EiCOS conicDivision)."""
    u_lp, u_s = _split(st, u)
    w_lp, w_s = _split(st, w)
    v_lp = w_lp / u_lp
    if st.n_sc:
        is_head = _k(st, u).is_head
        u0 = _heads(st, u_s)
        w0 = _heads(st, w_s)
        rho = 2.0 * u0 * u0 - seg_sum(st, u_s * u_s)
        zeta = seg_sum(st, torch.where(is_head, 0.0, u_s * w_s))
        factor = (zeta / u0 - w0) / rho
        head_val = (u0 * w0 - zeta) / rho
        v_s = torch.where(
            is_head, _expand(st, head_val),
            _expand(st, factor) * u_s + w_s / _expand(st, u0))
    else:
        v_s = w_s
    return torch.cat([v_lp, v_s], -1)


# ------------------------------------------------------------ line search

def line_search(st: ConeStructure, lam, ds, dz, tau, dtau, kap, dkap,
                stepmin: float, stepmax: float):
    """Max step to the cone boundary in scaled variables, saturated
    (EiCOS lineSearch).  tau, dtau, kap, dkap are (L,); returns (L,)."""
    if st.n_sc and not kernels.on_cpu(lam):
        return soc.line_search(st, _k(st, lam).offs, lam, ds, dz, tau, dtau,
                               kap, dkap, stepmin, stepmax)
    lam_lp, lam_s = _split(st, lam)
    ds_lp, ds_s = _split(st, ds)
    dz_lp, dz_s = _split(st, dz)

    big = 1.0 / 1e-13
    if st.l > 0:
        rhomin = (ds_lp / lam_lp).amin(-1)
        sigmamin = (dz_lp / lam_lp).amin(-1)
        alpha = torch.where(
            -sigmamin > -rhomin,
            torch.where(sigmamin < 0.0, 1.0 / (-sigmamin), big),
            torch.where(rhomin < 0.0, 1.0 / (-rhomin), big))
    else:
        alpha = torch.full_like(tau, 10.0)

    mtd = -tau / dtau
    mkd = -kap / dkap
    alpha = torch.where((mtd > 0.0) & (mtd < alpha), mtd, alpha)
    alpha = torch.where((mkd > 0.0) & (mkd < alpha), mkd, alpha)

    if st.n_sc:
        head = _k(st, lam).is_head
        lam0 = _heads(st, lam_s)
        lknorm2 = 2.0 * lam0 * lam0 - seg_sum(st, lam_s * lam_s)
        in_cone = lknorm2 > 0.0   # cones with lknorm2 <= 0 are skipped
        safe = torch.where(in_cone, lknorm2, 1.0)
        lknorm = torch.sqrt(safe)
        lkbar = lam_s / _expand(st, lknorm)
        lkbar0 = _heads(st, lkbar)
        lknorminv = 1.0 / lknorm

        def conic_norm(d_s):
            d0 = _heads(st, d_s)
            lkJd = 2.0 * lkbar0 * d0 - seg_sum(st, lkbar * d_s)
            rho0 = lknorminv * lkJd
            factor = (lkJd + d0) / (lkbar0 + 1.0)
            tail = torch.where(
                head, 0.0,
                _expand(st, lknorminv) * (d_s - _expand(st, factor) * lkbar))
            tail_norm = torch.sqrt(seg_sum(st, tail * tail))
            return tail_norm - rho0

        rhonorm = conic_norm(ds_s)
        sigmanorm = conic_norm(dz_s)
        conic_step = torch.clamp(torch.maximum(sigmanorm, rhonorm), min=0.0)
        conic_step = torch.where(in_cone, conic_step, 0.0)
        cand = torch.where(conic_step > 0.0, 1.0 / conic_step, torch.inf)
        alpha = torch.minimum(alpha, cand.amin(-1))

    return torch.clamp(alpha, stepmin, stepmax)


# ------------------------------------------------------------ init helper

def bring_to_cone(st: ConeStructure, r, gamma: float):
    """s = r, or r + (1+alpha) e if r is not interior (EiCOS bringToCone)."""
    r_lp, r_s = _split(st, r)
    alpha = r.new_full((r.shape[0],), -gamma)
    if st.l > 0:
        cand = torch.where(r_lp <= 0.0, -r_lp, -torch.inf)
        alpha = torch.maximum(alpha, cand.amax(-1))
    if st.n_sc:
        is_head = _k(st, r).is_head
        r0 = _heads(st, r_s)
        tail_norm = torch.sqrt(seg_sum(st, torch.where(is_head, 0.0,
                                                        r_s * r_s)))
        cres = r0 - tail_norm
        cand = torch.where(cres <= 0.0, -cres, -torch.inf)
        alpha = torch.maximum(alpha, cand.amax(-1))
    alpha = alpha + 1.0
    s_lp = r_lp + alpha[:, None]
    if st.n_sc:
        s_s = torch.where(_k(st, r).is_head, r_s + alpha[:, None], r_s)
    else:
        s_s = r_s
    return torch.cat([s_lp, s_s], -1)


# --------------------------------------------------- dense W^2 assembly

def w2_soc_dense(st: ConeStructure, scal: Scaling):
    """The SOC part of W^2 as dense (L, ms, ms) blocks:
    W2 = D + E diag(eta2 c) Q' + Q diag(eta2 c) E' + Q diag(eta2 d) Q'."""
    k = _consts(st, str(scal.a.device))
    diag_soc = torch.where(k.is_head,
                           _expand(st, scal.eta2 * (scal.a * scal.a
                                                    + scal.w)),
                           _expand(st, scal.eta2))
    W2 = torch.diag_embed(diag_soc)
    onehot = (k.seg[:, None] == torch.arange(st.n_sc,
                                             device=k.seg.device)[None, :])
    Q = torch.where(onehot, scal.q_flat[:, :, None], 0.0)  # (L, ms, n_sc)
    E = k.heads.to(scal.a.dtype)
    ec = (scal.eta2 * scal.cc)[:, :, None]
    ed = (scal.eta2 * scal.dd)[:, :, None]
    W2 = W2 + E @ (ec * Q.transpose(1, 2)) + Q @ (ec * E.T)
    return W2 + Q @ (ed * Q.transpose(1, 2))


def w2_dense(st: ConeStructure, scal: Scaling):
    """W^2 as dense (L, m, m) blocks: diagonal LP part + ``w2_soc_dense``."""
    W2 = torch.diag_embed(torch.cat(
        [scal.v_lp, scal.v_lp.new_zeros(scal.v_lp.shape[0], st.ms)], -1))
    if st.n_sc:
        W2[:, st.l:, st.l:] = w2_soc_dense(st, scal)
    return W2
