"""The second-order-cone kernels of an interior-point iteration
(``csrc/cones.cu``): one launch a call in place of the plain path's
chains of elementwise, gather and batched-product kernels.

``cones.update_scalings``, ``cones.line_search``, ``kkt._soc_eig`` and
``kkt._soc_rotate`` call these for a structure with cones on CUDA tensors
and run their own torch code, the plain twin, on CPU tensors.  Each
wrapper checks its tensors, allocates its outputs and counts its launch in
``kernels.COUNTS`` (``cone_scalings``, ``cone_eig``, ``cone_rotate``,
``cone_line_search``).  Inputs are f64 views of (lanes, ...) with unit
column stride; ``offs`` (n_sc + 1,) int32 holds each cone's first entry in
the SOC segment, then ms.  The kernels give the plain path's bits where its
order of summation is fixed (``segsum`` up to 16 slots) and sum entry by
entry where a library fixes it (the file's head comment).
"""

from __future__ import annotations

import torch

from . import kernels

F64 = torch.float64
ROOT_HALF = 0.5 ** 0.5          # ``kkt._soc_eig``'s r, rounded as there
BIG = 1.0 / 1e-13               # ``cones.line_search``'s unbounded LP step
NO_LP_STEP = 10.0               # and its start without LP rows


def _rows(name, t, shape, dev):
    """The strides but the last of an f64 view of ``shape`` on ``dev``
    with unit column stride."""
    if t.dtype != F64 or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name}: must be a float64 {tuple(shape)} view on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must have unit stride, got "
                         f"strides {t.stride()}")
    return t.stride()[:-1]


def _offs(offs, n_sc, dev):
    kernels.check("offs", offs, (n_sc + 1,), dev, dtype=torch.int32)
    return offs.data_ptr()


def _launch(name, *args, t):
    fn = getattr(kernels.lib("cones"), "eicos_" + name)
    with torch.cuda.device(t.device):
        kernels.launch(fn, *args, kernels.stream(t))
    kernels.count(name)


def scalings(st, offs, s, z):
    """``cones.update_scalings`` on the card: s, z (L, m) -> (w_lp, v_lp,
    a, q_flat, w, eta, eta2, cc, dd, lam), the fields of ``cones.Scaling``
    in order and lam = W z.  ``st`` is the ``ConeStructure``."""
    lanes, m = s.shape
    dev = s.device
    l, n_sc, ms = st.l, st.n_sc, st.ms
    (s_ls,) = _rows("s", s, (lanes, m), dev)
    (z_ls,) = _rows("z", z, (lanes, m), dev)

    def new(*shape):
        return torch.empty(shape, dtype=F64, device=dev)

    w_lp, v_lp = new(lanes, l), new(lanes, l)
    a, w, eta, eta2, cc, dd = (new(lanes, n_sc) for _ in range(6))
    q, lam = new(lanes, ms), new(lanes, m)
    _launch("cone_scalings", s.data_ptr(), s_ls, z.data_ptr(), z_ls,
            _offs(offs, n_sc, dev), lanes, l, n_sc, ms, max(st.q), *[
                t.data_ptr() for t in (w_lp, v_lp, a, q, w, eta, eta2, cc,
                                       dd, lam)], t=s)
    return w_lp, v_lp, a, q, w, eta, eta2, cc, dd, lam


def eig(offs, D, q_flat, a, eta2, gsub, delta=None):
    """``kkt._soc_eig``, ``_soc_kept_vals`` and ``_soc_coupling_vals`` in
    one launch: q_flat (L, ms), a and eta2 (L, n_sc) contiguous, gsub (n_sc,
    D, w) shared or (L, n_sc, D, w) -> (rot (L, n_sc, D, D), lam (L, n_sc,
    D), kept (L, n_sc, D, D), -(diag(lam) + delta I) on each cone's live
    slots, or None without ``delta``, coupling rot @ gsub (L, n_sc, D,
    w))."""
    lanes, n_sc = a.shape
    ms = q_flat.shape[-1]
    dev = a.device
    for name, t, shape in (("q_flat", q_flat, (lanes, ms)),
                           ("a", a, (lanes, n_sc)),
                           ("eta2", eta2, (lanes, n_sc))):
        kernels.check(name, t, shape, dev)
    w = gsub.shape[-1]
    per_lane = gsub.dim() == 4
    kernels.check("gsub", gsub, ((lanes,) if per_lane else ()) + (
        n_sc, D, w), dev)

    def new(*shape):
        return torch.empty(shape, dtype=F64, device=dev)

    rot, lam = new(lanes, n_sc, D, D), new(lanes, n_sc, D)
    kept = None if delta is None else new(lanes, n_sc, D, D)
    coup = new(lanes, n_sc, D, w)
    _launch("cone_eig", q_flat.data_ptr(), a.data_ptr(), eta2.data_ptr(),
            _offs(offs, n_sc, dev), gsub.data_ptr(),
            n_sc * D * w if per_lane else 0, w, lanes, n_sc, ms, D,
            ROOT_HALF, 0.0 if delta is None else float(delta),
            rot.data_ptr(), lam.data_ptr(),
            None if kept is None else kept.data_ptr(), coup.data_ptr(),
            t=a)
    return rot, lam, kept, coup


def rotate(offs, rot, x_s, transpose=False):
    """``kkt._soc_rotate``: rot x (rot' x with ``transpose``) cone by cone;
    rot (L, n_sc, D, D) contiguous, x_s (L, k, ms) -> (L, k, ms)."""
    lanes, k, ms = x_s.shape
    n_sc, D = rot.shape[1], rot.shape[-1]
    dev = x_s.device
    kernels.check("rot", rot, (lanes, n_sc, D, D), dev)
    x_ls, x_rs = _rows("x_s", x_s, (lanes, k, ms), dev)
    y = torch.empty((lanes, k, ms), dtype=F64, device=dev)
    _launch("cone_rotate", rot.data_ptr(), x_s.data_ptr(), x_ls, x_rs,
            _offs(offs, n_sc, dev), lanes, k, n_sc, ms, D, int(transpose),
            y.data_ptr(), t=x_s)
    return y


def line_search(st, offs, lam, ds, dz, tau, dtau, kap, dkap,
                stepmin: float, stepmax: float):
    """``cones.line_search`` for a structure with cones: lam, ds, dz (L, m),
    tau, dtau, kap, dkap (L,) -> the step (L,)."""
    lanes, m = lam.shape
    dev = lam.device
    vecs = []
    for name, t in (("lam", lam), ("ds", ds), ("dz", dz)):
        vecs += [t.data_ptr(), *_rows(name, t, (lanes, m), dev)]
    for name, t in (("tau", tau), ("dtau", dtau), ("kap", kap),
                    ("dkap", dkap)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: must be a ({lanes},) tensor on {dev}")
        vecs += [t.data_ptr(), *_rows(name, t[:, None], (lanes, 1), dev)]
    out = torch.empty((lanes,), dtype=F64, device=dev)
    _launch("cone_line_search", *vecs, _offs(offs, st.n_sc, dev), lanes,
            st.l, st.n_sc, max(st.q), BIG, NO_LP_STEP, float(stepmin),
            float(stepmax), out.data_ptr(), t=lam)
    return out
