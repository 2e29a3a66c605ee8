"""Ruiz-style max-norm equilibration: a port of ``eicos_tpu.equilibrate``
(EiCOS setEquilibration/unsetEquilibration).

``equil_iters`` rounds of row/column max-abs scaling with SOC row groups
collapsed to their sum and sqrt damping guarded at 1e-6.  G and A are
either shared, (m, n) and (p, n), or per lane, (L, m, n) and (L, p, n);
c, h, b are (L, .).  Shared G and A are equilibrated once, and their
scalings broadcast over the lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cones
from .structure import ProblemStructure


class Equilibration(NamedTuple):
    G: torch.Tensor        # equilibrated ([L,] m, n)
    A: torch.Tensor        # equilibrated ([L,] p, n)
    c: torch.Tensor        # (L, n) c / x_equil
    h: torch.Tensor        # (L, m) h / G_equil
    b: torch.Tensor        # (L, p) b / A_equil
    x_equil: torch.Tensor  # ([L,] n)
    A_equil: torch.Tensor  # ([L,] p)
    G_equil: torch.Tensor  # ([L,] m)


def _sqrt_damped(v):
    """a -> 1 if |a| < 1e-6 else sqrt(a)."""
    return torch.where(v.abs() < 1e-6, 1.0, torch.sqrt(v))


def equilibrate(st: ProblemStructure, G, A, c, h, b,
                iters: int = 3) -> Equilibration:
    n, p, m = st.n, st.p, st.m
    lead = torch.broadcast_shapes(G.shape[:-2], A.shape[:-2])
    dev, dt = c.device, c.dtype
    x_equil = torch.ones(*lead, n, dtype=dt, device=dev)
    A_equil = torch.ones(*lead, p, dtype=dt, device=dev)
    G_equil = torch.ones(*lead, m, dtype=dt, device=dev)
    # the cone ids from the device's cached constants: a captured
    # prologue copies nothing from the host
    seg = cones._consts(st.cone, str(dev)).seg if st.n_sc else None

    for _ in range(iters):
        absA = A.abs()
        absG = G.abs()
        x_tmp = torch.zeros(*lead, n, dtype=dt, device=dev)
        if p:
            x_tmp = torch.maximum(x_tmp, absA.amax(-2))
        if m:
            x_tmp = torch.maximum(x_tmp, absG.amax(-2))
        A_tmp = (absA.amax(-1) if n
                 else torch.zeros(*A.shape[:-2], p, dtype=dt, device=dev))
        G_tmp = (absG.amax(-1) if n
                 else torch.zeros(*G.shape[:-2], m, dtype=dt, device=dev))

        if st.n_sc:
            soc = G_tmp[..., st.l:]
            totals = cones.seg_sum(st.cone, soc)
            G_tmp = torch.cat([G_tmp[..., :st.l], totals[..., seg]], -1)

        x_tmp = _sqrt_damped(x_tmp)
        A_tmp = _sqrt_damped(A_tmp)
        G_tmp = _sqrt_damped(G_tmp)

        A = A / A_tmp[..., :, None] / x_tmp[..., None, :]
        G = G / G_tmp[..., :, None] / x_tmp[..., None, :]

        x_equil = x_equil * x_tmp
        A_equil = A_equil * A_tmp
        G_equil = G_equil * G_tmp

    return Equilibration(G=G, A=A, c=c / x_equil, h=h / G_equil,
                         b=b / A_equil, x_equil=x_equil, A_equil=A_equil,
                         G_equil=G_equil)
