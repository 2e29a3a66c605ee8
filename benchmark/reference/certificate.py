"""The plain reference: the optimality conditions of the conic program

    minimize c'x  subject to  Ax = b,  Gx + s = h,  s in K,

K = R^l_+ x SOC(q_1) x ... x SOC(q_N), with its dual

    maximize -b'y - h'z  subject to  A'y + G'z + c = 0,  z in K,

checked in NumPy on the benchmark's own problem data against the answers
(x, y, z, s) that the program returned.  An answer that says OPTIMAL is
right when it is primal feasible, dual feasible, in the cone, and its
duality gap c'x + b'y + h'z (= s'z for a feasible pair) is closed: by weak
duality its objective is then optimal to that gap.  Nothing here imports
the program; the data are the benchmark's, unscaled, so whatever the
program derived from them (equilibration, splits, the band plan) plays no
part.

Each reading is relative, per lane, so that one limit serves every lane:

- ``pres``: max(||Ax - b||, ||Gx + s - h||) over 1 + the norms of the
  terms (b, x; h, x, s);
- ``dres``: ||A'y + G'z + c|| over 1 + ||c|| + ||y|| + ||z||;
- ``gap``: |c'x + b'y + h'z| over 1 + |c'x| + |b'y + h'z|;
- ``cone``: the largest step outside K of s or z (a negative entry of the
  orthant part, ||u_1|| - u_0 of a second-order part), over 1 + ||s|| +
  ||z||, or 0 inside;

every norm the largest absolute entry.
"""

from __future__ import annotations

import numpy as np

READINGS = ("pres", "dres", "gap", "cone")


def _inf(v):
    return np.abs(v).max(axis=-1) if v.shape[-1] else np.zeros(v.shape[:-1])


def _dot(a, b):
    return (a * b).sum(axis=-1)


def _outside(u, l, q):
    """Per lane, how far ``u`` (lanes, m) lies outside K (0 inside)."""
    worst = np.zeros(u.shape[0])
    if l:
        worst = np.maximum(worst, -u[:, :l].min(axis=1))
    if q:
        starts = l + np.concatenate([[0], np.cumsum(q)[:-1]]).astype(int)
        sq = np.add.reduceat(u[:, l:] ** 2, starts - l, axis=1)
        head = u[:, starts]
        tail = np.sqrt(np.maximum(sq - head ** 2, 0.0))
        worst = np.maximum(worst, (tail - head).max(axis=1))
    return worst


def readings(G, A, c, h, b, l, q, x, y, z, s):
    """The four readings of each lane's answer: a dict of (lanes,) arrays.
    G (m, n), A (p, n) and h (m,) are shared by the lanes; c (lanes, n),
    b (lanes, p) and the answers carry the lane axis."""
    ra = x @ A.T - b
    rg = x @ G.T + s - h
    rd = y @ A + z @ G + c
    nx, ns = _inf(x), _inf(s)
    pres = np.maximum(_inf(ra) / (1 + _inf(b) + nx),
                      _inf(rg) / (1 + _inf(h) + nx + ns))
    dres = _inf(rd) / (1 + _inf(c) + _inf(y) + _inf(z))
    cx = _dot(c, x)
    dual = _dot(b, y) + _dot(h, z)
    gap = np.abs(cx + dual) / (1 + np.abs(cx) + np.abs(dual))
    cone = (np.maximum(_outside(s, l, q), _outside(z, l, q))
            / (1 + ns + _inf(z)))
    return dict(pres=pres, dres=dres, gap=gap, cone=cone)
