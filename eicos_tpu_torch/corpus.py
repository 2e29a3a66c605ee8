"""Problem generators of the benchmark families: a port of
``eicos_tpu.corpus.make_mpc_like`` and ``make_mpc_soc``.

Parsing EiCOS's corpus headers is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .problem import make_problem
from .structure import ProblemStructure


def make_mpc_like(horizon: int = 249, nx: int = 4, nu: int = 2, seed: int = 0,
                  rate_bound: float = 1.0):
    """Generate an MPC01-family LP: a box-constrained linear-dynamics
    trajectory problem in the same LP form/scale class as MPC02
    (n=1496, m=3996, p=499, l=3996, ncones=0 —
    EiCOS test/MPC/MPC02.h:4-8; MPC01 itself is a missing blob).

    Variables: states x_1..x_T (nx each) and inputs u_0..u_{T-1} (nu each),
    n = T*(nx+nu).  Equalities: dynamics x_{t+1} = F x_t + B u_t
    (p = T*nx).  Inequalities: box bounds on all variables (2n rows) plus
    two-sided input rate bounds |u_t - u_{t-1}| <= rate_bound for
    t = 1..T-1 (2*(T-1)*nu rows), so m = 2n + 2*(T-1)*nu.  With the
    benchmark's (horizon=249, nx=2, nu=4) this gives n=1494, p=498,
    m=4972 — at or above MPC02 on every axis (m is 24% larger than the
    family's 3996; the benchmark problem is strictly not lighter).
    """
    rng = np.random.default_rng(seed)
    T = horizon
    n = T * (nx + nu)
    # stable random dynamics
    F = rng.standard_normal((nx, nx))
    F *= 0.95 / max(1e-9, np.max(np.abs(np.linalg.eigvals(F))))
    Bm = rng.standard_normal((nx, nu))
    x0 = rng.standard_normal(nx)

    # variable layout: [x_1..x_T, u_0..u_{T-1}]
    def xidx(t):  # t in 1..T
        return slice((t - 1) * nx, t * nx)

    def uidx(t):  # t in 0..T-1
        return slice(T * nx + t * nu, T * nx + (t + 1) * nu)

    p = T * nx
    A = np.zeros((p, n))
    b = np.zeros(p)
    for t in range(T):
        rows = slice(t * nx, (t + 1) * nx)
        A[rows, xidx(t + 1)] = -np.eye(nx)
        A[rows, uidx(t)] = Bm
        if t == 0:
            b[rows] = -F @ x0
        else:
            A[rows, xidx(t)] = F
    # box constraints on everything: -bound <= v <= bound
    G_box = np.vstack([np.eye(n), -np.eye(n)])
    h_box = np.full(2 * n, 5.0)
    # input rate bounds: -r <= u_t - u_{t-1} <= r for t = 1..T-1
    n_rate = (T - 1) * nu
    R = np.zeros((n_rate, n))
    for t in range(1, T):
        rows = slice((t - 1) * nu, t * nu)
        R[rows, uidx(t)] = np.eye(nu)
        R[rows, uidx(t - 1)] = -np.eye(nu)
    G = np.vstack([G_box, R, -R])
    h = np.concatenate([h_box, np.full(2 * n_rate, rate_bound)])
    m = G.shape[0]
    c = rng.standard_normal(n) * 0.1
    st = ProblemStructure.create(n, p, m, m, ())
    return st, make_problem(st, G, A, c, h, b)


def make_mpc_soc(horizon: int = 249, nx: int = 2, nu: int = 4, seed: int = 0,
                 u_max: float = 1.0):
    """Generate an SOC-constrained MPC at MPC01-family scale: the same
    linear-dynamics trajectory problem as ``make_mpc_like`` but with the
    input bounds replaced by per-step Euclidean norm balls
    ||u_t||_2 <= u_max — one SOC of dimension nu+1 per step.

    The genuinely-conic benchmark lane the reference corpus lacks (its
    SOCPs — issue98, unboundedMaxSqrt — are tiny correctness checks).
    Dims at the default (249, 2, 4): n=1494, p=498, l=2988,
    q=(5,)*249, m=4233.
    """
    rng = np.random.default_rng(seed)
    T = horizon
    n = T * (nx + nu)
    F = rng.standard_normal((nx, nx))
    F *= 0.95 / max(1e-9, np.max(np.abs(np.linalg.eigvals(F))))
    Bm = rng.standard_normal((nx, nu))
    x0 = rng.standard_normal(nx)

    def xidx(t):  # t in 1..T
        return slice((t - 1) * nx, t * nx)

    def uidx(t):  # t in 0..T-1
        return slice(T * nx + t * nu, T * nx + (t + 1) * nu)

    p = T * nx
    A = np.zeros((p, n))
    b = np.zeros(p)
    for t in range(T):
        rows = slice(t * nx, (t + 1) * nx)
        A[rows, xidx(t + 1)] = -np.eye(nx)
        A[rows, uidx(t)] = Bm
        if t == 0:
            b[rows] = -F @ x0
        else:
            A[rows, xidx(t)] = F
    # LP rows: box bounds on ALL variables (keeps the problem bounded even
    # when the objective rewards large states)
    l = 2 * n
    G_lp = np.vstack([np.eye(n), -np.eye(n)])
    h_lp = np.full(l, 5.0)
    # SOC rows: per step, (u_max, u_t) in SOC(nu+1)  <=>  ||u_t|| <= u_max
    q = (nu + 1,) * T
    ms = T * (nu + 1)
    G_soc = np.zeros((ms, n))
    h_soc = np.zeros(ms)
    for t in range(T):
        r0 = t * (nu + 1)
        h_soc[r0] = u_max            # head: h - 0 = u_max
        G_soc[r0 + 1: r0 + nu + 1, uidx(t)] = -np.eye(nu)
    G = np.vstack([G_lp, G_soc])
    h = np.concatenate([h_lp, h_soc])
    m = G.shape[0]
    c = rng.standard_normal(n) * 0.1
    st = ProblemStructure.create(n, p, m, l, q)
    return st, make_problem(st, G, A, c, h, b)
