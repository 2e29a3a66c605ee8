"""The MPC01-family LP, frozen (copied from
eicos_tpu_torch/corpus.py:194-253, ``make_mpc_like``): a configuration
whose ``family`` is ``mpc_like`` is made here from its ``horizon``,
``nx`` and ``nu``.

Variables: states x_1..x_T (nx each) and inputs u_0..u_{T-1} (nu each),
n = T (nx + nu).  Equalities: the dynamics x_{t+1} = F x_t + B u_t, with
F scaled to spectral radius 0.95 (p = T nx).  Inequalities: the box
|v| <= 5 on every variable and two-sided input rate bounds
|u_t - u_{t-1}| <= 1, so m = l = 2n + 2 (T - 1) nu.
"""

from __future__ import annotations

import numpy as np


def make(config, seed, rate_bound=1.0):
    """(G, A, c, h, b, l, q) as NumPy arrays of the plant ``seed``;
    q = ()."""
    T, nx, nu = config["horizon"], config["nx"], config["nu"]
    rng = np.random.default_rng(seed)
    n = T * (nx + nu)
    F = rng.standard_normal((nx, nx))
    F *= 0.95 / max(1e-9, np.max(np.abs(np.linalg.eigvals(F))))
    Bm = rng.standard_normal((nx, nu))
    x0 = rng.standard_normal(nx)
    p = T * nx
    A = np.zeros((p, n))
    b = np.zeros(p)
    for t in range(T):
        rows = slice(t * nx, (t + 1) * nx)
        A[rows, t * nx:(t + 1) * nx] = -np.eye(nx)
        A[rows, T * nx + t * nu:T * nx + (t + 1) * nu] = Bm
        if t == 0:
            b[rows] = -F @ x0
        else:
            A[rows, (t - 1) * nx:t * nx] = F
    n_rate = (T - 1) * nu
    R = np.zeros((n_rate, n))
    for t in range(1, T):
        rows = slice((t - 1) * nu, t * nu)
        R[rows, T * nx + t * nu:T * nx + (t + 1) * nu] = np.eye(nu)
        R[rows, T * nx + (t - 1) * nu:T * nx + t * nu] = -np.eye(nu)
    G = np.vstack([np.eye(n), -np.eye(n), R, -R])
    h = np.concatenate([np.full(2 * n, 5.0), np.full(2 * n_rate, rate_bound)])
    c = rng.standard_normal(n) * 0.1
    return G, A, c, h, b, G.shape[0], ()
