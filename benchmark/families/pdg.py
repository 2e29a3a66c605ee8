"""Fuel-optimal powered-descent guidance as an SOCP: the relaxed
(lossless-convexified) minimum-fuel problem of Açıkmeşe and Ploen, "Convex
Programming Approach to Powered Descent Guidance for Mars Landing", J.
Guidance, Control, and Dynamics 30(5):1353-1366, 2007, with its Mars
example, discretised at N + 1 nodes.  A configuration whose ``family`` is
``pdg`` is made here from its ``horizon`` (N, the steps), ``tf_s`` and the
lander's numbers; ``seed`` is not read (the plant is deterministic).

Units: lengths in km, time in 10 s, mass in the wet mass, so that
velocities are in 100 m/s and accelerations in 10 m/s^2.  Axis 0 is up.

Variables, 11 a node k = 0..N: r (3), v (3), z = ln(m / m_wet), u =
thrust / m (3), sigma (the slack of ||u||).  Equalities, in this order so
that b starts with the initial state: r_0 = r0, v_0 = v0, z_0 = 0, r_N = 0,
v_N = 0, then the dynamics a step (exact for u and sigma linear over it):

    r+ = r + v dt + dt^2 (u/3 + u+/6) + g dt^2/2
    v+ = v + dt (u + u+)/2 + g dt
    z+ = z - alpha dt (sigma + sigma+)/2

Inequalities Gx + s = h, s in R^l_+ x SOC x ...: the LP rows first, the
upper thrust bound sigma_k <= mu2_k (1 - (z_k - z0_k)) at every node, the
mass bounds z0_k <= z_k <= ln(1 - alpha rho1 t_k) at k >= 1 (at k = 0 they
meet and the equality fixes z_0), the fuel limit z_N >= ln(m_dry/m_wet);
then the cones: ||u_k|| <= sigma_k (SOC(4)) at every node, the
second-order Taylor lower thrust bound mu1_k (1 - w + w^2/2) <= sigma_k, w =
z_k - z0_k, as ||(2w, y - 1)|| <= y + 1 with y = 2 (sigma_k - mu1_k +
mu1_k w) / mu1_k (SOC(3)) at every node, and the glide slope
||(r_k1, r_k2)|| <= r_k0 / tan(gamma) (SOC(3)) at k < N.  Here z0_k =
ln(1 - alpha rho2 t_k) and mu_k = rho / exp(z0_k), rho per wet mass.

The objective is the fuel, the trapezoid sum of sigma_k dt.
"""

from __future__ import annotations

import math

import numpy as np

NV = 11                          # variables a node
R, V, Z, U, S = 0, 3, 6, 7, 10   # their offsets in a node
G0 = 9.80665                     # standard gravity, m/s^2, for Isp


def plant(config):
    """The lander's numbers in the family's units: a dict of dt, g (3,),
    alpha, rho1, rho2, the glide slope's cot, ln(m_dry/m_wet), r0, v0 and
    the node times t (N + 1,)."""
    L, T = 1e3, 10.0                 # km, 10 s
    acc = L / T ** 2                 # 10 m/s^2
    m_wet = config["m_wet_kg"]
    thrust = (config["engines"] * config["engine_thrust_n"]
              * math.cos(math.radians(config["cant_deg"])))
    alpha = 1.0 / (config["isp_s"] * G0)          # s/m
    N = int(config["horizon"])
    tf = config["tf_s"] / T
    return dict(
        N=N, dt=tf / N, t=np.arange(N + 1) * tf / N,
        g=np.asarray(config["g_mps2"], float) / acc,
        alpha=alpha * acc * T,
        rho1=config["rho1_share"] * thrust / m_wet / acc,
        rho2=config["rho2_share"] * thrust / m_wet / acc,
        cot=1.0 / math.tan(math.radians(config["glide_slope_deg"])),
        zdry=math.log(config["m_dry_kg"] / m_wet),
        r0=np.asarray(config["r0_m"], float) / L,
        v0=np.asarray(config["v0_mps"], float) / (L / T))


def make(config, seed):
    """(G, A, c, h, b, l, q) as NumPy arrays; ``seed`` is not read."""
    del seed
    P = plant(config)
    N, dt, g, al = P["N"], P["dt"], P["g"], P["alpha"]
    n = NV * (N + 1)

    def col(k, off):
        return NV * k + off

    z0 = np.log(1.0 - al * P["rho2"] * P["t"])
    zmax = np.log(1.0 - al * P["rho1"] * P["t"])
    mu1 = P["rho1"] * np.exp(-z0)
    mu2 = P["rho2"] * np.exp(-z0)

    # equalities: the boundary conditions, then the dynamics
    arows, brows = [], []

    def eq(coefs, rhs):
        row = np.zeros(n)
        for j, v in coefs:
            row[j] += v
        arows.append(row)
        brows.append(rhs)

    for i in range(3):
        eq([(col(0, R + i), 1.0)], P["r0"][i])
    for i in range(3):
        eq([(col(0, V + i), 1.0)], P["v0"][i])
    eq([(col(0, Z), 1.0)], 0.0)
    for i in range(3):
        eq([(col(N, R + i), 1.0)], 0.0)
    for i in range(3):
        eq([(col(N, V + i), 1.0)], 0.0)
    for k in range(N):
        for i in range(3):
            eq([(col(k + 1, R + i), 1.0), (col(k, R + i), -1.0),
                (col(k, V + i), -dt), (col(k, U + i), -dt * dt / 3.0),
                (col(k + 1, U + i), -dt * dt / 6.0)], g[i] * dt * dt / 2.0)
        for i in range(3):
            eq([(col(k + 1, V + i), 1.0), (col(k, V + i), -1.0),
                (col(k, U + i), -dt / 2.0), (col(k + 1, U + i), -dt / 2.0)],
               g[i] * dt)
        eq([(col(k + 1, Z), 1.0), (col(k, Z), -1.0),
            (col(k, S), al * dt / 2.0), (col(k + 1, S), al * dt / 2.0)], 0.0)

    # inequalities Gx <= h, the LP rows first, then the cones by kind
    grows, hrows = [], []

    def le(coefs, rhs):
        row = np.zeros(n)
        for j, v in coefs:
            row[j] += v
        grows.append(row)
        hrows.append(rhs)

    for k in range(N + 1):              # sigma <= mu2 (1 - (z - z0))
        le([(col(k, S), 1.0), (col(k, Z), mu2[k])], mu2[k] * (1.0 + z0[k]))
    for k in range(1, N + 1):           # z0 <= z <= zmax
        le([(col(k, Z), -1.0)], -z0[k])
        le([(col(k, Z), 1.0)], zmax[k])
    le([(col(N, Z), -1.0)], -P["zdry"])  # the fuel limit
    l = len(grows)
    q = []
    for k in range(N + 1):              # ||u|| <= sigma
        le([(col(k, S), -1.0)], 0.0)
        for i in range(3):
            le([(col(k, U + i), -1.0)], 0.0)
        q.append(4)
    for k in range(N + 1):              # the lower thrust bound
        a = 2.0 / mu1[k]
        le([(col(k, S), -a), (col(k, Z), -2.0)], -2.0 * z0[k] - 1.0)
        le([(col(k, Z), -2.0)], -2.0 * z0[k])
        le([(col(k, S), -a), (col(k, Z), -2.0)], -2.0 * z0[k] - 3.0)
        q.append(3)
    for k in range(N):                  # the glide slope
        le([(col(k, R), -P["cot"])], 0.0)
        le([(col(k, R + 1), -1.0)], 0.0)
        le([(col(k, R + 2), -1.0)], 0.0)
        q.append(3)

    c = np.zeros(n)
    for k in range(N + 1):
        c[col(k, S)] = dt * (0.5 if k in (0, N) else 1.0)
    return (np.asarray(grows), np.asarray(arows), c, np.asarray(hrows),
            np.asarray(brows), l, tuple(q))
