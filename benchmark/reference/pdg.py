"""The plain reference of the powered-descent configuration: the equations
of Açıkmeşe and Ploen (2007), Problem 4 with the Mars example, written
from the trajectory (r, v, z, u, sigma) in float64 NumPy, not from the
problem's G, A, h.  It imports no part of the program.

A trajectory is X (..., N + 1, 11), its node k = [r (3), v (3), z, u (3),
sigma], in the units of the configuration's family: km, 10 s, and the wet
mass (so velocities in 100 m/s, accelerations in 10 m/s^2; axis 0 up).

- ``residuals``: the boundary conditions r_0 = r0, v_0 = v0, z_0 = 0,
  r_N = 0, v_N = 0 and the dynamics of each step, exact for u and sigma
  linear over it (r+ = r + v dt + dt^2 (u/3 + u+/6) + g dt^2/2, v+ = v +
  dt (u + u+)/2 + g dt, z+ = z - alpha dt (sigma + sigma+)/2);
- ``violations``: how far each constraint is broken (0 where it holds):
  ||u|| <= sigma, mu1 (1 - w + w^2/2) <= sigma and sigma <= mu2 (1 - w)
  with w = z - z0 (at every node), z0 <= z <= ln(1 - alpha rho1 t) (from
  node 1 on), z_N >= ln(m_dry / m_wet), and the glide slope
  ||(r_1, r_2)|| tan(gamma) <= r_0 (before node N);
- ``fuel``: the trapezoid sum of sigma dt.
"""

from __future__ import annotations

import numpy as np

G0 = 9.80665          # standard gravity, m/s^2, in alpha = 1 / (Isp g0)


def constants(config):
    """The lander's numbers in the family's units, from the configuration's
    physical ones."""
    km, ts = 1e3, 10.0
    acc = km / ts ** 2
    thrust = (config["engines"] * config["engine_thrust_n"]
              * np.cos(np.radians(config["cant_deg"])))
    N = int(config["horizon"])
    tf = config["tf_s"] / ts
    t = np.arange(N + 1) * (tf / N)
    alpha = acc * ts / (config["isp_s"] * G0)
    rho1 = config["rho1_share"] * thrust / config["m_wet_kg"] / acc
    rho2 = config["rho2_share"] * thrust / config["m_wet_kg"] / acc
    z0 = np.log(1.0 - alpha * rho2 * t)
    return dict(
        N=N, dt=tf / N, t=t, alpha=alpha, z0=z0,
        zmax=np.log(1.0 - alpha * rho1 * t),
        mu1=rho1 * np.exp(-z0), mu2=rho2 * np.exp(-z0),
        g=np.asarray(config["g_mps2"], np.float64) / acc,
        tan_gs=np.tan(np.radians(config["glide_slope_deg"])),
        zdry=np.log(config["m_dry_kg"] / config["m_wet_kg"]),
        r0=np.asarray(config["r0_m"], np.float64) / km,
        v0=np.asarray(config["v0_mps"], np.float64) / (km / ts))


def _parts(X):
    X = np.asarray(X, np.float64)
    return X[..., 0:3], X[..., 3:6], X[..., 6], X[..., 7:10], X[..., 10]


def residuals(P, X, r0=None, v0=None):
    """(boundary (..., 13), dynamics (..., N, 7)): r0, v0 default to the
    configuration's; a dispersed lane passes its own."""
    r, v, z, u, s = _parts(X)
    r0 = P["r0"] if r0 is None else r0
    v0 = P["v0"] if v0 is None else v0
    dt, g, al = P["dt"], P["g"], P["alpha"]
    bnd = np.concatenate([r[..., 0, :] - r0, v[..., 0, :] - v0,
                          z[..., 0:1], r[..., -1, :], v[..., -1, :]], -1)
    ua, ub = u[..., :-1, :], u[..., 1:, :]
    dr = (r[..., 1:, :] - r[..., :-1, :] - v[..., :-1, :] * dt
          - dt * dt * (ua / 3.0 + ub / 6.0) - g * (dt * dt / 2.0))
    dv = v[..., 1:, :] - v[..., :-1, :] - dt * (ua + ub) / 2.0 - g * dt
    dz = (z[..., 1:] - z[..., :-1]
          + al * dt * (s[..., :-1] + s[..., 1:]) / 2.0)
    return bnd, np.concatenate([dr, dv, dz[..., None]], -1)


def violations(P, X):
    """Each constraint's violation, a dict of (..., count) arrays, 0 where
    it holds."""
    r, v, z, u, s = _parts(X)
    w = z - P["z0"]

    def pos(a):
        return np.maximum(a, 0.0)

    return dict(
        thrust=pos(np.linalg.norm(u, axis=-1) - s),
        lower=pos(P["mu1"] * (1.0 - w + w * w / 2.0) - s),
        upper=pos(s - P["mu2"] * (1.0 - w)),
        z_low=pos(P["z0"][1:] - z[..., 1:]),
        z_high=pos(z[..., 1:] - P["zmax"][1:]),
        fuel_limit=pos(P["zdry"] - z[..., -1:]),
        glide=pos(np.linalg.norm(r[..., :-1, 1:], axis=-1) * P["tan_gs"]
                  - r[..., :-1, 0]))


def fuel(P, X):
    """The trapezoid sum of sigma dt, (...)."""
    s = np.asarray(X, np.float64)[..., 10]
    return P["dt"] * (s.sum(-1) - 0.5 * (s[..., 0] + s[..., -1]))


def worst(P, X, r0=None, v0=None):
    """(largest residual, largest violation) of each trajectory, (...)."""
    bnd, dyn = residuals(P, X, r0, v0)
    res = np.maximum(np.abs(bnd).max(-1), np.abs(dyn).max((-2, -1)))
    vio = np.stack([t.max(-1) for t in violations(P, X).values()],
                   -1).max(-1)
    return res, vio
