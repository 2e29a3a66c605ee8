"""The plain reference of the day-ahead distribution-feeder configuration:
the branch-flow (DistFlow) equations of Farivar and Low, "Branch Flow
Model: Relaxations and Convexification", IEEE Trans. Power Systems
28(3):2554-2572, 2013, on the radial feeder of the configuration (Baran
and Wu's 33-bus feeder), with batteries, written from the network in
plain PyTorch float64 on the CPU, not from the problem's G, A, h.  It
imports no part of the program.  Its functions take NumPy arrays or
tensors and return float64 (complex128 for the voltages) CPU tensors.

Everything is per unit on the configuration's base (12.66 kV, 1 MVA), an
hour a period.  An answer is a plan X (..., T, 143), its hour t laid out
as the family lays it (``benchmark/families/distflow.py``): P, Q, l of the
32 branches (sending-end power and squared current), v of the 33 buses
(squared voltage magnitude), the substation's import P0, Q0, and each of
the 4 batteries' charge c, discharge d and stored energy e at the hour's
end.  Loads are (..., T, 32) arrays of the buses 2..33, P and Q apart.

- ``load_flow``: a backward/forward-sweep AC load flow of the feeder at
  given bus loads (complex voltages, branch currents, losses);
- ``residuals``: the power balances at every bus, the voltage drop of
  every branch, v = 1 at the substation and the batteries' energy;
- ``violations``: the voltage band, the batteries' boxes and each
  branch's cone P^2 + Q^2 <= v_i l (the relaxation), 0 where they hold;
- ``exactness``: (P^2 + Q^2 - v_i l) / (v_i l) by branch and hour, 0 where
  the relaxation is exact (an AC power flow);
- ``load_flow_gap``: the answer's own v against the load flow run at the
  answer's injections (the loads less each battery's d - c), largest over
  the buses;
- ``cost``: the substation's energy cost, sum over t of price_t P0_t.

Tolerances (``TOL``), each with its reason and what set it: the largest
reading of the program's answers on an NVIDIA H100 (12,672 OPTIMAL lanes
of 9 seeds, every batch), the same answers rounded to float32, and a
float32 factor's answers ("reduced" at factor_dtype float32, 8 hours on
the CPU: it ends at NUMERICS):

- ``residual`` 1e-8: the equalities hold to the solver's feasibility,
  on entries of about 1 (H100 6.0e-10; rounded 2.6e-7 fails);
- ``violation`` 1e-7: every cone is tight at the optimum, so the primal
  residual moves an answer across a cone's boundary by about 2 |s| its
  size (H100 1.2e-8; rounded 1.3-1.5e-7 fails);
- ``exactness`` 1e-5: an interior-point answer sits a relative mu inside
  each cone (H100 3.3e-7, rounded 4.1e-7; the float32 factor 0.57 fails);
- ``load_flow`` 1e-9: on a radial feeder the exact relaxation is the AC
  power flow, so v is the load flow's |V|^2 to the cones' slack carried
  down at most 32 branches (H100 1.0e-10; rounded 3.2e-8 and the float32
  factor 1.5e-5 fail).
"""

from __future__ import annotations

import torch

F64 = torch.float64
NB = 32                 # branches (and load buses)
NBUS = 33
NBAT = 4
HOUR = 3 * NB + NBUS + 2 + 3 * NBAT      # 143 variables an hour
P, Q, L, V = 0, NB, 2 * NB, 3 * NB       # offsets in an hour
P0, Q0 = V + NBUS, V + NBUS + 1
C, D, E = P0 + 2, P0 + 2 + NBAT, P0 + 2 + 2 * NBAT

TOL = dict(residual=1e-8, violation=1e-7, exactness=1e-5, load_flow=1e-9)


def _t(a):
    return torch.as_tensor(a, dtype=F64)


def network(config):
    """The feeder in per unit: a dict of the branches' from and to buses
    (0-based, the substation bus 0), r and x (32,), the loads' P and Q at
    buses 2..33 (32,) at peak, the load profile and price (T,), the
    batteries' bus, power and energy limits, efficiency, start and end
    energy and energy bounds, and the squared voltage band."""
    zb = config["base_kv"] ** 2 / config["base_mva"]
    br = _t(config["branches"])
    ld = _t(config["loads_kw_kvar"])
    bat = config["batteries"]
    T = int(config["horizon"])
    mw = 1e3 * config["base_mva"]        # kW a per-unit power
    ecap = _t([b["e_kwh"] for b in bat]) / mw
    return dict(
        T=T, frm=br[:, 0].long() - 1, to=br[:, 1].long() - 1,
        r=br[:, 2] / zb, x=br[:, 3] / zb,
        load_bus=ld[:, 0].long() - 1, p=ld[:, 1] / mw, q=ld[:, 2] / mw,
        profile=_t(config["load_profile"][:T]),
        price=_t(config["price_per_kwh"][:T]),
        bat_bus=torch.tensor([b["bus"] for b in bat]) - 1,
        pmax=_t([b["p_kw"] for b in bat]) / mw,
        eta=float(config["battery_eta"]),
        e_start=config["battery_soc_start"] * ecap,
        e_end=config["battery_soc_end"] * ecap,
        e_min=config["battery_soc_min"] * ecap,
        e_max=config["battery_soc_max"] * ecap,
        vmin=config["v_min_pu"] ** 2, vmax=config["v_max_pu"] ** 2,
        v0=config["v0_pu"] ** 2)


def base_loads(N):
    """The hourly bus loads (T, 32) each, P and Q: peak times profile."""
    prof = N["profile"][:, None]
    return prof * N["p"], prof * N["q"]


def _parts(X):
    X = _t(X)
    return dict(P=X[..., P:P + NB], Q=X[..., Q:Q + NB], L=X[..., L:L + NB],
                v=X[..., V:V + NBUS], P0=X[..., P0], Q0=X[..., Q0],
                c=X[..., C:C + NBAT], d=X[..., D:D + NBAT],
                e=X[..., E:E + NBAT])


def _bus_sum(vals, index, like):
    """Sum (..., k) values onto the buses (..., 33) by ``index`` (k,)."""
    out = like.new_zeros(*like.shape[:-1], NBUS)
    for k, j in enumerate(index.tolist()):
        out[..., j] += vals[..., k]
    return out


def residuals(N, X, p_load, q_load):
    """The equalities' residuals of a plan, a dict of (..., T, count):
    ``p``, ``q`` the balances at the buses (the substation's first: P0 less
    what leaves it; at bus j: what arrives, less its branch's losses r l
    and x l, less what leaves, plus the battery's d - c, less the load),
    ``drop`` v_to - v_from + 2 (r P + x Q) - (r^2 + x^2) l by branch,
    ``v0`` v at the substation less 1, ``energy`` e_t - e_{t-1} - eta c_t
    + d_t / eta by battery (e_{-1} the start)."""
    A = _parts(X)
    frm, to = N["frm"], N["to"]
    pin = A["P"] - N["r"] * A["L"]
    qin = A["Q"] - N["x"] * A["L"]
    like = A["v"]
    net = A["d"] - A["c"]
    p_bal = (_bus_sum(pin, to, like) - _bus_sum(A["P"], frm, like)
             + _bus_sum(net, N["bat_bus"], like)
             - _bus_sum(_t(p_load), N["load_bus"], like))
    q_bal = (_bus_sum(qin, to, like) - _bus_sum(A["Q"], frm, like)
             - _bus_sum(_t(q_load), N["load_bus"], like))
    p_bal[..., 0] += A["P0"]
    q_bal[..., 0] += A["Q0"]
    v = A["v"]
    drop = (v[..., to] - v[..., frm] + 2 * (N["r"] * A["P"] + N["x"] * A["Q"])
            - (N["r"] ** 2 + N["x"] ** 2) * A["L"])
    e = A["e"]
    prev = torch.cat([N["e_start"].expand(*e.shape[:-2], 1, NBAT),
                      e[..., :-1, :]], -2)
    energy = e - prev - N["eta"] * A["c"] + A["d"] / N["eta"]
    return dict(p=p_bal, q=q_bal, drop=drop, v0=(v[..., :1] - N["v0"]),
                energy=energy)


def violations(N, X):
    """Each inequality's violation, a dict of (..., T, count), 0 where it
    holds: the voltage band at buses 2..33, the batteries' power and
    energy boxes (at the last hour the end energy is the lower bound), and
    each branch's cone P^2 + Q^2 <= v_from l with l >= 0, over v_from l
    + 1 (a relative step outside)."""
    A = _parts(X)

    def pos(t):
        return torch.clamp(t, min=0.0)

    v = A["v"][..., 1:]
    e = A["e"]
    lo = N["e_min"].expand(e.shape).clone()
    lo[..., -1, :] = N["e_end"]
    vl = A["v"][..., N["frm"]] * A["L"]
    return dict(
        v_low=pos(N["vmin"] - v), v_high=pos(v - N["vmax"]),
        charge=pos(A["c"] - N["pmax"]) + pos(-A["c"]),
        discharge=pos(A["d"] - N["pmax"]) + pos(-A["d"]),
        energy=pos(e - N["e_max"]) + pos(lo - e),
        cone=(pos(A["P"] ** 2 + A["Q"] ** 2 - vl) / (1.0 + vl.abs())
              + pos(-A["L"])))


def exactness(N, X):
    """(P^2 + Q^2 - v_from l) / (v_from l) by branch and hour, (..., T,
    32): 0 where the relaxation is exact, negative where the cone is
    slack."""
    A = _parts(X)
    vl = A["v"][..., N["frm"]] * A["L"]
    return (A["P"] ** 2 + A["Q"] ** 2 - vl) / vl


def load_flow(N, p_load, q_load, tol=1e-14, iters=200):
    """The AC load flow of the feeder at bus loads (..., 32) P and Q (in
    per unit; buses 2..33), the substation at |V| = sqrt(v0) and angle 0:
    backward/forward sweeps until the voltages move less than ``tol``.
    Returns (V (..., 33) complex, I (..., 32) branch currents, losses
    (...,) the sum of r |I|^2).  The branches are listed from the
    substation out (each branch's from bus is reached first)."""
    frm, to = N["frm"].tolist(), N["to"].tolist()
    z = torch.complex(N["r"], N["x"])
    p_load, q_load = _t(p_load), _t(q_load)
    s = torch.zeros(*p_load.shape[:-1], NBUS, dtype=torch.complex128)
    s[..., N["load_bus"]] = torch.complex(p_load, q_load)
    V = torch.full_like(s, N["v0"] ** 0.5)
    I = torch.zeros(*p_load.shape[:-1], NB, dtype=torch.complex128)
    for _ in range(iters):
        acc = (s / V).conj()                         # load currents
        for b in reversed(range(NB)):                # leaves first
            I[..., b] = acc[..., to[b]]
            acc[..., frm[b]] += I[..., b]
        Vn = V.clone()
        for b in range(NB):                          # the root first
            Vn[..., to[b]] = Vn[..., frm[b]] - z[b] * I[..., b]
        moved = float((Vn - V).abs().max())
        V = Vn
        if moved < tol:
            break
    losses = (N["r"] * I.abs() ** 2).sum(-1)
    return V, I, losses


def injections(N, X, p_load, q_load):
    """The bus loads (..., T, 32) P and Q that the answer's batteries
    leave: each battery's d - c taken off its bus's P load."""
    A = _parts(X)
    p = _t(p_load).clone()
    for k, j in enumerate((N["bat_bus"] - 1).tolist()):   # loads: 2..33
        p[..., j] -= A["d"][..., k] - A["c"][..., k]
    return p, _t(q_load)


def load_flow_gap(N, X, p_load, q_load):
    """The largest |v - |V|^2| over the buses, (..., T): the answer's own
    squared voltages against the load flow at its injections."""
    p, q = injections(N, X, p_load, q_load)
    V, _, _ = load_flow(N, p, q)
    return (_parts(X)["v"] - V.abs() ** 2).abs().amax(-1)


def cost(N, X):
    """The substation's energy cost, sum over t of price_t P0_t, (...)."""
    return (N["price"] * _parts(X)["P0"]).sum(-1)


def worst(N, X, p_load, q_load):
    """(largest residual, largest violation, largest exactness gap,
    largest load-flow gap) of each answer, (...)."""
    res = torch.stack([r.abs().amax((-2, -1)) for r in
                       residuals(N, X, p_load, q_load).values()], -1)
    vio = torch.stack([t.amax((-2, -1)) for t in
                       violations(N, X).values()], -1)
    return (res.amax(-1), vio.amax(-1), exactness(N, X).abs().amax((-2, -1)),
            load_flow_gap(N, X, p_load, q_load).amax(-1))
