"""Day-ahead multi-period optimal power flow on a radial distribution
feeder with batteries, as an SOCP: the branch-flow (DistFlow) relaxation of
AC power flow of Farivar and Low, "Branch Flow Model: Relaxations and
Convexification", IEEE Trans. Power Systems 28(3):2554-2572, 2013, on
Baran and Wu's 33-bus feeder (IEEE Trans. Power Delivery 4(2):1401-1407,
1989).  A configuration whose ``family`` is ``distflow`` is made here from
its ``horizon`` (T, the hours), its branches and loads, its load profile,
price, batteries and voltage band; ``seed`` is not read (the plant is
deterministic).

Per unit on ``base_kv`` and ``base_mva``, an hour a period.  Variables,
143 an hour t, in this order: P, Q, l of the 32 branches (sending-end
power, squared current), v of the 33 buses (squared voltage), the
substation's import P0, Q0, and the 4 batteries' charge c, discharge d
and stored energy e at the hour's end.

Equalities Ax = b, b opening with the loads so that a lane's dispersion
reaches exactly them: the P balances of buses 2..33 for every hour (what
arrives, less its losses r l, less what leaves, plus the battery's d - c,
equals the bus's P load), then the Q balances (x l the losses); then a
block an hour: the substation's balances (P0 and Q0 equal what leaves
it), each branch's voltage drop v_to = v_from - 2 (r P + x Q) + (r^2 +
x^2) l, v = v0 at the substation, and each battery's energy e_t = e_{t-1}
+ eta c_t - d_t / eta (e_{-1} the start, in b).

Inequalities Gx + s = h, s in R^l_+ x SOC(4) x ...: the LP rows first, an
hour each: the voltage band vmin^2 <= v <= vmax^2 at buses 2..33, 0 <= c,
d <= the battery's power and the energy box (at the last hour the end
energy is the lower bound); then one rotated cone a branch and hour,
||(2P, 2Q, l - v_from)|| <= l + v_from, i.e. P^2 + Q^2 <= v_from l.

The objective is the substation's energy cost, sum_t price_t P0_t.
"""

from __future__ import annotations

import numpy as np

NB, NBUS, NBAT = 32, 33, 4
HOUR = 3 * NB + NBUS + 2 + 3 * NBAT      # 143
P, Q, L, V = 0, NB, 2 * NB, 3 * NB
P0, Q0 = V + NBUS, V + NBUS + 1
C, D, E = P0 + 2, P0 + 2 + NBAT, P0 + 2 + 2 * NBAT


def plant(config):
    """The feeder in per unit: a dict of T, the branches' from and to
    buses (0-based), r and x, the buses' peak P and Q loads (33,), the
    profile and price (T,), the batteries' buses and limits."""
    zb = config["base_kv"] ** 2 / config["base_mva"]
    kw = 1e3 * config["base_mva"]
    br = np.asarray(config["branches"], float)
    pl, ql = np.zeros(NBUS), np.zeros(NBUS)
    for bus, p, q in config["loads_kw_kvar"]:
        pl[int(bus) - 1] += p / kw
        ql[int(bus) - 1] += q / kw
    bat = config["batteries"]
    cap = np.array([b["e_kwh"] for b in bat]) / kw
    T = int(config["horizon"])
    return dict(
        T=T, frm=br[:, 0].astype(int) - 1, to=br[:, 1].astype(int) - 1,
        r=br[:, 2] / zb, x=br[:, 3] / zb, pl=pl, ql=ql,
        profile=np.asarray(config["load_profile"][:T], float),
        price=np.asarray(config["price_per_kwh"][:T], float),
        bus=np.array([b["bus"] for b in bat]) - 1,
        pmax=np.array([b["p_kw"] for b in bat]) / kw,
        eta=float(config["battery_eta"]),
        e_start=config["battery_soc_start"] * cap,
        e_end=config["battery_soc_end"] * cap,
        e_min=config["battery_soc_min"] * cap,
        e_max=config["battery_soc_max"] * cap,
        vmin=config["v_min_pu"] ** 2, vmax=config["v_max_pu"] ** 2,
        v0=config["v0_pu"] ** 2)


def make(config, seed):
    """(G, A, c, h, b, l, q) as NumPy arrays; ``seed`` is not read."""
    del seed
    F = plant(config)
    T = F["T"]
    n = HOUR * T
    frm, to, r, x = F["frm"], F["to"], F["r"], F["x"]
    eta = F["eta"]

    def col(t, off):
        return HOUR * t + off

    arows, brows = [], []

    def eq(coefs, rhs):
        arows.append(coefs)
        brows.append(rhs)

    into = {int(to[i]): i for i in range(NB)}          # a bus's branch in
    out = [[i for i in range(NB) if frm[i] == j] for j in range(NBUS)]
    at = {int(j): k for k, j in enumerate(F["bus"])}   # a bus's battery
    for kind in ("p", "q"):            # the loads' rows: b opens with them
        for t in range(T):
            for j in range(1, NBUS):
                i = into[j]
                if kind == "p":
                    coefs = [(col(t, P + i), 1.0), (col(t, L + i), -r[i])]
                    coefs += [(col(t, P + k), -1.0) for k in out[j]]
                    if j in at:
                        coefs += [(col(t, D + at[j]), 1.0),
                                  (col(t, C + at[j]), -1.0)]
                    eq(coefs, F["profile"][t] * F["pl"][j])
                else:
                    coefs = [(col(t, Q + i), 1.0), (col(t, L + i), -x[i])]
                    coefs += [(col(t, Q + k), -1.0) for k in out[j]]
                    eq(coefs, F["profile"][t] * F["ql"][j])
    for t in range(T):
        eq([(col(t, P0), 1.0)] + [(col(t, P + k), -1.0) for k in out[0]],
           0.0)
        eq([(col(t, Q0), 1.0)] + [(col(t, Q + k), -1.0) for k in out[0]],
           0.0)
        for i in range(NB):
            eq([(col(t, V + to[i]), 1.0), (col(t, V + frm[i]), -1.0),
                (col(t, P + i), 2.0 * r[i]), (col(t, Q + i), 2.0 * x[i]),
                (col(t, L + i), -(r[i] ** 2 + x[i] ** 2))], 0.0)
        eq([(col(t, V), 1.0)], F["v0"])
        for k in range(NBAT):
            coefs = [(col(t, E + k), 1.0), (col(t, C + k), -eta),
                     (col(t, D + k), 1.0 / eta)]
            if t:
                coefs.append((col(t - 1, E + k), -1.0))
            eq(coefs, 0.0 if t else F["e_start"][k])

    grows, hrows = [], []

    def le(coefs, rhs):
        grows.append(coefs)
        hrows.append(rhs)

    for t in range(T):
        for j in range(1, NBUS):
            le([(col(t, V + j), 1.0)], F["vmax"])
            le([(col(t, V + j), -1.0)], -F["vmin"])
        for k in range(NBAT):
            for off in (C, D):
                le([(col(t, off + k), 1.0)], F["pmax"][k])
                le([(col(t, off + k), -1.0)], 0.0)
            le([(col(t, E + k), 1.0)], F["e_max"][k])
            low = F["e_end"][k] if t == T - 1 else F["e_min"][k]
            le([(col(t, E + k), -1.0)], -low)
    l = len(grows)
    q = []
    for t in range(T):                 # P^2 + Q^2 <= v_from l
        for i in range(NB):
            li, vi = col(t, L + i), col(t, V + frm[i])
            le([(li, -1.0), (vi, -1.0)], 0.0)
            le([(col(t, P + i), -2.0)], 0.0)
            le([(col(t, Q + i), -2.0)], 0.0)
            le([(li, -1.0), (vi, 1.0)], 0.0)
            q.append(4)

    def dense(rows):
        M = np.zeros((len(rows), n))
        for k, coefs in enumerate(rows):
            for j, v in coefs:
                M[k, j] += v
        return M

    c = np.zeros(n)
    c[[col(t, P0) for t in range(T)]] = F["price"]
    return (dense(grows), dense(arows), c, np.asarray(hrows, float),
            np.asarray(brows, float), l, tuple(q))
