"""The powered-descent SOCP (Açıkmeşe and Ploen 2007, the Mars example;
``benchmark/families/pdg.py``) through the port on the CPU: the family's
G, A, b, c, h against the plain reference's equations
(``benchmark/reference/pdg.py``), and whole solves under "banded" on a
``keep_soc`` plan, the benchmark cell's path, held to the reference, to the
optimality conditions (``benchmark/reference/certificate.py``) at the
cell's limits, and to the port's "reduced" solve.

The banded kept-cone layout ended this problem at NUMERICS until the
layout was left unscaled, the plain leaf inverted by substitution and the
refinement's z block left unregularized (``kkt._soc_kept_vals``,
``ops/band_ldl._unit_lower_inv``, ``kkt._ecos_z``); the JAX package and the
port's dense strategies keep the fault, so "reduced" is a yardstick only
where it ends OPTIMAL.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)

import importlib.util
import json
import os

import numpy as np
import pytest

import eicos_tpu_torch as pt
from eicos_tpu_torch.plan import make_band_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SHARED = ("G", "A", "h")
LANES = 4


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        "pdg_test_" + rel.replace("/", "_")[:-3], os.path.join(BENCH, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


family = _load("families/pdg.py")
ref = _load("reference/pdg.py")
certificate = _load("reference/certificate.py")

with open(os.path.join(BENCH, "configs", "pdg_mars_n100.json")) as fh:
    CONFIG = json.load(fh)
with open(os.path.join(BENCH, "limits", "pdg.mc128.json")) as fh:
    LIMITS = json.load(fh)
with open(os.path.join(BENCH, "traffic", "pdg_mc128.json")) as fh:
    TRAFFIC = json.load(fh)


def config(N):
    return dict(CONFIG, horizon=N)


def problem(N, lanes=LANES, seed=2 ** 31 + 11):
    """The family at N steps and ``lanes`` lanes of it dispersed as the
    cell's traffic disperses them: r0 and v0 (b's first six entries) +=
    b_sigma N(0, 1)."""
    G, A, c, h, b, l, q = family.make(config(N), 0)
    rng = np.random.default_rng([seed, 1])
    B = np.broadcast_to(b, (lanes, b.size)).copy()
    B[:, :CONFIG["nx"]] += TRAFFIC["b_sigma"] * rng.standard_normal(
        (lanes, CONFIG["nx"]))
    C = np.broadcast_to(c, (lanes, c.size)).copy()
    return G, A, C, h, B, l, q


def solve(N, strategy, lanes=LANES):
    G, A, C, h, B, l, q = problem(N, lanes)
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0], l,
                                    q).with_gsplit(G, A)
    if strategy == "banded":
        st = st.with_band_plan(make_band_plan(st, G, A, keep_soc=True))
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy=strategy),
                          shared=SHARED, device="cpu")
    sol = bs.solve(pt.ProblemData(G=G, A=A, c=C, h=h, b=B))
    bs.close()
    return (G, A, C, h, B, l, q), sol


@pytest.fixture(scope="module")
def solves():
    """The banded and the reduced solves at N = 8 and N = 20, once."""
    return {(N, s): solve(N, s) for N in (8, 20)
            for s in ("banded", "reduced")}


def test_sizes_at_the_configuration():
    """The configuration's stated sizes are the family's at N = 100."""
    G, A, c, h, b, l, q = family.make(CONFIG, 0)
    assert (G.shape[1], A.shape[0], G.shape[0], l) == (
        CONFIG["n"], CONFIG["p"], CONFIG["m"], CONFIG["l"])
    assert q == (4,) * 101 + (3,) * 201 and sum(q) == 1007


def test_family_matches_the_reference_equations():
    """At N = 8 on seeded random trajectories: A x - b is the reference's
    boundary and dynamics residuals, G x - h on the LP rows its
    violations (where positive), each cone of h - G x holds exactly where
    the reference's constraint does, and c'x is its fuel."""
    N = 8
    G, A, c, h, b, l, q = family.make(config(N), 0)
    P = ref.constants(config(N))
    rng = np.random.default_rng(7)
    X = rng.standard_normal((64, N + 1, 11)) * 0.5
    X[:, :, 10] = np.abs(X[:, :, 10]) + 0.2       # sigma mostly positive
    x = X.reshape(64, -1)
    bnd, dyn = ref.residuals(P, X)
    want = np.concatenate([bnd, dyn.reshape(64, -1)], -1)
    np.testing.assert_allclose(x @ A.T - b, want, rtol=1e-12, atol=1e-12)
    viol = ref.violations(P, X)
    lp = np.maximum(x @ G[:l].T - h[:l], 0.0)
    got = dict(upper=lp[:, :N + 1], z_low=lp[:, N + 1:3 * N + 1:2],
               z_high=lp[:, N + 2:3 * N + 1:2], fuel_limit=lp[:, 3 * N + 1:])
    for name, v in got.items():
        np.testing.assert_allclose(v, viol[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    s = h - x @ G.T
    heads = l + np.concatenate([[0], np.cumsum(q)[:-1]]).astype(int)
    outside = np.array([[np.linalg.norm(si[o + 1:o + d]) > si[o]
                         for o, d in zip(heads, q)] for si in s])
    cones = N + 1
    for name, cols in (("thrust", slice(0, cones)),
                       ("lower", slice(cones, 2 * cones)),
                       ("glide", slice(2 * cones, 3 * cones - 1))):
        np.testing.assert_array_equal(outside[:, cols],
                                      viol[name] > 0, name)
    np.testing.assert_allclose(x @ c, ref.fuel(P, X), rtol=1e-13)


@pytest.mark.parametrize("N", [8, 20])
def test_banded_lanes_are_optimal_and_right(solves, N):
    """Four dispersed lanes under "banded" on a keep_soc plan end OPTIMAL
    within iter_max; their answers meet the optimality conditions at the
    cell's limits, the reference's equations and constraints to its pres
    limit, and the fuel is c'x to 1e-9.  The "reduced" solve of the same
    lanes, where it ends OPTIMAL, gives the fuel within 1e-7 relative;
    where it ends CLOSE_TO_OPTIMAL, within its reduced tolerance (5e-5)."""
    (G, A, C, h, B, l, q), sol = solves[(N, "banded")]
    _, red = solves[(N, "reduced")]
    assert sol.exit_code.tolist() == [0] * LANES
    assert int(sol.info.iter.max()) <= LIMITS["iter_max"]
    r = certificate.readings(G, A, C, h, B, l, q, sol.x.numpy(),
                             sol.y.numpy(), sol.z.numpy(), sol.s.numpy())
    for name in certificate.READINGS:
        assert r[name].max() <= LIMITS[name], name
    P = ref.constants(config(N))
    X = sol.x.numpy().reshape(LANES, N + 1, 11)
    res, vio = ref.worst(P, X, B[:, :3], B[:, 3:6])
    assert res.max() <= LIMITS["pres"] and vio.max() <= LIMITS["pres"]
    fuel = ref.fuel(P, X)
    np.testing.assert_allclose(fuel, (sol.x.numpy() * C).sum(-1),
                               rtol=1e-9)
    codes = red.exit_code.numpy()
    rel = np.abs(fuel - red.info.pcost.numpy()) / np.abs(fuel)
    assert np.all(rel[codes == 0] <= 1e-7)
    assert np.all(rel[codes == 10] <= 5e-5)


def test_one_lane_at_n20_no_longer_ends_at_numerics():
    """The fault this configuration found: one lane at N = 20 under
    "banded" on a keep_soc plan ended at NUMERICS (-2) at iteration 9-12;
    it ends OPTIMAL."""
    (G, A, C, h, B, l, q), sol = solve(20, "banded", lanes=1)
    assert int(sol.exit_code[0]) == 0
    r = certificate.readings(G, A, C, h, B, l, q, sol.x.numpy(),
                             sol.y.numpy(), sol.z.numpy(), sol.s.numpy())
    assert r["gap"].max() <= LIMITS["gap"]


@pytest.mark.parametrize("rotated", [False, True])
def test_refinement_ends_within_nitref(monkeypatch, rotated):
    """On the banded kept layout, refined against ECOS's unregularized z
    block (``kkt._ecos_z``) and factored in the cones' eigenbases, every
    column stops by its last trip, a NaN column too: the refinement loop
    takes at most ``nitref`` trips (the residual-first loop of the CPU,
    and the card's rotated loop on the operands), and the finite lane's
    directions stay finite."""
    import torch

    from eicos_tpu_torch import kkt
    from eicos_tpu_torch.equilibrate import equilibrate

    if rotated:
        monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    G, A, C, h, B, l, q = problem(8, lanes=2)
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0], l,
                                    q).with_gsplit(G, A)
    st = st.with_band_plan(make_band_plan(st, G, A, keep_soc=True))
    settings = pt.Settings(kkt_strategy="banded")
    t = torch.tensor
    eq = equilibrate(st, t(G), t(A), t(C), t(h)[None].expand(2, -1), t(B))
    ctx = kkt.make_context(st, eq.G, eq.A, settings)
    assert kkt._ecos_z(ctx)
    es = kkt.factor(st, ctx, None, settings, 2)
    rng = np.random.default_rng(3)
    rhs = t(rng.standard_normal((2, 2, st.n + st.p + st.m)))
    rhs[1, 0, 0] = float("nan")
    r = kkt.refine_start(st, ctx, es, None, rhs, settings)
    for _ in range(settings.nitref + 1):
        if bool(r.done.all()):
            break
        kkt.refine_trip(st, ctx, es, None, rhs, settings, r)
    assert bool(r.done.all())
    assert int(r.kout.max()) <= settings.nitref
    assert torch.isfinite(r.dx[0]).all()
