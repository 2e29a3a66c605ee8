"""Day-ahead optimal power flow on Baran and Wu's 33-bus feeder with
batteries, the branch-flow SOCP of Farivar and Low
(``benchmark/families/distflow.py``), through the port on the CPU: the
configuration's table against the published base case, the family's G,
A, b, c, h against the plain reference's equations
(``benchmark/reference/distflow.py``), the sizes and the band plan, and at
8 hours (block bandwidth 2, as the day's 24) the direct scatter of the
kept cones against the gathered dense K and a whole banded solve held to
the optimality conditions (``benchmark/reference/certificate.py``) at the
cell's limits and to the reference.  At bandwidth 1 the scatter's targets
are the JAX package's, on the powered-descent and MPC structures."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import corpus as jcorpus
from eicos_tpu import kkt as jkkt
from eicos_tpu.plan import make_band_plan as jplan

import eicos_tpu_torch as pt
from eicos_tpu_torch import cones, kkt, problem
from eicos_tpu_torch.plan import make_band_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SHARED = ("G", "A", "h")
HOURS = 8
LANES = 2


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        "distflow_test_" + rel.replace("/", "_")[:-3],
        os.path.join(BENCH, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


family = _load("families/distflow.py")
ref = _load("reference/distflow.py")
certificate = _load("reference/certificate.py")

with open(os.path.join(BENCH, "configs", "distflow_33bus_24h.json")) as fh:
    CONFIG = json.load(fh)
with open(os.path.join(BENCH, "limits", "dist33.mc128.json")) as fh:
    LIMITS = json.load(fh)
with open(os.path.join(BENCH, "traffic", "dist_mc128.json")) as fh:
    TRAFFIC = json.load(fh)


def config(T):
    return dict(CONFIG, horizon=T)


def structure(G, A, l, q):
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0], l,
                                    q).with_gsplit(G, A)
    return st.with_band_plan(make_band_plan(st, G, A, keep_soc=True))


def problem_at(T, lanes=LANES, seed=2 ** 31 + 7):
    """The family at T hours and ``lanes`` lanes dispersed as the cell's
    traffic disperses them: every bus-hour's P and Q load (b's first
    64 T entries) += b_sigma N(0, 1)."""
    G, A, c, h, b, l, q = family.make(config(T), 0)
    rng = np.random.default_rng([seed, 1])
    B = np.broadcast_to(b, (lanes, b.size)).copy()
    B[:, :64 * T] += TRAFFIC["b_sigma"] * rng.standard_normal((lanes,
                                                               64 * T))
    C = np.broadcast_to(c, (lanes, c.size)).copy()
    return G, A, C, h, B, l, q


def loads(B, T):
    return (B[:, :32 * T].reshape(-1, T, 32),
            B[:, 32 * T:64 * T].reshape(-1, T, 32))


def test_the_table_gives_the_published_base_case():
    """The configuration's branches and loads through the reference's
    load flow at peak: Baran and Wu's 202.68 kW of losses and the lowest
    voltage, 0.9131 pu, at bus 18."""
    N = ref.network(CONFIG)
    V, _, losses = ref.load_flow(N, N["p"], N["q"])
    vm = V.abs()
    assert abs(1e3 * float(losses) - 202.68) <= 0.05
    assert abs(float(vm.min()) - 0.9131) <= 1e-4
    assert int(vm.argmin()) + 1 == 18


def test_family_matches_the_reference_equations():
    """At 4 hours on seeded random plans: A x - b is the reference's
    balances, voltage drops, substation voltage and battery energy in the
    family's row order, G x - h on the LP rows its violations (where
    positive), each cone of h - G x holds exactly where the reference's
    cone does, and c'x is the energy cost."""
    T, k = 4, 64
    G, A, c, h, b, l, q = family.make(config(T), 0)
    N = ref.network(config(T))
    rng = np.random.default_rng(7)
    X = rng.standard_normal((k, T, ref.HOUR)) * 0.3
    X[..., ref.V:ref.V + ref.NBUS] = 0.8 + 0.3 * rng.random(
        (k, T, ref.NBUS))
    x = X.reshape(k, -1)
    pl, ql = ref.base_loads(N)
    r = {k: v.numpy() for k, v in ref.residuals(N, X, pl, ql).items()}
    tail = np.concatenate([r["p"][..., :1], r["q"][..., :1], r["drop"],
                           r["v0"], r["energy"]], -1)
    want = np.concatenate([r["p"][..., 1:].reshape(k, -1),
                           r["q"][..., 1:].reshape(k, -1),
                           tail.reshape(k, -1)], -1)
    np.testing.assert_allclose(x @ A.T - b, want, rtol=1e-12, atol=1e-12)
    viol = {k: v.numpy() for k, v in ref.violations(N, X).items()}
    lp = np.maximum(x @ G[:l].T - h[:l], 0.0).reshape(k, T, -1)
    volt, bat = lp[..., :64], lp[..., 64:].reshape(k, T, 4, 6)
    got = dict(v_high=volt[..., 0::2], v_low=volt[..., 1::2],
               charge=bat[..., 0] + bat[..., 1],
               discharge=bat[..., 2] + bat[..., 3],
               energy=bat[..., 4] + bat[..., 5])
    for name, v in got.items():
        np.testing.assert_allclose(v, viol[name], rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    s = (h - x @ G.T)[:, l:].reshape(k, T, 32, 4)
    outside = np.linalg.norm(s[..., 1:], axis=-1) > s[..., 0]
    np.testing.assert_array_equal(outside, viol["cone"] > 0)
    np.testing.assert_allclose(x @ c, ref.cost(N, X).numpy(), rtol=1e-13)


@pytest.mark.parametrize("T,Dp,bwb", [(24, 9088, 2), (HOURS, 3072, 2)])
def test_sizes_and_plan(T, Dp, bwb):
    """The configuration's stated sizes are the family's at 24 hours; the
    keep_soc plan is of block bandwidth 2 at 24 hours and at 8, on the
    direct scatter."""
    G, A, c, h, b, l, q = family.make(config(T), 0)
    if T == 24:
        assert (G.shape[1], A.shape[0], G.shape[0], l) == (
            CONFIG["n"], CONFIG["p"], CONFIG["m"], CONFIG["l"])
        assert q == (4,) * 768 and b.size - CONFIG["nx"] == 936
    st = structure(G, A, l, q)
    assert (st.band.dim, st.band.dim // st.band.block, st.band.bwb) == (
        Dp, Dp // 128, bwb)
    assert kkt._direct_band(st, pt.Settings(kkt_strategy="banded"))


def _interior(rng, cone, lanes):
    """Strictly interior points of the cone, (lanes, m)."""
    x = rng.random((lanes, cone.m)) + 0.5
    for c, off in enumerate(cone.head_offsets):
        a = cone.l + int(off)
        d = cone.q[c]
        x[:, a + 1:a + d] = 0.3 * rng.standard_normal((lanes, d - 1))
        x[:, a] = np.linalg.norm(x[:, a + 1:a + d], axis=1) + 0.2
    return x


def test_direct_scatter_equals_the_gathered_dense_k(monkeypatch):
    """At 8 hours (bwb 2) on 2 lanes: the direct scatter's factor (the
    kept rows in each cone's eigenbasis, no dense K or H) and the gathered
    blocks of the dense K give the same refined directions within 1e-10
    relative, at the identity scaling and at an interior one.  Unrefined
    they agree at the identity only: at the interior scaling the unscaled
    kept block loses digits to W^2's spread (0.6 % of dx on this seed),
    which the eigenbasis keeps (``kkt._soc_kept_vals``); refinement
    against the same operator takes both to it."""
    G, A, C, h, B, l, q = problem_at(HOURS)
    st = structure(G, A, l, q)
    settings = pt.Settings(kkt_strategy="banded")
    t = torch.tensor
    Gt, At = t(G), t(A)
    direct = kkt.make_context(st, Gt, At, settings)
    assert direct.band.scatter is not None
    assert direct.K0 is None and direct.dense is None
    monkeypatch.setattr(kkt, "_direct_band", lambda st, settings: False)
    gathered = kkt.make_context(st, Gt, At, settings)
    assert gathered.band.scatter is None and gathered.K0 is not None
    rng = np.random.default_rng(3)
    s, z = (t(_interior(rng, st.cone, LANES)) for _ in range(2))
    scal, _ = cones.update_scalings(st.cone, s, z)
    n, p, m = st.n, st.p, st.m
    rhs = t(rng.standard_normal((LANES, 2, n + p + m)))
    for sc in (None, scal):
        got, want = (kkt.solve_refined(
            st, ctx, kkt.factor(st, ctx, sc, settings, LANES), sc, rhs,
            settings) for ctx in (direct, gathered))
        for f in ("dx", "dy", "dz"):
            g, w = getattr(got, f), getattr(want, f)
            err = float((g - w).abs().max() / w.abs().max())
            assert err < 1e-10, (f, err)


@pytest.fixture(scope="module")
def solved():
    """The cell's path at 8 hours on 2 lanes: a kept ``BatchedSolver`` of
    the keep_soc band plan with the "reduced" rescue, traced, once; the
    dense K and H assembly patched to raise."""
    G, A, C, h, B, l, q = problem_at(HOURS)
    st = structure(G, A, l, q)
    mp = pytest.MonkeyPatch()

    def never(*args, **kw):
        raise AssertionError("a dense K or H on the banded path")

    mp.setattr(kkt, "dense_matrix", never)
    mp.setattr(kkt, "_assemble_h", never)
    try:
        bs = pt.BatchedSolver(st, pt.Settings(**CONFIG["settings"]),
                              shared=SHARED,
                              rescue=pt.Settings(**CONFIG["rescue"]),
                              device="cpu")
        sol = bs.solve(pt.ProblemData(G=G, A=A, c=C, h=h, b=B))
        probes = bs._programs[0].probes
        rescued = list(bs.last_rescued)
        bs.close()
    finally:
        mp.undo()
    return (G, A, C, h, B, l, q), sol, probes, rescued


def test_banded_lanes_are_optimal_and_right(solved):
    """Both lanes end OPTIMAL on the banded path, the rescue idle; the
    answers meet the optimality conditions at the cell's limits and the
    reference's residual, violation, exactness and load-flow tolerances;
    the cost is c'x; the traced program recorded its band's shape."""
    (G, A, C, h, B, l, q), sol, probes, rescued = solved
    assert sol.exit_code.tolist() == [0] * LANES and rescued == []
    assert int(sol.info.iter.max()) <= LIMITS["iter_max"]
    x = sol.x.numpy()
    r = certificate.readings(G, A, C, h, B, l, q, x, sol.y.numpy(),
                             sol.z.numpy(), sol.s.numpy())
    for name in certificate.READINGS:
        assert float(r[name].max()) <= LIMITS[name], name
    N = ref.network(config(HOURS))
    X = x.reshape(LANES, HOURS, ref.HOUR)
    res, vio, exact, flow = ref.worst(N, X, *loads(B, HOURS))
    assert res.max() <= ref.TOL["residual"]
    assert vio.max() <= ref.TOL["violation"]
    assert exact.max() <= ref.TOL["exactness"]
    assert flow.max() <= ref.TOL["load_flow"]
    np.testing.assert_allclose(ref.cost(N, X).numpy(),
                               sol.info.pcost.numpy(), rtol=1e-12)
    if probes is not None:
        assert probes.band_shape == (HOURS * 3, 2)
        assert probes.sweep_ring == {}    # the plain sweeps take no ring


@pytest.mark.parametrize("kind", ["pdg", "mpc_lp"])
def test_bw1_scatter_targets_are_the_references(kind):
    """At block bandwidth 1 the scatter's targets, and so its buffer,
    equal the JAX package's (the maps the parent port took): the
    powered-descent structure's kept layout at N = 8 and the MPC LP's."""
    if kind == "pdg":
        pdg = _load("families/pdg.py")
        with open(os.path.join(BENCH, "configs", "pdg_mars_n100.json")) as fh:
            G, A, c, h, b, l, q = pdg.make(dict(json.load(fh), horizon=8), 0)
        jst = jt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0],
                                         l, q).with_gsplit(G, A)
        jst = jst.with_band_plan(jplan(jst, G, A, keep_soc=True))
    else:
        jst, d = jcorpus.make_mpc_like(horizon=20, nx=2, nu=4, seed=3)
        G, A, c, h, b = (np.asarray(getattr(d, f)) for f in "GAchb")
        jst = jst.with_gsplit(d.G, d.A)
        jst = jst.with_band_plan(jplan(jst, d.G, d.A))
    st, _ = problem.from_reference(problem.structure_fields(jst), G, A, c,
                                   h, b)
    assert st.band.bwb == 1
    keep = st.q if kind == "pdg" else ()
    sp = jst.gsplit
    want = jkkt._band_scatter_idx(
        jst.n, jst.p, jst.band.dim, tuple(jst.band.perm), sp.sing_cols,
        sp.spr_cols, sp.spr_width,
        jst.socsplit.cols if jst.n_sc else (),
        jst.socsplit.width if jst.n_sc else 0, keep)
    got = kkt._band_scatter_idx(
        st.n, st.band.dim, np.asarray(st.band.perm, np.int64), st.gsplit,
        st.socsplit, keep, st.band.bwb)
    np.testing.assert_array_equal(got, np.asarray(want))
