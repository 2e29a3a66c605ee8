"""The port's dense "reduced" KKT strategy and the rescue pass on the CPU
(plain versions of the kernels) against the JAX package on the CPU.

Tolerances: one refined solve, dx, dy, dz within 1e-10 relative to their
size (the two packages differ in summation order only, and refinement
stops at 1e-14 residuals); whole solves lane by lane, equal exit codes and
iteration counts and the objective within 1e-8 relative (the exit
tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import cones as jcones
from eicos_tpu import corpus as jcorpus
from eicos_tpu import kkt as jkkt
from eicos_tpu.api import BatchedSolver as JBatched
from eicos_tpu.equilibrate import equilibrate as jequil
from eicos_tpu.plan import make_band_plan as jplan
from eicos_tpu.settings import Settings as JSettings

import eicos_tpu_torch as pt
from eicos_tpu_torch import api, cones, kkt, problem
from eicos_tpu_torch.equilibrate import equilibrate
from eicos_tpu_torch.settings import Settings

SHARED = ("G", "A", "h")
REDUCED = dict(kkt_strategy="reduced")


def make_case(kind):
    """(JAX structure, data) of the small problems: the MPC LP (with its
    gsplit, without one, or with an extra dense LP row) and the MPC SOCP
    with kept SOC rows."""
    if kind == "soc":
        jst, d = jcorpus.make_mpc_soc(horizon=6, nx=2, nu=2, seed=5)
    else:
        jst, d = jcorpus.make_mpc_like(horizon=10, nx=2, nu=4, seed=3)
    if kind == "dense_row":
        # one LP row over 6 columns: the gsplit's dense-row GEMM
        G = np.vstack([np.asarray(d.G), np.zeros((1, jst.n))])
        G[-1, :6] = 0.3
        h = np.concatenate([np.asarray(d.h), [50.0]])
        d = jt.ProblemData(G=G, A=d.A, c=d.c, h=h, b=d.b)
        jst = jt.ProblemStructure.create(jst.n, jst.p, jst.m + 1, jst.l + 1,
                                         jst.q)
    if kind != "nosplit":
        jst = jst.with_gsplit(d.G, d.A)
    return jst, d


@pytest.mark.parametrize("kind", ["lp", "nosplit", "dense_row", "soc"])
@pytest.mark.parametrize("scaled", [False, True])
def test_reduced_refined_solve_matches(kind, scaled):
    """One ``solve_refined`` with the reduced factor at the identity or an
    interior NT scaling."""
    jst, d = make_case(kind)
    if kind == "dense_row":
        assert jst.gsplit.dense_rows
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    jset, pset = JSettings(**REDUCED), Settings(**REDUCED)
    jeq = jequil(jst, *[jnp.asarray(getattr(d, f)) for f in "GAchb"])
    t = torch.tensor
    peq = equilibrate(st, t(pd.G), t(pd.A), t(pd.c)[None], t(pd.h)[None],
                      t(pd.b)[None])
    jctx = jkkt.make_context(jst, jeq.G, jeq.A, jset)
    pctx = kkt.make_context(st, peq.G, peq.A, pset)
    jscal = pscal = None
    if scaled:
        rng = np.random.default_rng(5)
        s = rng.random(st.m) + 0.5
        z = rng.random(st.m) + 0.5
        if st.n_sc:      # heads large enough to lie inside every cone
            heads = st.l + np.asarray(st.cone.head_offsets)
            s[heads] += 3.0
            z[heads] += 3.0
        jscal, _ = jcones.update_scalings(jst.cone, jnp.asarray(s),
                                          jnp.asarray(z))
        pscal, _ = cones.update_scalings(st.cone, t(s)[None], t(z)[None])
    n, p, m = st.n, st.p, st.m
    rng = np.random.default_rng(6)
    rhs = np.stack([
        np.concatenate([np.zeros(n), np.asarray(jeq.b), np.asarray(jeq.h)]),
        rng.standard_normal(n + p + m)])
    js = jkkt.factor(jst, jctx, jscal, jset)
    ref = jkkt.solve_refined(jst, jctx, js, jscal, jnp.asarray(rhs), jset)
    ps = kkt.factor(st, pctx, pscal, pset, 1)
    got = kkt.solve_refined(st, pctx, ps, pscal, t(rhs)[None], pset)
    for f in ("dx", "dy", "dz"):
        a, b = getattr(got, f)[0].numpy(), np.asarray(getattr(ref, f))
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-10, f


def lanes_of(base, n, seed, count=2):
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(count):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(n)
        b = np.asarray(base.b).copy()
        b[:2] += 0.05 * rng.standard_normal(2)
        probs.append(dict(G=np.asarray(base.G), A=np.asarray(base.A), c=c,
                          h=np.asarray(base.h), b=b))
    return probs


def both_batches(jst, base, probs):
    jbatch = JBatched.stack([jt.ProblemData(**p) for p in probs],
                            shared=SHARED)
    st, _ = problem.from_reference(problem.structure_fields(jst), base.G,
                                   base.A, base.c, base.h, base.b)
    pbatch = pt.BatchedSolver.stack([problem.ProblemData(**p)
                                     for p in probs], shared=SHARED)
    return jbatch, st, pbatch


def assert_lanes_match(sol, ref):
    np.testing.assert_array_equal(sol.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    want = np.asarray(ref.info.pcost)
    assert np.all(np.abs(sol.info.pcost.numpy() - want)
                  <= 1e-8 * np.abs(want))


@pytest.mark.parametrize("kind", ["lp", "soc"])
def test_batched_reduced_matches(kind):
    jst, base = make_case(kind)
    probs = lanes_of(base, jst.n, seed=7)
    jbatch, st, pbatch = both_batches(jst, base, probs)
    ref = JBatched(jst, JSettings(**REDUCED), shared=SHARED).solve(jbatch)
    sol = pt.BatchedSolver(st, pt.Settings(**REDUCED), shared=SHARED,
                           device="cpu").solve(pbatch)
    assert np.all(np.asarray(ref.exit_code) == 0)
    assert_lanes_match(sol, ref)


@pytest.fixture(scope="module")
def rescue_case():
    """The banded LP with a primary cut at 3 iterations, so no lane exits
    definitively, and the reduced rescue: the JAX package's answer."""
    jst, base = make_case("lp")
    jst = jst.with_band_plan(jplan(jst, base.G, base.A))
    probs = lanes_of(base, jst.n, seed=8)
    jbatch, st, pbatch = both_batches(jst, base, probs)
    cfg = dict(kkt_strategy="banded", iter_max=3)
    jbs = JBatched(jst, JSettings(**cfg), shared=SHARED,
                   rescue=JSettings(**REDUCED))
    ref = jbs.solve(jbatch)
    return st, probs, pbatch, cfg, ref, jbs.last_rescued


def test_batched_rescue_matches(rescue_case):
    st, _, pbatch, cfg, ref, jrescued = rescue_case
    bs = pt.BatchedSolver(st, pt.Settings(**cfg), shared=SHARED,
                          rescue=pt.Settings(**REDUCED), device="cpu")
    sol = bs.solve(pbatch)
    assert jrescued == (0, 1)
    assert bs.last_rescued == jrescued
    assert_lanes_match(sol, ref)
    # the history keeps the primary's (iter_max + 1) columns
    assert sol.history.pcost.shape == (2, cfg["iter_max"] + 1)
    # a batch that needs no rescue leaves every lane alone
    bs2 = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                           shared=SHARED, rescue=pt.Settings(**REDUCED),
                           device="cpu")
    assert np.all(bs2.solve(pbatch).exit_code.numpy() == 0)
    assert bs2.last_rescued == ()


def test_solver_rescue_one_lane(rescue_case):
    """``Solver(rescue=)`` on lane 0: the primary stops at MAXIT, the
    rescue's OPTIMAL is kept, as in the JAX package."""
    _, probs, _, cfg, ref, _ = rescue_case
    p0 = probs[0]
    s = pt.Solver(p0["G"], p0["A"], p0["c"], p0["h"], p0["b"],
                  settings=pt.Settings(**cfg),
                  rescue=pt.Settings(**REDUCED), device="cpu")
    assert s.rescue.dense_solve == "inverse"
    assert s.solve() == pt.ExitCode.OPTIMAL
    assert int(s.last_solution.info.iter) == int(np.asarray(ref.info.iter)[0])
    want = float(np.asarray(ref.info.pcost)[0])
    assert abs(float(s.last_solution.info.pcost) - want) <= 1e-8 * abs(want)
    plain = pt.Solver(p0["G"], p0["A"], p0["c"], p0["h"], p0["b"],
                      settings=pt.Settings(**cfg), device="cpu")
    assert plain.solve() == pt.ExitCode.MAXIT


def test_code_rank_matches_jax():
    from eicos_tpu.api import _code_rank

    for code in (0, 1, 2, 10, 11, 12, -1, -2, -3, -7):
        assert api._code_rank(code) == _code_rank(code)
