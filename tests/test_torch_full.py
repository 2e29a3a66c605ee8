"""The port's "full" and "normal" dense KKT strategies on the CPU (plain
versions of the kernels) against the JAX package on the CPU.

Tolerances: the lane-invariant base K0 at 1e-14; one refined solve, dx,
dy, dz within 1e-10 relative to their size (the two packages differ in
summation order only, and refinement stops at 1e-14 residuals); whole
solves lane by lane, equal exit codes and iteration counts and the
objective within 1e-8 relative (the exit tolerance).  "normal" on the SOCP
eliminates the cones, which squares their conditioning: both packages end
those lanes at CLOSE_TO_OPTIMAL, an iteration apart, so they are held to
the JAX package's exit tier and its objective at 1e-6."""

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
from eicos_tpu_torch import cones, kkt, problem
from eicos_tpu_torch.api import _code_rank
from eicos_tpu_torch.equilibrate import equilibrate
from eicos_tpu_torch.settings import Settings

SHARED = ("G", "A", "h")


def make_case(kind, strategy):
    """(JAX structure, data) of the small MPC LP or SOCP; "normal" takes
    the gsplit as ``Solver`` gives it one, "full" has none."""
    if kind == "soc":
        jst, d = jcorpus.make_mpc_soc(horizon=6, nx=2, nu=2, seed=5)
    else:
        jst, d = jcorpus.make_mpc_like(horizon=10, nx=2, nu=4, seed=3)
    if strategy == "normal":
        jst = jst.with_gsplit(d.G, d.A)
    return jst, d


def equilibrated(jst, d):
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    jeq = jequil(jst, *[jnp.asarray(getattr(d, f)) for f in "GAchb"])
    t = torch.tensor
    peq = equilibrate(st, t(pd.G), t(pd.A), t(pd.c)[None], t(pd.h)[None],
                      t(pd.b)[None])
    return st, jeq, peq


@pytest.mark.parametrize("kind", ["lp", "soc"])
def test_full_base_matches(kind):
    """The "full" K0 over [z | x | y]: G, A, +d on x, -d on y, 1 on the
    padding: the JAX package's pattern, and its values to the rounding of
    the two equilibrations."""
    jst, d = make_case(kind, "full")
    st, jeq, peq = equilibrated(jst, d)
    jctx = jkkt.make_context(jst, jeq.G, jeq.A, JSettings())
    pctx = kkt.make_context(st, peq.G, peq.A, Settings())
    assert pctx.K0.shape == (jctx.K0.shape[0],) * 2
    got, want = pctx.K0.numpy(), np.asarray(jctx.K0)
    assert np.array_equal(got != 0.0, want != 0.0)
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    assert pctx.split is None and pctx.dense is None


@pytest.mark.parametrize("strategy", ["full", "normal"])
@pytest.mark.parametrize("kind", ["lp", "soc"])
@pytest.mark.parametrize("scaled", [False, True])
def test_refined_solve_matches(strategy, kind, scaled):
    """One ``solve_refined`` with the strategy's factor at the identity or
    an interior NT scaling."""
    jst, d = make_case(kind, strategy)
    st, jeq, peq = equilibrated(jst, d)
    jset, pset = JSettings(kkt_strategy=strategy), Settings(
        kkt_strategy=strategy)
    jctx = jkkt.make_context(jst, jeq.G, jeq.A, jset)
    pctx = kkt.make_context(st, peq.G, peq.A, pset)
    jscal = pscal = None
    t = torch.tensor
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


def solve_both(jst, base, cfg, shared=SHARED):
    """The same two lanes through both packages' ``BatchedSolver``."""
    probs = lanes_of(base, jst.n, seed=7)
    jbatch = JBatched.stack([jt.ProblemData(**p) for p in probs],
                            shared=shared)
    st, _ = problem.from_reference(problem.structure_fields(jst), base.G,
                                   base.A, base.c, base.h, base.b)
    pbatch = pt.BatchedSolver.stack([problem.ProblemData(**p)
                                     for p in probs], shared=shared)
    ref = JBatched(jst, JSettings(**cfg), shared=shared).solve(jbatch)
    sol = pt.BatchedSolver(st, pt.Settings(**cfg), shared=shared,
                           device="cpu").solve(pbatch)
    return sol, ref


def assert_lanes_match(sol, ref):
    np.testing.assert_array_equal(sol.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    want = np.asarray(ref.info.pcost)
    assert np.all(np.abs(sol.info.pcost.numpy() - want)
                  <= 1e-8 * np.abs(want))


@pytest.mark.parametrize("kind", ["lp", "soc"])
@pytest.mark.parametrize("cfg", [
    dict(), dict(dense_solve="subst"), dict(kkt_strategy="normal")],
    ids=["full", "full-subst", "normal"])
def test_batched_solve_matches(kind, cfg):
    """Whole solves at default settings ("full"), "full" on the
    substitution sweeps, and "normal"."""
    strategy = cfg.get("kkt_strategy", "full")
    jst, base = make_case(kind, strategy)
    sol, ref = solve_both(jst, base, cfg)
    if (kind, strategy) == ("soc", "normal"):
        got = [_code_rank(int(c)) for c in sol.exit_code.numpy()]
        want = [_code_rank(int(c)) for c in np.asarray(ref.exit_code)]
        assert got == want and min(want) >= 1
        pc = np.asarray(ref.info.pcost)
        assert np.all(np.abs(sol.info.pcost.numpy() - pc) <= 1e-6 * np.abs(pc))
    else:
        assert np.all(np.asarray(ref.exit_code) == 0)
        assert_lanes_match(sol, ref)


def test_full_with_per_lane_matrices():
    """G and A with a lane axis: the base K0 is per lane."""
    jst, base = make_case("lp", "full")
    sol, ref = solve_both(jst, base, dict(), shared=())
    assert np.all(np.asarray(ref.exit_code) == 0)
    assert_lanes_match(sol, ref)


def test_solver_at_default_settings():
    """``Solver(G, A, c, h, b, device="cpu").solve()``, the package's first
    example, against the JAX package's ``Solver`` at its defaults."""
    _, d = make_case("lp", "full")
    js = jt.Solver(d.G, d.A, d.c, d.h, d.b)
    assert js.solve() == jt.ExitCode.OPTIMAL
    s = pt.Solver(d.G, d.A, d.c, d.h, d.b, device="cpu")
    assert s.get_settings() == pt.Settings()
    assert s.get_settings().kkt_strategy == "full"
    assert s.structure.gsplit is None
    assert s.solve() == pt.ExitCode.OPTIMAL
    assert int(s.get_info().iter) == int(js.get_info().iter)
    want = float(js.get_info().pcost)
    assert abs(float(s.get_info().pcost) - want) <= 1e-8 * abs(want)
    assert np.abs(s.solution() - np.asarray(js.solution())).max() < 1e-7


def test_normal_eliminates_cones_under_a_keep_soc_plan():
    """A keep_soc band plan on the structure changes nothing under
    "normal" (or "full"): only "banded" reads the plan."""
    jst, d = make_case("soc", "normal")
    jst = jst.with_band_plan(jplan(jst, d.G, d.A, keep_soc=True))
    st, _, peq = equilibrated(jst, d)
    assert st.band.keep_soc
    pset = Settings(kkt_strategy="normal")
    assert not kkt._keep_soc(st, pset)
    assert kkt._keep_soc(st, Settings(kkt_strategy="banded"))
    ctx = kkt.make_context(st, peq.G, peq.A, pset)
    assert ctx.dense.ms == 0 and ctx.dense.me == st.m
    assert ctx.K0.shape[-1] == kkt.pad_to_block(st.n + st.p)
