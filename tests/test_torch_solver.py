"""The slice as a whole: the port's BatchedSolver / Solver on the CPU (plain
twins of the kernels) against the JAX package's on the CPU, lane by lane:
the same exit code and iteration count, the objective within 1e-8
relative and x, y, z within 1e-6 absolute."""

import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import corpus as jcorpus
from eicos_tpu.api import BatchedSolver as JBatched
from eicos_tpu.plan import make_band_plan as jplan

import eicos_tpu_torch as pt
from eicos_tpu_torch import kkt, problem

H, LANES = 50, 4
SHARED = ("G", "A", "h")


def lanes_of(base, n, rng):
    """The bench's batch: shared G/A/h, per-lane c and x0 (in b)."""
    probs = []
    for _ in range(LANES):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(n)
        b = np.asarray(base.b).copy()
        b[:2] += 0.05 * rng.standard_normal(2)
        probs.append(dict(G=np.asarray(base.G), A=np.asarray(base.A), c=c,
                          h=np.asarray(base.h), b=b))
    return probs


@pytest.fixture(scope="module")
def bench():
    jst, base = jcorpus.make_mpc_like(horizon=H, nx=2, nu=4, seed=3)
    jst = jst.with_gsplit(base.G, base.A)
    jst = jst.with_band_plan(jplan(jst, base.G, base.A))
    probs = lanes_of(base, jst.n, np.random.default_rng(7))
    jbatch = JBatched.stack([jt.ProblemData(**p) for p in probs],
                            shared=SHARED)
    ref = JBatched(jst, jt.Settings(kkt_strategy="banded"),
                   shared=SHARED).solve(jbatch)
    ref = {f: np.asarray(getattr(ref, f)) for f in ("exit_code", "x", "y",
                                                    "z")} | {
        "iter": np.asarray(ref.info.iter), "pcost": np.asarray(ref.info.pcost)}
    st, _ = problem.from_reference(problem.structure_fields(jst), base.G,
                                   base.A, base.c, base.h, base.b)
    return st, probs, ref


def assert_lane_parity(sol, ref, lanes):
    np.testing.assert_array_equal(sol.exit_code.numpy(), ref["exit_code"][lanes])
    np.testing.assert_array_equal(sol.info.iter.numpy(), ref["iter"][lanes])
    pc = sol.info.pcost.numpy()
    assert np.all(np.abs(pc - ref["pcost"][lanes])
                  <= 1e-8 * np.abs(ref["pcost"][lanes]))
    for f in "xyz":
        np.testing.assert_allclose(getattr(sol, f).numpy(), ref[f][lanes],
                                   rtol=0, atol=1e-6)


def test_batched_lanes_match(bench):
    st, probs, ref = bench
    batch = pt.BatchedSolver.stack([problem.ProblemData(**p) for p in probs],
                                   shared=SHARED)
    syncs = kkt.host_syncs
    sol = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                           shared=SHARED, device="cpu").solve(batch)
    assert np.all(ref["exit_code"] == 0)
    assert_lane_parity(sol, ref, slice(None))
    # host syncs: one per IPM iteration (and one final check), one per
    # refinement trip -- bounded by the refinement cap
    iters = int(sol.info.iter.max())
    nitref = pt.Settings().nitref
    assert kkt.host_syncs - syncs <= (iters + 2) * (1 + 2 * (nitref + 2))


def test_per_lane_G_matches_shared(bench):
    """G and A with a lane axis (nothing shared but h) take the batched
    matmul paths and give the shared path's answers."""
    st, probs, ref = bench
    batch = pt.BatchedSolver.stack([problem.ProblemData(**p) for p in probs],
                                   shared=("h",))
    assert batch.G.ndim == 3
    sol = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                           shared=("h",), device="cpu").solve(batch)
    assert_lane_parity(sol, ref, slice(None))


def test_solver_one_lane_and_update_data(bench):
    """Solver (a batch of one) on lane 0, then update_data to lane 1's c
    and b: each matches its lane of the JAX batch."""
    st, probs, ref = bench
    p0 = probs[0]
    s = pt.Solver(p0["G"], p0["A"], p0["c"], p0["h"], p0["b"],
                  settings=pt.Settings(kkt_strategy="banded"), device="cpu")
    assert s.structure == st
    assert s.solve() == pt.ExitCode.OPTIMAL
    sol = s.last_solution
    one = type(sol)(*[v[None] if isinstance(v, torch.Tensor)
                      else type(v)(*[u[None] for u in v]) for v in sol])
    assert_lane_parity(one, ref, slice(0, 1))
    np.testing.assert_allclose(s.solution(), ref["x"][0], rtol=0, atol=1e-6)
    s.update_data(c=probs[1]["c"], b=probs[1]["b"])
    assert s.solve() == pt.ExitCode(int(ref["exit_code"][1]))
    assert int(s.last_solution.info.iter) == int(ref["iter"][1])


def test_batched_update_data(bench):
    st, probs, ref = bench
    batch = pt.BatchedSolver.stack([problem.ProblemData(**p)
                                    for p in probs[:2]], shared=SHARED)
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          shared=SHARED, device="cpu")
    bs.solve(batch)
    bs.update_data(c=np.stack([probs[2]["c"], probs[3]["c"]]),
                   b=np.stack([probs[2]["b"], probs[3]["b"]]))
    assert_lane_parity(bs.solve(), ref, slice(2, 4))


def test_infeasible_lp_exit_code():
    """A hand-built LP with x1 >= 1 and x1 <= 0 (singleton rows only, so
    it lies on the banded slice): the same certificate as JAX."""
    G = np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]])
    h = np.array([-1.0, 0.0, 5.0, 5.0])
    c = np.array([1.0, 1.0])
    jsol = jt.Solver(G, None, c, h, None,
                     settings=jt.Settings(kkt_strategy="banded"))
    want = jsol.solve()
    s = pt.Solver(G, None, c, h, None,
                  settings=pt.Settings(kkt_strategy="banded"), device="cpu")
    got = s.solve()
    assert want == jt.ExitCode.PRIMAL_INFEASIBLE
    assert int(got) == int(want)
    assert int(s.last_solution.info.iter) == int(
        jsol.last_solution.info.iter)
