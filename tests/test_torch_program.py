"""Solve programs kept across solves (``graphs.Program``) on the CPU: the
update_data fast path, the port's counterpart of the JAX package's cached
executable.

A CPU tensor captures nothing in the package, so the programs capture
through ``test_torch_graphs``'s ``FakeGraph``, whose replay runs the
segment's function on its static inputs and rewrites every tensor the
capture made.  Between solves the problem's values change, G and A
included: every row of G (with h) and of A (with b) is scaled by a
positive factor, one factor a cone on its rows, and c moves, so a value
that a program kept from an earlier solve shows as a changed bit.  Each
solve is held to a fresh solver's solve of the same data, bit for bit,
with the same launch counts and host syncs.  The padded rescue is held to
the unpadded one and to the JAX package's ``BatchedSolver`` on the CPU."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import gc
import io
import weakref

import numpy as np
import pytest
import torch

from test_torch_graphs import (FakeGraph, lp_banded, same_solution,
                               socp_keep_soc)

import eicos_tpu_torch as pt
from eicos_tpu_torch import graphs, kkt, problem, solver
from eicos_tpu_torch.ops import kernels

SHARED = ("G", "A", "h")


@pytest.fixture
def fake(monkeypatch):
    """Segments on CPU tensors capture into ``FakeGraph``s."""
    monkeypatch.setattr(graphs, "_captures", lambda device: True)
    monkeypatch.setattr(graphs, "_new_graph", lambda program: FakeGraph())


def lanes_of(st, d, count, seed):
    """``count`` lanes of ``d``: c and the first entries of b moved."""
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(count):
        b = np.asarray(d.b, np.float64).copy()
        b[:2] += 0.05 * rng.standard_normal(2)
        probs.append(pt.ProblemData(
            G=d.G, A=d.A, h=d.h, b=b,
            c=np.asarray(d.c) + 0.02 * rng.standard_normal(st.n)))
    return pt.BatchedSolver.stack(probs, shared=SHARED)


def rescaled(st, batch, seed):
    """``batch`` with new values everywhere and the same feasible set:
    each row of G and h times a factor in [0.5, 2] (one a cone, so that
    s stays in its cone), each row of A and b too, and c moved."""
    rng = np.random.default_rng(seed)
    rg = rng.uniform(0.5, 2.0, st.m)
    off = st.l
    for q in st.q:
        rg[off:off + q] = rg[off]
        off += q
    ra = rng.uniform(0.5, 2.0, st.p)
    c = np.asarray(batch.c)
    return pt.ProblemData(
        G=rg[:, None] * np.asarray(batch.G), A=ra[:, None] * np.asarray(
            batch.A), h=rg * np.asarray(batch.h), b=ra * np.asarray(batch.b),
        c=c + 0.01 * rng.standard_normal(c.shape))


def counted(bs, batch=None):
    """One solve with the launch counts, host syncs and graph stats read
    around it."""
    graphs.reset_stats()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    sol = bs.solve(batch)
    return (sol, dict(kernels.COUNTS), kkt.host_syncs - syncs0,
            dict(graphs.STATS))


def fresh(st, settings, batch, monkeypatch):
    """A new solver's solve of ``batch``, called directly (no graph)."""
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "_captures", lambda device: False)
        return counted(pt.BatchedSolver(st, settings, shared=SHARED,
                                        device="cpu"), batch)[:3]


CASES = [("lp", "banded", True), ("socp", "banded", True),
         ("lp", "reduced", False), ("lp", "full", False)]


@pytest.mark.parametrize("case,strategy,operands", CASES,
                         ids=["lp-banded-operands", "socp-keep-soc-operands",
                              "lp-reduced", "lp-full"])
def test_kept_program_replays_new_values(fake, monkeypatch, case, strategy,
                                         operands):
    """Solve X, then Y (G, A, c, h and b all changed), then X twice: the
    first solve captures, every later one replays only (0 captures, 0
    eager segment calls) and each gives the bits, the launch counts and
    the host syncs of a fresh solve of its data; the first solution's
    tensors are the caller's, unchanged by the later solves.
    ``operands`` forces the card's product path (``kkt._sliced_live``:
    the gather operands, whose coefficients the prologue makes)."""
    st, d = lp_banded() if case == "lp" else socp_keep_soc()
    settings = pt.Settings(kkt_strategy=strategy)
    if operands:
        monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    X = lanes_of(st, d, 3, seed=7)
    Y = rescaled(st, X, seed=11)
    want = {"X": fresh(st, settings, X, monkeypatch),
            "Y": fresh(st, settings, Y, monkeypatch)}
    assert want["X"][0].exit_code.tolist() == [0] * 3
    assert want["Y"][0].exit_code.tolist() == [0] * 3
    assert not same_solution(want["X"][0], want["Y"][0])
    bs = pt.BatchedSolver(st, settings, shared=SHARED, device="cpu")
    first, counts, syncs, stats = counted(bs, X)
    assert stats["captures"] >= 7 and stats["eager"] == stats["captures"]
    assert same_solution(first, want["X"][0])
    assert (counts, syncs) == want["X"][1:]
    kept = graphs.clone(first)
    program = bs._programs[0]
    for name in ("Y", "X", "X"):
        sol, counts, syncs, stats = counted(
            bs, Y if name == "Y" else X)
        assert stats["captures"] == 0 and stats["eager"] == 0, stats
        assert stats["replays"] > 0 and stats["copies"] > 0
        assert same_solution(sol, want[name][0]), name
        assert (counts, syncs) == want[name][1:], name
        assert bs._programs[0] is program
    assert same_solution(first, kept)


def test_solver_update_data_replays(fake, monkeypatch):
    """``Solver.update_data`` with every value new, then ``solve`` and
    ``solve_live``: no capture, no eager segment call, a fresh
    ``Solver``'s bits."""
    st, d = lp_banded()
    settings = pt.Settings(kkt_strategy="banded")
    y = rescaled(st, lanes_of(st, d, 1, seed=3), seed=5)
    new = dict(G=y.G, A=y.A, c=y.c[0], h=y.h, b=y.b[0])
    s = pt.Solver(d.G, d.A, d.c, d.h, d.b, settings=settings, device="cpu")
    assert s.solve() == pt.ExitCode.OPTIMAL
    s.update_data(**new)
    graphs.reset_stats()
    assert s.solve() == pt.ExitCode.OPTIMAL
    got = s.last_solution
    assert graphs.STATS["captures"] == 0 and graphs.STATS["eager"] == 0
    assert s.solve_live(file=io.StringIO()) == pt.ExitCode.OPTIMAL
    assert graphs.STATS["captures"] == 0 and graphs.STATS["eager"] == 0
    assert same_solution(s.last_solution, got)
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "_captures", lambda device: False)
        other = pt.Solver(new["G"], new["A"], new["c"], new["h"], new["b"],
                          settings=settings, device="cpu")
        other.solve()
    assert same_solution(got, other.last_solution)


def test_batched_update_data_replays(fake, monkeypatch):
    """``BatchedSolver.update_data`` of every field, then ``solve()``: no
    capture, no eager segment call, a fresh solver's bits."""
    st, d = lp_banded()
    settings = pt.Settings(kkt_strategy="banded")
    X = lanes_of(st, d, 2, seed=7)
    Y = rescaled(st, X, seed=13)
    bs = pt.BatchedSolver(st, settings, shared=SHARED, device="cpu")
    bs.solve(X)
    bs.update_data(**{f: getattr(Y, f) for f in ("G", "A", "c", "h", "b")})
    sol, counts, syncs, stats = counted(bs)
    assert stats["captures"] == 0 and stats["eager"] == 0
    want = fresh(st, settings, Y, monkeypatch)
    assert same_solution(sol, want[0]) and (counts, syncs) == want[1:]


@pytest.fixture(scope="module")
def rescue_case():
    """Three lanes of the banded LP with the primary cut at 3 iterations,
    so every lane goes to the "reduced" rescue, whose sub-batch pads to
    four lanes, and the JAX package's answer on the CPU."""
    import eicos_tpu as jt
    from eicos_tpu import corpus as jcorpus
    from eicos_tpu.api import BatchedSolver as JBatched
    from eicos_tpu.plan import make_band_plan as jplan

    jst, base = jcorpus.make_mpc_like(horizon=10, nx=2, nu=4, seed=3)
    jst = jst.with_gsplit(base.G, base.A)
    jst = jst.with_band_plan(jplan(jst, base.G, base.A))
    st, d = problem.from_reference(problem.structure_fields(jst), base.G,
                                   base.A, base.c, base.h, base.b)
    batch = lanes_of(st, d, 3, seed=8)
    cfg = dict(kkt_strategy="banded", iter_max=3)
    jbs = JBatched(jst, jt.Settings(**cfg), shared=SHARED,
                   rescue=jt.Settings(kkt_strategy="reduced"))
    ref = jbs.solve(JBatched.stack([jt.ProblemData(
        G=batch.G, A=batch.A, c=batch.c[i], h=batch.h, b=batch.b[i])
        for i in range(3)], shared=SHARED))
    return st, batch, cfg, ref, jbs.last_rescued


def test_padded_rescue_ends_as_unpadded_and_as_jax(rescue_case):
    """The rescue pads its three lanes to four by repeating the first, as
    ``eicos_tpu.api`` does: the rescued lanes end with the JAX package's
    codes and iterations, and each as the unpadded rescue of the three
    lanes ends it: code, iterations, and x within 1e-12 of its size (a
    CPU BLAS sums a product's row in an order that depends on the row
    count, so the two batch sizes may differ in the last bits)."""
    st, batch, cfg, ref, jrescued = rescue_case
    bs = pt.BatchedSolver(st, pt.Settings(**cfg), shared=SHARED,
                          rescue=pt.Settings(kkt_strategy="reduced"),
                          device="cpu")
    sol = bs.solve(batch)
    assert bs.last_rescued == jrescued == (0, 1, 2)
    assert bs._rescue_program.inputs[2].shape[0] == 4
    np.testing.assert_array_equal(sol.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    assert sol.exit_code.tolist() == [0] * 3
    unpadded = solver.solve_batch(st, bs._gather_lanes(torch.arange(3)),
                                  bs.rescue)
    assert sol.exit_code.tolist() == unpadded.exit_code.tolist()
    assert sol.info.iter.tolist() == unpadded.info.iter.tolist()
    scale = float(unpadded.x.abs().max())
    assert float((sol.x - unpadded.x).abs().max()) <= 1e-12 * scale


def test_programs_replaced_and_one_rescue_kept(fake, rescue_case):
    """A primary batch of another lane count replaces the primary program
    (the old one released); rescues of 3 and 4 failing lanes share one
    padded program, which captures nothing the second time; a rescue of
    another padded size replaces it, so at most one stays alive."""
    st, batch, cfg, _, _ = rescue_case
    bs = pt.BatchedSolver(st, pt.Settings(**cfg), shared=SHARED,
                          rescue=pt.Settings(kkt_strategy="reduced"),
                          device="cpu")
    bs.solve(batch)
    primary, rescue = bs._programs[0], bs._rescue_program
    held = weakref.ref(rescue.state.it.x)
    four = pt.ProblemData(G=batch.G, A=batch.A, h=batch.h,
                          c=np.concatenate([batch.c, batch.c[:1]]),
                          b=np.concatenate([batch.b, batch.b[:1]]))
    captures = rescue.captures
    bs.solve(four)
    assert bs.last_rescued == (0, 1, 2, 3)
    assert bs._rescue_program is rescue and rescue.captures == captures
    assert bs._programs[0] is not primary and primary.parts is None
    two = pt.ProblemData(G=batch.G, A=batch.A, h=batch.h, c=batch.c[:2],
                         b=batch.b[:2])
    bs.solve(two)
    assert bs._rescue_program is not rescue and rescue.parts is None
    assert bs._rescue_program.inputs[2].shape[0] == 2
    gc.collect()
    assert held() is None


@pytest.mark.parametrize("release", ["close", "collect"])
def test_released_program_drops_its_tensors(fake, release):
    """A program holds its tensors until its owner closes it or is
    collected; then a weak reference to one of them dies."""
    st, d = lp_banded()
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          shared=SHARED, device="cpu")
    bs.solve(lanes_of(st, d, 2, seed=7))
    program = bs._programs[0]
    refs = [weakref.ref(program.state.it.x), weakref.ref(program.inputs[0])]
    assert all(r() is not None for r in refs)
    if release == "close":
        bs.close()
        assert bs._programs == [None]
    else:
        del bs
    assert program.parts is None and program.state is None
    del program
    assert all(r() is None for r in refs)
