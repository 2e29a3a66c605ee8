"""The composed solve of a kept program (``graphs.Program.compose``) on the
CPU: one launch that runs the whole solve, its loops decided on the
device, the port's counterpart of the JAX package's single
``lax.while_loop``.

A CPU tensor composes nothing in the package, so the programs capture
through ``test_torch_graphs.FakeGraph`` and compose into ``FakeLoopGraph``,
injected where a program makes its composed graph: its launch interprets
the plan as the card runs it, each segment's fake graph replayed, each
loop's flag tested by S2's plain version (``graph_loop.loop_cond_plain``)
before the first trip and after each, with no host sync counted.  A kept
solver's solves after its first are held to a fresh solver's host-driven
solve bit for bit, with 0 host syncs and, once settled
(``graphs.settle``), the same launch counts; the card's own composed
graphs are held in ``tests/test_torch_cuda.py``.  The fake launch also
stamps as a traced graph does, with the stamp kernel's and S2's plain
versions, on a clock that only a segment's replay moves, by an amount of
its own: each segment's stamped sum must be that amount times its
replays."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import io

import numpy as np
import pytest
import torch

from test_torch_graphs import (FakeGraph, lp_banded, same_solution,
                               socp_keep_soc)
from test_torch_program import SHARED, lanes_of, rescaled

import eicos_tpu_torch as pt
from eicos_tpu_torch import graphs, kkt
from eicos_tpu_torch.ops import kernels
from eicos_tpu_torch.utils import timing
from eicos_tpu_torch.ops.graph_loop import (END, START, loop_cond_plain,
                                            loop_stamp_plain)


class FakeLoopGraph:
    """A composed graph's contract, kept on the CPU: ``launch`` runs the
    plan as the card does (module doc); the trip counters and stamps are
    the program's, a CPU tensor.  ``ticks``: each segment's time, in ns
    of the fake clock; ``last``: each segment's replays in the last
    launch."""

    def __init__(self, program, plan):
        self.program, self.plan = program, plan
        self.launches = 0
        self.now = 10 ** 12
        segs = () if program.stamps is None else program.stamps.segments
        self.ticks = {seg.name: 1000 * (k + 1) for k, seg in enumerate(segs)}
        self.last = dict.fromkeys(self.ticks, 0)

    def replay(self, seg) -> None:
        seg._graph.replay()
        if self.ticks:
            self.now += self.ticks[seg.name]
            self.last[seg.name] += 1

    def _cond(self, flag, slot, seg):
        st = self.program.stamps
        cells = (None, None) if st is None else st.cells(seg)
        return loop_cond_plain(flag, self.program.trips, slot, *cells,
                               now=self.now)

    def _run(self, items) -> None:
        for it in items:
            if isinstance(it, graphs.Loop):
                go = self._cond(it.flag, it.pre, it.pre_seg)
                while go:
                    self._run(it.body)
                    go = self._cond(it.flag, it.trip, it.trip_seg)
            else:
                self.replay(it)

    def launch(self) -> None:
        self.launches += 1
        self.last = dict.fromkeys(self.ticks, 0)
        st, trips = self.program.stamps, self.program.trips
        if st is not None:
            loop_stamp_plain(trips, st.block, START, self.now)
        self._run(self.plan)
        if st is not None:
            loop_stamp_plain(trips, st.block, END, self.now,
                             st.acc[id(st.last)])

    def close(self) -> None:
        self.plan = None


@pytest.fixture
def fake(monkeypatch):
    """Segments on CPU tensors capture into ``FakeGraph``s, and kept
    programs compose into a ``FakeLoopGraph``."""
    monkeypatch.setattr(graphs, "_captures", lambda device: True)
    monkeypatch.setattr(graphs, "_composes", lambda device: True)
    monkeypatch.setattr(graphs, "_new_graph", lambda program: FakeGraph())
    monkeypatch.setattr(graphs, "_new_loop", FakeLoopGraph)


def counted(solve):
    """``solve()`` with the settled launch counts, host syncs and graph
    stats read around it."""
    graphs.reset_stats()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    sol = solve()
    graphs.settle()
    return (sol, dict(kernels.COUNTS), kkt.host_syncs - syncs0,
            dict(graphs.STATS))


def fresh(st, settings, batch, monkeypatch):
    """A new solver's host-driven solve of ``batch``: (solution, counts,
    host syncs)."""
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "_captures", lambda device: False)
        mp.setattr(graphs, "_composes", lambda device: False)
        bs = pt.BatchedSolver(st, settings, shared=SHARED, device="cpu")
        return counted(lambda: bs.solve(batch))[:3]


def as_composed(want):
    """A host-driven solve's counts and syncs as a composed solve of the
    same data shows them: every loop test an S2 launch, the two stamps of
    a traced launch, no host sync."""
    counts, syncs = want[1:]
    return dict(counts, loop_cond=counts["loop_cond"] + syncs,
                loop_stamp=2), 0


def check_composed(got, want, label, loop):
    """``got``, one composed solve through ``loop`` (counted), against a
    fresh host-driven solve ``want``; its stamps: each of the nine
    segments' sums its own time, together the launch's span."""
    sol, counts, syncs, stats = got
    assert stats["loops"] == 1, (label, stats)
    assert stats["captures"] == 0 and stats["eager"] == 0, (label, stats)
    assert stats["replays"] > 0, label
    assert same_solution(sol, want[0]), label
    for f in ("exit_code", "x", "y", "z"):
        assert torch.equal(getattr(sol, f), getattr(want[0], f)), (label, f)
    assert (counts, syncs) == as_composed(want), label
    assert len(loop.ticks) == 9, label
    assert stats["segments_ns"] == {n: loop.ticks[n] * loop.last[n]
                                    for n in loop.ticks}, label
    (launch,) = stats["launches"]
    assert launch["device_ns"] == sum(stats["segments_ns"].values()), label
    assert stats["stamps_overwritten"] == 0, label


@pytest.mark.parametrize("case", ["lp", "socp"])
def test_composed_solves_give_fresh_bits(fake, monkeypatch, case):
    """A kept solver solves X (host-driven; composes at its end), then Y
    after ``update_data`` (G, A, c, h, b all new), then X: each later
    solve is one composed launch with 0 host syncs, a fresh solver's bits,
    and, settled, its launch counts; the first result stays the
    caller's."""
    st, d = lp_banded() if case == "lp" else socp_keep_soc()
    settings = pt.Settings(kkt_strategy="banded")
    X = lanes_of(st, d, 2, seed=7)
    Y = rescaled(st, X, seed=11)
    want = {"X": fresh(st, settings, X, monkeypatch),
            "Y": fresh(st, settings, Y, monkeypatch)}
    assert want["Y"][0].exit_code.tolist() == [0, 0]
    bs = pt.BatchedSolver(st, settings, shared=SHARED, device="cpu")
    first, counts, syncs, stats = counted(lambda: bs.solve(X))
    assert stats["loops"] == 0 and syncs == want["X"][2]
    assert same_solution(first, want["X"][0])
    kept = graphs.clone(first)
    program = bs._programs[0]
    assert program.loop is not None and program.loop.launches == 0
    graphs.reset_stats()
    bs.update_data(**{f: getattr(Y, f) for f in ("G", "A", "c", "h", "b")})
    (update,) = [s for s in timing.spans() if s.name == "api.update_data"]
    got = counted(lambda: bs.solve())
    check_composed(got, want["Y"], "Y", program.loop)
    # the launch joins the solve's request, which update_data carried
    (solve,) = [s for s in got[3]["spans"] if s["name"] == "api.solve"]
    assert got[3]["launches"][0]["request"] == solve["request"] \
        == update.request > 0
    (call,) = [s for s in got[3]["spans"] if s["name"] == "program.launch"]
    assert call["launch"] == got[3]["launches"][0]["index"] == 0
    check_composed(counted(lambda: bs.solve(X)), want["X"], "X",
                   program.loop)
    assert program.loop.launches == 2 and bs._programs[0] is program
    assert same_solution(first, kept)


def test_host_driven_reaches_the_shard_threads(fake):
    """``graphs.host_driven()`` reaches the threads of a sharded solve: a
    kept solver over a CPU mesh of two, composed after its first solve,
    solves inside the block from the host on both shards (no composed
    launch, host syncs) with the composed solve's bits, and composes
    again after it."""
    st, d = lp_banded()
    X = lanes_of(st, d, 2, seed=7)
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          shared=SHARED, mesh=[torch.device("cpu")] * 2)
    bs.solve(X)
    got, _, syncs, stats = counted(lambda: bs.solve(X))
    assert stats["loops"] == 2 and syncs == 0
    with graphs.host_driven():
        want, _, wsyncs, wstats = counted(lambda: bs.solve(X))
    assert wstats["loops"] == 0 and wsyncs > 0
    for f in ("exit_code", "x", "y", "z"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert counted(lambda: bs.solve(X))[3]["loops"] == 2


def test_zero_trip_loops_capture_without_launch(fake, monkeypatch):
    """``nitref=0`` on the operand path (the rotated loop): every
    refinement trip runs zero times, so the first solve never calls the
    three trip segments; the composition captures them without a launch
    (its replays are A, B, C and the rest), and the composed solves, whose
    trip loops each test their flag once and stop, give the fresh
    bits."""
    monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    st, d = lp_banded()
    settings = pt.Settings(kkt_strategy="banded", nitref=0)
    X = lanes_of(st, d, 2, seed=5)
    want = fresh(st, settings, X, monkeypatch)
    bs = pt.BatchedSolver(st, settings, shared=SHARED, device="cpu")
    _, counts, syncs, stats = counted(lambda: bs.solve(X))
    program = bs._programs[0]
    trips = [program.parts.init_trip, program.parts.trip2,
             program.parts.trip1]
    iters = int(want[0].info.iter.max())
    # iters + 1 loop bodies: one init test, an outer test before each
    # body and after the last, and two trip tests a body
    assert syncs == 1 + (iters + 2) + 2 * (iters + 1)
    assert all(seg._graph is not None for seg in trips)
    # every segment captured once, the three trips by the composition,
    # which launches nothing
    assert stats["captures"] == 9 and stats["eager"] == 9
    assert stats["replays"] == 3 + 3 * (iters + 1)
    for _ in range(2):
        check_composed(counted(lambda: bs.solve(X)), want, "nitref 0",
                       program.loop)
    assert int(program.trips[program.plan[1].trip]) == 0


def test_iter_max_ends_at_maxit_through_the_loop(fake, monkeypatch):
    """``iter_max=3``: the composed solve leaves its outer loop after the
    iteration-3 body with the host loop's MAXIT code (the returned iterate
    the best one, here iteration 0's) and bits."""
    st, d = lp_banded()
    settings = pt.Settings(kkt_strategy="banded", iter_max=3)
    X = lanes_of(st, d, 2, seed=9)
    want = fresh(st, settings, X, monkeypatch)
    assert want[0].exit_code.tolist() == [int(pt.ExitCode.MAXIT)] * 2
    bs = pt.BatchedSolver(st, settings, shared=SHARED, device="cpu")
    bs.solve(X)
    program = bs._programs[0]
    check_composed(counted(lambda: bs.solve(X)), want, "iter_max 3",
                   program.loop)
    outer = program.plan[3]
    assert [int(program.trips[i]) for i in (outer.pre, outer.trip)] == [1, 4]


def test_live_table_keeps_its_host_reads(fake, monkeypatch):
    """After the composition, ``solve_live`` and ``verbose_live`` drive
    the loop from the host: one host read a trip, as a fresh host-driven
    solve makes, the composed solve's bits, and no composed launch."""
    st, d = lp_banded()
    settings = pt.Settings(kkt_strategy="banded")
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "_captures", lambda device: False)
        mp.setattr(graphs, "_composes", lambda device: False)
        other = pt.Solver(d.G, d.A, d.c, d.h, d.b, settings=settings,
                          device="cpu")
        host_syncs = counted(other.solve)[2]
    s = pt.Solver(d.G, d.A, d.c, d.h, d.b, settings=settings, device="cpu")
    s.solve()
    _, _, syncs, stats = counted(s.solve)
    composed = s.last_solution
    assert syncs == 0 and stats["loops"] == 1
    assert same_solution(composed, other.last_solution)
    text = io.StringIO()
    _, _, syncs, stats = counted(lambda: s.solve_live(file=text))
    assert stats["loops"] == 0 and stats["captures"] == 0
    assert syncs == host_syncs
    assert same_solution(s.last_solution, composed)
    assert len(text.getvalue().splitlines()) > int(composed.info.iter)
    live = pt.Solver(d.G, d.A, d.c, d.h, d.b, device="cpu",
                     settings=pt.Settings(kkt_strategy="banded",
                                          verbose_live=True))
    with monkeypatch.context() as mp:
        mp.setattr("sys.stdout", io.StringIO())
        live.solve()
        _, _, vsyncs, stats = counted(live.solve)
    assert stats["loops"] == 0 and vsyncs == host_syncs


def test_composed_solve_matches_jax_lane_by_lane(fake):
    """A composed repeated solve of three lanes against
    ``eicos_tpu.api.BatchedSolver`` on the CPU: codes and iterations
    equal, the objective within 1e-8 of its size."""
    import eicos_tpu as jt
    from eicos_tpu.api import BatchedSolver as JBatched

    st, d = lp_banded()
    settings = pt.Settings(kkt_strategy="banded")
    X = lanes_of(st, d, 3, seed=21)
    bs = pt.BatchedSolver(st, settings, shared=SHARED, device="cpu")
    bs.solve(X)
    sol, _, syncs, stats = counted(lambda: bs.solve(X))
    assert stats["loops"] == 1 and syncs == 0
    jst = _jax_structure(d)
    ref = JBatched(jst, jt.Settings(kkt_strategy="banded"),
                   shared=SHARED).solve(JBatched.stack([jt.ProblemData(
                       G=X.G, A=X.A, c=X.c[i], h=X.h, b=X.b[i])
                       for i in range(3)], shared=SHARED))
    np.testing.assert_array_equal(sol.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    want = np.asarray(ref.info.pcost)
    np.testing.assert_allclose(sol.info.pcost.numpy(), want, rtol=1e-8)


def _jax_structure(d):
    """``lp_banded``'s structure in the JAX package."""
    from eicos_tpu import corpus as jcorpus
    from eicos_tpu.plan import make_band_plan as jplan

    jst, base = jcorpus.make_mpc_like(4, 2, 2)
    jst = jst.with_gsplit(base.G, base.A)
    return jst.with_band_plan(jplan(jst, base.G, base.A))


def test_settle_reset_and_close(fake):
    """Counts of composed launches arrive only at ``settle``; a
    ``reset_stats`` before it drops them, as does ``close``."""
    st, d = lp_banded()
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          shared=SHARED, device="cpu")
    X = lanes_of(st, d, 2, seed=3)
    bs.solve(X)
    graphs.reset_stats()
    kernels.reset_counts()
    bs.solve(X)
    assert kernels.COUNTS["loop_cond"] == 0 and graphs.STATS["replays"] == 0
    graphs.settle()
    once = dict(kernels.COUNTS)
    assert once["loop_cond"] > 0 and graphs.STATS["replays"] > 0
    graphs.settle()
    assert kernels.COUNTS == once
    bs.solve(X)
    graphs.reset_stats()
    kernels.reset_counts()
    graphs.settle()
    assert kernels.COUNTS["loop_cond"] == 0
    bs.solve(X)
    bs.close()
    graphs.settle()
    assert kernels.COUNTS["loop_cond"] == 0


def test_compose_raises_on_a_copied_argument(fake):
    """A composed graph copies nothing: a segment that copies an argument
    into its static buffer, or a loop on a flag the program does not
    hold, raises ``RuntimeError`` naming it."""
    owner = object.__new__(type("Owner", (), {}))
    with graphs.Program("cpu", owner=owner) as program:
        x = program.buffers(torch.zeros(2))
        done = program.buffers(torch.ones(2, dtype=torch.bool))
        seg = program.segment("probe", lambda s, v: s + v)
        seg(x, torch.ones(2))
        with pytest.raises(RuntimeError, match="'probe'"):
            program.compose(lambda call, loop: call(seg, x, torch.ones(2)))
        with pytest.raises(RuntimeError, match="flag"):
            program.compose(lambda call, loop: loop(
                torch.ones(2, dtype=torch.bool), lambda: None))
        ok = program.segment("held", lambda s: s * 2.0)
        ok(x)
        program.compose(lambda call, loop: (loop(done, lambda: call(ok, x)),
                                            call(ok, x))[1])
        out = program.launch()
        assert torch.equal(out, x * 2.0)
        assert program.trips[:2].tolist() == [1, 0]


def test_stamp_ring_overflow_is_reported(fake):
    """1,030 launches of a one-segment program, then one settle: the
    ring keeps the last 1,024 launches' stamps, and the 6 it overwrote
    count in ``stamps_overwritten``; the sums still equal the spans, and
    the stamp nodes counted two launches each."""
    from eicos_tpu_torch.ops.graph_loop import STAMP_RING

    owner = object.__new__(type("Owner", (), {}))
    graphs.reset_stats()
    kernels.reset_counts()
    with graphs.Program("cpu", owner=owner) as program:
        x = program.buffers(torch.zeros(2))
        done = program.buffers(torch.ones(2, dtype=torch.bool))
        seg = program.segment("double", lambda s: s * 2.0)
        seg(x)
        program.compose(lambda call, loop: (loop(done, lambda: None),
                                            call(seg, x))[1])
        for _ in range(STAMP_RING + 6):
            program.launch()
        graphs.settle()
    stats = graphs.STATS
    assert stats["stamps_overwritten"] == 6
    assert len(stats["launches"]) == STAMP_RING
    assert stats["launches"][0]["index"] == 6
    assert stats["segments_ns"]["double"] >= sum(
        e["device_ns"] for e in stats["launches"])
    assert kernels.COUNTS["loop_stamp"] == 2 * (STAMP_RING + 6)


def test_trace_off_records_nothing(fake, monkeypatch):
    """``EICOS_TORCH_TRACE=0``: no span, and a composed graph without
    stamps (its trip counters alone, S2 without a stamp cell): no stamp
    counted or launched, nothing in ``STATS`` from them."""
    monkeypatch.setenv("EICOS_TORCH_TRACE", "0")
    owner = object.__new__(type("Owner", (), {}))
    graphs.reset_stats()
    kernels.reset_counts()
    with graphs.Program("cpu", owner=owner) as program, \
            timing.span("api.solve"):
        x = program.buffers(torch.zeros(2))
        done = program.buffers(torch.ones(2, dtype=torch.bool))
        seg = program.segment("double", lambda s: s * 2.0)
        seg(x)
        program.compose(lambda call, loop: (loop(done, lambda: None),
                                            call(seg, x))[1])
        program.launch()
        assert program.stamps is None and program.loop.ticks == {}
        assert program.trips.tolist() == [1, 0]
        graphs.settle()
    stats = graphs.STATS
    assert stats["loops"] == 1 and kernels.COUNTS["loop_cond"] == 1
    assert kernels.COUNTS["loop_stamp"] == 0 and stats["segments_ns"] == {}
    assert stats["spans"] == [] and stats["launches"] == []
    assert timing.spans() == []
