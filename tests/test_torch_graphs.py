"""Segments and programs of ``eicos_tpu_torch.graphs`` on the CPU.

A CPU tensor never captures and never touches ``torch.cuda``.  The replay
discipline of a CUDA graph (static inputs read in place or copied in,
captured outputs rewritten in place by every replay, launch counts added
per replay) is held on the CPU through ``FakeGraph``, injected where the
program makes its graphs: a whole solve through it gives the bits, the
counts and the host syncs of the direct solve.  The card's own graphs are
held in ``tests/test_torch_cuda.py``."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

import eicos_tpu_torch as pt
from eicos_tpu_torch import corpus, graphs, kkt
from eicos_tpu_torch.ops import kernels
from eicos_tpu_torch.plan import make_band_plan


def rewritten(kept, new):
    """(kept tensor, new tensor) pairs of two outputs of one function:
    through tuples and lists, and through the attributes of any other
    object that is not the same in both (an operand of the KKT context
    holds the coefficients its graph rewrites).  An attribute that only
    the kept output has (a value cached on it later) is not rewritten,
    as a real replay would not rewrite it."""
    if kept is new:
        return
    if isinstance(kept, torch.Tensor):
        yield kept, new
    elif isinstance(kept, (tuple, list)):
        for k, n in zip(kept, new, strict=True):
            yield from rewritten(k, n)
    elif type(kept) is type(new) and hasattr(kept, "__dict__"):
        fresh = vars(new)
        for name, k in vars(kept).items():
            if name in fresh:
                yield from rewritten(k, fresh[name])


class FakeGraph:
    """A CUDA graph's contract, kept on the CPU.  A capture records work
    and does none, so ``capture`` runs the function on copies of its
    inputs (they take its in-place writes) and keeps the outputs, an input
    passed through standing for itself; ``replay`` runs the function on
    the static inputs and copies the results into the kept outputs, and
    into the tensors that objects of the outputs hold (``rewritten``), as
    a replay rewrites every tensor its capture made.  A replay runs no
    Python: the counts its function makes are dropped (the program adds
    the captured ones)."""

    def capture(self, fn, args):
        leaves = []
        spec = graphs._flatten(args, {}, leaves)
        copies = [x.clone() if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        back = {id(cp): x for cp, x in zip(copies, leaves)
                if isinstance(x, torch.Tensor)}
        out = fn(*graphs._unflatten(spec, iter(copies)))
        leaves = []
        spec = graphs._flatten(out, {}, leaves)
        self.out = graphs._unflatten(spec, iter(
            [back.get(id(x), x) for x in leaves]))
        self.fn, self.args = fn, args
        return self.out

    def replay(self):
        with kernels.recording():
            new = self.fn(*self.args)
        for s, n in rewritten(self.out, new):
            s.copy_(n)


@pytest.fixture
def fake(monkeypatch):
    """Segments on CPU tensors capture into ``FakeGraph``s."""
    monkeypatch.setattr(graphs, "_captures", lambda device: True)
    monkeypatch.setattr(graphs, "_new_graph", lambda program: FakeGraph())


def bits(t):
    """A tensor's bits as integers (NaNs compare)."""
    if t.is_floating_point():
        return t.contiguous().view({8: torch.int64, 4: torch.int32}[
            t.element_size()])
    return t


def same_solution(a, b):
    return all(torch.equal(bits(x), bits(y))
               for x, y in zip(graphs.tensors(a), graphs.tensors(b),
                               strict=True))


def lp_banded():
    st, d = corpus.make_mpc_like(4, 2, 2)
    st = st.with_gsplit(d.G, d.A)
    return st.with_band_plan(make_band_plan(st, d.G, d.A)), d


def socp_keep_soc():
    st, d = corpus.make_mpc_soc(4, 2, 2)
    st = st.with_gsplit(d.G, d.A)
    return st.with_band_plan(make_band_plan(st, d.G, d.A, keep_soc=True)), d


def counted_solve(st, d, settings):
    graphs.reset_stats()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    sol = pt.solve(st, d, settings, device="cpu")
    return (sol, dict(kernels.COUNTS), kkt.host_syncs - syncs0,
            dict(graphs.STATS))


def test_cpu_segments_never_touch_cuda(monkeypatch):
    """A CPU solve with every entry of ``torch.cuda`` that a graph needs
    made to raise: it solves, and a segment calls its function at every
    call."""
    def boom(*args, **kw):
        raise AssertionError("torch.cuda touched")

    for name in ("graph", "CUDAGraph", "Stream", "current_stream", "stream",
                 "synchronize", "graph_pool_handle", "device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, boom)
    st, d = lp_banded()
    sol = pt.solve(st, d, pt.Settings(kkt_strategy="banded"), device="cpu")
    assert int(sol.exit_code) == 0
    calls = []
    with graphs.Program("cpu") as program:
        seg = program.segment("probe", lambda v: calls.append(1) or v + 1)
        x = torch.zeros(3)
        for _ in range(5):
            assert torch.equal(seg(x), x + 1)
    assert len(calls) == 5 and program.captures == 0


@pytest.mark.parametrize("case,strategy,operands", [
    ("lp", "banded", False), ("lp", "banded", True),
    ("socp", "banded", False), ("socp", "banded", True),
    ("lp", "reduced", True), ("lp", "full", False)],
    ids=["lp-banded", "lp-banded-operands", "socp-keep-soc",
         "socp-keep-soc-operands", "lp-reduced-operands", "lp-full"])
def test_fake_graphs_give_the_direct_bits(monkeypatch, case, strategy,
                                          operands):
    """A solve whose segments capture and replay through ``FakeGraph``
    against the direct solve: every field of the solution bit for bit,
    the launch counts and the host syncs, with at least A, B and C
    captured and replayed.  ``operands`` forces the card's product path
    (``kkt._sliced_live``: the plain gathers and the rotated loop)."""
    st, d = lp_banded() if case == "lp" else socp_keep_soc()
    settings = pt.Settings(kkt_strategy=strategy)
    if operands:
        monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    want, wcounts, wsyncs, _ = counted_solve(st, d, settings)
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "_captures", lambda device: True)
        mp.setattr(graphs, "_new_graph", lambda program: FakeGraph())
        got, counts, syncs, stats = counted_solve(st, d, settings)
    assert int(want.exit_code) == 0
    assert same_solution(got, want)
    assert counts == wcounts and syncs == wsyncs
    assert stats["captures"] >= 3
    assert stats["replays"] > stats["captures"]


def test_replays_add_the_captured_counts(fake):
    """The warm-up before the capture counts apart (``warm_counts``), the
    capture's launches count once with the replay that follows it, and
    every later replay adds them."""
    graphs.reset_stats()
    kernels.reset_counts()

    def body(v):
        kernels.count("spmv")
        kernels.count("dgemm")
        kernels.count("dgemm")
        return v * 2.0

    with graphs.Program("cpu") as program:
        x = program.buffers(torch.arange(3.0))
        seg = program.segment("probe", body)
        for _ in range(5):
            out = seg(x)
    assert kernels.COUNTS["spmv"] == 5 and kernels.COUNTS["dgemm"] == 10
    assert torch.equal(out, torch.arange(3.0) * 2.0)
    assert graphs.STATS["eager"] == 1 and graphs.STATS["captures"] == 1
    assert graphs.STATS["replays"] == 5
    assert graphs.STATS["graph_counts"] == {"spmv": 5, "dgemm": 10}
    assert graphs.STATS["warm_counts"] == {"spmv": 1, "dgemm": 2}


def test_inputs_are_copied_or_read_in_place(fake):
    """A held tensor is read in place (an update shows at the next
    replay); any other tensor is copied into the graph's buffer; outputs
    are rewritten in place; a replaced held tensor or a changed scalar
    raises, naming the segment."""
    with graphs.Program("cpu") as program:
        state = program.buffers(torch.zeros(2))
        seg = program.segment("probe", lambda s, v, k: s + v * k)
        out = seg(state, torch.ones(2), 3.0)
        assert seg(state, torch.ones(2), 3.0) is out
        assert torch.equal(out, torch.full((2,), 3.0))
        state.fill_(1.0)
        again = seg(state, torch.full((2,), 2.0), 3.0)
        assert again is out and torch.equal(out, torch.full((2,), 7.0))
        with pytest.raises(RuntimeError, match="probe"):
            seg(state.clone(), torch.ones(2), 3.0)
        with pytest.raises(RuntimeError, match="probe"):
            seg(state, torch.ones(2), 4.0)
        with pytest.raises(RuntimeError, match="probe"):
            seg(state, torch.ones(3), 3.0)


def test_failed_capture_raises_naming_the_segment(monkeypatch):
    """A capture that fails raises ``RuntimeError`` with the segment's
    name; after its warm-up, the segment is not run eagerly instead."""
    class Broken:
        def capture(self, fn, args):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(graphs, "_captures", lambda device: True)
    monkeypatch.setattr(graphs, "_new_graph", lambda program: Broken())
    calls = []
    with graphs.Program("cpu") as program:
        seg = program.segment("iteration A", lambda v: calls.append(1) or v)
        with pytest.raises(RuntimeError, match="capturing segment "
                           "'iteration A' failed"):
            seg(torch.zeros(1))
    assert len(calls) == 1


def test_buffers_are_distinct_and_state_updates_in_place():
    """``buffers`` copies a tree whose fields share tensors into distinct
    ones; ``copy_into`` writes a tree into them."""
    t = torch.zeros(2)
    with graphs.Program("cpu") as program:
        a, b_ = program.buffers((t, t))
        assert a is not b_ and a is not t
        graphs.copy_into((a, b_), (torch.ones(2), torch.full((2,), 2.0)))
    assert torch.equal(a, torch.ones(2)) and torch.equal(b_, 2 * a)
    assert not t.any()
    np.testing.assert_array_equal(b_.numpy(), [2.0, 2.0])
