"""The port's API surface against the JAX package on the CPU:
``Solver.from_csc`` (the reference's argument order), ``solve(verbose=True)``
(the iteration table and summary), ``save_problem``/``load_problem`` (the
npz round trip, cross-loaded between the packages) and
``Settings(verbose_live=True)``, which streams the table on every entry
point; and the API's host spans and upload counter (``utils/timing``,
``graphs.STATS``).  Inputs come from a numpy seed."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import scipy.sparse as sp

import eicos_tpu as jt

import eicos_tpu_torch as pt
from eicos_tpu_torch import problem

SHARED = ("G", "A", "h")
SMALL = pt.Settings(block=16)      # a small leaf: quick on the CPU


def _problem(soc: bool, seed: int = 5):
    """A small feasible LP (a box and two equalities) and, with ``soc``,
    a second-order cone ||(x0, x1)|| <= 1.5 on top: G, A, c, h, b, q."""
    rng = np.random.default_rng(seed)
    n, p = 6, 2
    G = np.vstack([np.eye(n), -np.eye(n)])
    h = np.ones(2 * n)
    q = ()
    if soc:
        Gs = np.zeros((3, n))
        Gs[1, 0] = Gs[2, 1] = -1.0
        G = np.vstack([G, Gs])
        h = np.concatenate([h, [1.5, 0.0, 0.0]])
        q = (3,)
    A = rng.standard_normal((p, n))
    b = A @ (0.3 * rng.uniform(-1, 1, n))
    c = rng.standard_normal(n)
    return G, A, c, h, b, q


def _csc_args(G, A, c, h, b, q):
    Gs, As = sp.csc_matrix(G), sp.csc_matrix(A)
    m, n = G.shape
    return (n, m, A.shape[0], m - sum(q), len(q), np.array(q, np.int64),
            Gs.data, Gs.indptr, Gs.indices, As.data, As.indptr, As.indices,
            c, h, b)


@pytest.mark.parametrize("soc", [False, True], ids=["lp", "socp"])
def test_from_csc_matches_reference(soc):
    """The same exit code and iterations as ``eicos_tpu.Solver.from_csc``,
    x within 1e-8."""
    args = _csc_args(*_problem(soc))
    ref = jt.Solver.from_csc(*args)
    rcode = ref.solve()
    port = pt.Solver.from_csc(*args, device="cpu")
    code = port.solve()
    assert int(code) == int(rcode) == 0
    assert int(port.get_info().iter) == int(ref.get_info().iter)
    np.testing.assert_allclose(port.solution(), np.asarray(ref.solution()),
                               rtol=0, atol=1e-8)


def test_from_csc_goes_through_init():
    """``from_csc`` builds the object through ``__init__``: under "banded"
    it carries a band plan and the pinned rescue, and the values equal the
    dense constructor's."""
    G, A, c, h, b, q = _problem(soc=False)
    banded = pt.Settings(kkt_strategy="banded")
    s = pt.Solver.from_csc(*_csc_args(G, A, c, h, b, q), settings=banded,
                           rescue=pt.Settings(kkt_strategy="reduced"),
                           device="cpu")
    assert s.structure.band is not None and s.structure.band.bwb >= 1
    assert s.rescue.kkt_strategy == "reduced"
    assert s.rescue.dense_solve == "inverse"
    assert str(s.device) == "cpu"
    d = pt.Solver(G, A, c, h, b, soc_dims=q, settings=banded, device="cpu")
    for f in "GAchb":
        np.testing.assert_array_equal(getattr(s._data, f),
                                      getattr(d._data, f))
    with pytest.raises(ValueError):
        args = list(_csc_args(G, A, c, h, b, q))
        args[3] += 1
        pt.Solver.from_csc(*args, device="cpu")


def _table(out: str):
    lines = out.splitlines()
    head = lines.index(next(x for x in lines if x.startswith("It ")))
    rows = [x for x in lines[head + 1:] if x[:2].strip().isdigit()]
    summary = {x.split(":")[0].strip(): x.split(":", 1)[1].strip()
               for x in lines if x.startswith(("exit:", "iters:"))}
    return lines[head], rows, summary


@pytest.mark.parametrize("soc", [False, True], ids=["lp", "socp"])
def test_verbose_prints_reference_table(soc, capsys):
    """``solve(verbose=True)`` prints the reference's header, as many
    rows, and the same exit and iteration lines of the summary."""
    G, A, c, h, b, q = _problem(soc)
    jt.Solver(G, A, c, h, b, soc_dims=q).solve(verbose=True)
    ref = _table(capsys.readouterr().out)
    pt.Solver(G, A, c, h, b, soc_dims=q, device="cpu").solve(verbose=True)
    out = _table(capsys.readouterr().out)
    assert out[0] == ref[0]
    assert len(out[1]) == len(ref[1]) >= 2
    assert out[2] == ref[2]
    # the columns of every row: iteration, costs, ..., refinement counts
    assert [r.split()[0] for r in out[1]] == [r.split()[0] for r in ref[1]]
    assert [len(r.split()) for r in out[1]] == [len(r.split())
                                                for r in ref[1]]


def test_verbose_false_prints_nothing(capsys):
    G, A, c, h, b, q = _problem(soc=False)
    pt.Solver(G, A, c, h, b, device="cpu").solve()
    assert capsys.readouterr().out == ""


def _assert_same(st_a, data_a, st_b, data_b):
    assert (st_a.n, st_a.p, st_a.m, st_a.l, tuple(st_a.q)) == (
        st_b.n, st_b.p, st_b.m, st_b.l, tuple(st_b.q))
    for f in "GAchb":
        a, b_ = np.asarray(getattr(data_a, f)), np.asarray(getattr(data_b, f))
        assert a.dtype == b_.dtype == np.float64
        np.testing.assert_array_equal(a, b_)


@pytest.mark.parametrize("soc", [False, True], ids=["lp", "socp"])
def test_save_load_roundtrip_and_cross_load(soc, tmp_path):
    """The port's npz round trips exactly, from NumPy arrays and from CPU
    tensors, and each package loads the other's file."""
    import torch

    G, A, c, h, b, q = _problem(soc)
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0],
                                    G.shape[0] - sum(q), q)
    data = problem.make_problem(st, G, A, c, h, b)
    pt.save_problem(str(tmp_path / "port.npz"), st, data)
    st1, data1 = pt.load_problem(str(tmp_path / "port.npz"))
    _assert_same(st, data, st1, data1)

    tdata = pt.ProblemData(**{f: torch.tensor(getattr(data, f))
                              for f in "GAchb"})
    pt.save_problem(str(tmp_path / "tensors.npz"), st, tdata)
    _assert_same(st, data, *pt.load_problem(str(tmp_path / "tensors.npz")))

    jst, jdata = jt.load_problem(str(tmp_path / "port.npz"))
    _assert_same(st, data, jst, jdata)

    jt.save_problem(str(tmp_path / "ref.npz"), jst, jdata)
    _assert_same(st, data, *pt.load_problem(str(tmp_path / "ref.npz")))


def test_verbose_live_raises_on_every_entry_point(capsys):
    """``Settings(verbose_live=True)``, refused until the live table was
    ported, now streams the reference's table on every entry point:
    ``solve``, ``Solver.solve`` and ``BatchedSolver.solve`` print the
    header and lane 0's rows as the iterations end, the same rows as
    ``solve_live``, and return the same bits as a solve without the
    table; a rescue may carry the knob."""
    import io

    import torch

    from eicos_tpu_torch import solver

    G, A, c, h, b, q = _problem(soc=False)
    live = pt.Settings(verbose_live=True)
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0],
                                    G.shape[0], ())
    data = problem.make_problem(st, G, A, c, h, b)
    quiet = pt.solve(st, data, pt.Settings(), device="cpu")
    buf = io.StringIO()
    solver.solve_live(st, data, pt.Settings(), file=buf, device="cpu")
    want = buf.getvalue()
    rows = want.splitlines()
    assert rows[0].startswith("It ") and len(rows) == int(quiet.info.iter) + 2
    capsys.readouterr()
    sol = pt.solve(st, data, live, device="cpu")
    assert capsys.readouterr().out == want
    assert torch.equal(sol.x, quiet.x) and torch.equal(sol.z, quiet.z)
    s = pt.Solver(G, A, c, h, b, settings=live, device="cpu")
    assert s.solve() == pt.ExitCode.OPTIMAL
    assert capsys.readouterr().out == want
    batch = pt.BatchedSolver.stack([data, data], shared=("G", "A", "h"))
    sols = pt.BatchedSolver(st, live, shared=("G", "A", "h"),
                            device="cpu").solve(batch)
    got = capsys.readouterr().out.splitlines()
    # the IR column turns on the last bits (ROADMAP Queue 3)
    assert [r[:-12] for r in got] == [r[:-12] for r in rows]
    assert torch.equal(sols.exit_code, torch.zeros(2, dtype=torch.int32))
    pt.Solver(G, A, c, h, b, rescue=live, device="cpu")


def _lanes(lanes: int = 2, seed: int = 3):
    """``_problem``'s LP as a structure and a batch of ``lanes`` lanes of
    c, with G, A and h shared."""
    G, A, c, h, b, _ = _problem(soc=False, seed=seed)
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0],
                                    G.shape[0], ())
    rng = np.random.default_rng(seed)
    return st, pt.ProblemData(
        G=G, A=A, c=c + 0.01 * rng.standard_normal((lanes, c.size)), h=h,
        b=np.tile(b, (lanes, 1)))


def _paths(spans) -> dict:
    """Each span's names from its root down, by id."""
    by_id = {s["id"]: s for s in spans}

    def path(s):
        return (path(by_id[s["parent"]]) if s["parent"] else ()) + (
            s["name"],)

    return {s["id"]: path(s) for s in spans}


def test_spans_name_each_layer_by_request():
    """A ``BatchedSolver`` with a rescue, solved, then ``update_data`` and
    solved again: the spans nest as the API calls them, every span lies
    inside its parent and carries its request, the ``update_data`` the
    number of the solve it prepares; the counter counts the bytes placed
    from the host (G, A and h once a placement, c and b a lane), nothing
    for a tensor already on the device; ``reset_stats`` empties both."""
    import torch

    from eicos_tpu_torch import graphs

    st, X = _lanes()
    graphs.reset_stats()
    bs = pt.BatchedSolver(st, pt.Settings(iter_max=2, block=16),
                          shared=SHARED, rescue=SMALL, device="cpu")
    assert bs.solve(X).exit_code.tolist() == [0, 0]
    assert bs.last_rescued == (0, 1)
    placed = 8 * sum(np.size(getattr(X, f)) for f in "GAchb")
    assert graphs.STATS["upload_bytes"] == placed
    bs.update_data(c=torch.as_tensor(X.c * 1.01))
    assert graphs.STATS["upload_bytes"] == 2 * placed - 8 * X.c.size
    bs.solve()
    graphs.settle()
    spans = graphs.STATS["spans"]
    paths = _paths(spans)
    solve = ("api.solve",)
    rescue = solve + ("api.rescue",)
    assert set(paths.values()) == {
        solve, solve + ("api.place",), solve + ("program.load",),
        solve + ("program.host_driven",), solve + ("solver.clone",),
        solve + ("api.codes",), rescue, rescue + ("program.load",),
        rescue + ("program.host_driven",), rescue + ("solver.clone",),
        solve + ("api.merge",), ("api.update_data",),
        ("api.update_data", "api.place")}
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        up = by_id.get(s["parent"], s)
        assert up["start"] <= s["start"] <= s["end"] <= up["end"], s
        assert s["request"] == up["request"] > 0, s
    first, second = [s["request"] for s in spans if s["name"] == "api.solve"]
    (update,) = [s for s in spans if s["name"] == "api.update_data"]
    assert 0 < first < second == update["request"]
    graphs.reset_stats()
    graphs.settle()
    assert graphs.STATS["spans"] == [] and graphs.STATS["upload_bytes"] == 0


def test_spans_from_threads_share_one_ring():
    """Two threads, each solving its own batch, and a solve sharded over
    a mesh of two CPU devices (a host thread a shard): every span lands
    in the one ring, each thread's under its own request, and the shards'
    spans nest in the solve that started them."""
    import threading

    import torch

    from eicos_tpu_torch import graphs

    st, X = _lanes()
    graphs.reset_stats()

    def run():
        pt.BatchedSolver(st, SMALL, shared=SHARED, device="cpu").solve(X)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    mesh = pt.BatchedSolver(st, SMALL, shared=SHARED,
                            mesh=[torch.device("cpu")] * 2)
    mesh.solve(X)
    graphs.settle()
    spans = graphs.STATS["spans"]
    paths = _paths(spans)
    roots = [s for s in spans if s["name"] == "api.solve"]
    assert len(roots) == 3 and len({s["request"] for s in roots}) == 3
    for root in roots:
        mine = [s for s in spans if s["request"] == root["request"]]
        assert all(paths[s["id"]][0] == "api.solve" for s in mine)
    sharded = [s for s in spans if s["request"] == roots[-1]["request"]
               and s["name"] == "program.host_driven"]
    assert len(sharded) == 2 and graphs.STATS["spans_dropped"] == 0
