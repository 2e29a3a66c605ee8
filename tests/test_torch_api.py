"""The port's API surface against the JAX package on the CPU:
``Solver.from_csc`` (the reference's argument order), ``solve(verbose=True)``
(the iteration table and summary), ``save_problem``/``load_problem`` (the
npz round trip, cross-loaded between the packages) and
``Settings(verbose_live=True)``, which the port refuses on every entry
point.  Inputs come from a numpy seed."""

import numpy as np
import pytest
import scipy.sparse as sp

import eicos_tpu as jt

import eicos_tpu_torch as pt
from eicos_tpu_torch import problem


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


def test_verbose_live_raises_on_every_entry_point():
    """The live table is not ported: the knob is refused, not ignored."""
    G, A, c, h, b, q = _problem(soc=False)
    live = pt.Settings(verbose_live=True)
    with pytest.raises(NotImplementedError, match="verbose_live"):
        pt.Solver(G, A, c, h, b, settings=live, device="cpu").solve()
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0],
                                    G.shape[0], ())
    data = problem.make_problem(st, G, A, c, h, b)
    with pytest.raises(NotImplementedError, match="verbose_live"):
        pt.solve(st, data, live, device="cpu")
    batch = pt.BatchedSolver.stack([data, data], shared=("G", "A", "h"))
    with pytest.raises(NotImplementedError, match="verbose_live"):
        pt.BatchedSolver(st, live, shared=("G", "A", "h"),
                         device="cpu").solve(batch)
    with pytest.raises(NotImplementedError, match="verbose_live"):
        pt.Solver(G, A, c, h, b, rescue=live, device="cpu")
