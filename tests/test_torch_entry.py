"""The port's remaining entry points on the CPU against the JAX package:
the live iteration table (``solve_live``, ``Settings(verbose_live=True)``),
``utils/timing``, the corpus header parser and the CSC helpers of
``native``, the corpus loader, the ECOS shim and the command line.  Inputs
come from a numpy seed or from files the tests write; a test of a real
corpus problem skips where the reference's test headers are absent."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import io
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import eicos_tpu as jt
from eicos_tpu import __main__ as jmain
from eicos_tpu import corpus as jcorpus
from eicos_tpu import ecos_compat as jecos
from eicos_tpu import native as jnative
from eicos_tpu import solver as jsolver
from eicos_tpu.utils import timing as jtiming

import eicos_tpu_torch as pt
from eicos_tpu_torch import __main__ as pmain
from eicos_tpu_torch import corpus, ecos_compat, native, problem, solver
from eicos_tpu_torch.utils import timing

REDUCED = dict(kkt_strategy="reduced")


def lp():
    """The small MPC LP in both packages (gsplit on)."""
    jst, d = jcorpus.make_mpc_like(horizon=4, nx=2, nu=2, seed=1)
    jst = jst.with_gsplit(d.G, d.A)
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    return jst, d, st, pd


def socp(seed=5):
    """A small feasible SOCP: a box, two equalities and one cone
    ||(x0, x1)|| <= 1.5.  Returns G, A, c, h, b, q."""
    rng = np.random.default_rng(seed)
    n, p = 6, 2
    G = np.vstack([np.eye(n), -np.eye(n), np.zeros((3, n))])
    G[-2, 0] = G[-1, 1] = -1.0
    h = np.concatenate([np.ones(2 * n), [1.5, 0.0, 0.0]])
    A = rng.standard_normal((p, n))
    b = A @ (0.3 * rng.uniform(-1, 1, n))
    c = rng.standard_normal(n)
    return G, A, c, h, b, (3,)


def strip_ir(lines):
    """Table rows without their IR column, which turns on the last bits
    (ROADMAP Queue 3)."""
    return [r[:-12] if r[:3].strip().isdigit() else r for r in lines]


# ------------------------------------------------------------- live table

def test_solve_live_matches_reference():
    """``solver.solve_live`` at ``seg=3``: the header and one row per
    iteration, the JAX package's ``solve_live`` rows, and the same bits as
    ``solve``."""
    jst, d, st, pd = lp()
    jbuf, buf = io.StringIO(), io.StringIO()
    ref = jsolver.solve_live(jst, d, jt.Settings(**REDUCED), seg=3,
                             file=jbuf)
    got = solver.solve_live(st, pd, pt.Settings(**REDUCED), seg=3, file=buf,
                            device="cpu")
    plain = pt.solve(st, pd, pt.Settings(**REDUCED), device="cpu")
    rows = buf.getvalue().splitlines()
    assert len(rows) == int(got.info.iter) + 2 == int(ref.info.iter) + 2
    assert strip_ir(rows) == strip_ir(jbuf.getvalue().splitlines())
    assert int(got.exit_code) == int(ref.exit_code) == 0
    for f in ("x", "y", "z", "s"):
        assert torch.equal(getattr(got, f), getattr(plain, f))


def test_verbose_live_rows_match_reference(capsys):
    """``Settings(verbose_live=True)`` on one problem streams the rows that
    the JAX package's live callback prints; on a batch of three it streams
    lane 0's rows, those of lane 0 solved alone."""
    jst, d, st, pd = lp()
    cfg = dict(REDUCED, verbose_live=True)
    jt.solve(jst, d, jt.Settings(**cfg))
    jax.effects_barrier()
    want = capsys.readouterr().out.splitlines()
    one = pt.solve(st, pd, pt.Settings(**cfg), device="cpu")
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == int(one.info.iter) + 2
    assert strip_ir(rows) == strip_ir(want)
    rng = np.random.default_rng(3)
    lanes = [pd] + [pt.ProblemData(G=pd.G, A=pd.A,
                                   c=pd.c + 0.02 * rng.standard_normal(st.n),
                                   h=pd.h, b=pd.b) for _ in range(2)]
    shared = ("G", "A", "h", "b")
    pt.BatchedSolver(st, pt.Settings(**cfg), shared=shared,
                     device="cpu").solve(pt.BatchedSolver.stack(lanes,
                                                                shared))
    assert strip_ir(capsys.readouterr().out.splitlines()) == strip_ir(rows)


def test_solver_solve_live_method():
    """``Solver.solve_live`` prints the table, then the summary, and keeps
    the solution of ``solve()`` (the JAX package's method's rows)."""
    G, A, c, h, b, q = socp()
    buf, jbuf = io.StringIO(), io.StringIO()
    s = pt.Solver(G, A, c, h, b, soc_dims=q, device="cpu")
    code = s.solve_live(seg=2, file=buf)
    x_live = s.solution()
    assert s.solve() == code == pt.ExitCode.OPTIMAL
    np.testing.assert_array_equal(s.solution(), x_live)
    js = jt.Solver(G, A, c, h, b, soc_dims=q)
    assert int(js.solve_live(seg=2, file=jbuf)) == int(code)
    out, jout = buf.getvalue().splitlines(), jbuf.getvalue().splitlines()
    n_rows = int(s.get_info().iter) + 2
    assert strip_ir(out[:n_rows]) == strip_ir(jout[:n_rows])
    assert "exit:   OPTIMAL (0)" in out


# ----------------------------------------------------------------- timing

def test_timing_matches_reference():
    """``tic``/``toc`` in milliseconds, and ``timed`` returning (result,
    ms), as the JAX package's; ``profiler_trace`` writes a Chrome trace."""
    t0, j0 = timing.tic(), jtiming.tic()
    assert timing.toc(t0) >= 0.0 and jtiming.toc(j0) >= 0.0
    out, ms = timing.timed(lambda a, k: (a * k, [a + k]), torch.ones(3),
                           k=2.0)
    jout, jms = jtiming.timed(lambda a, k: (a * k, [a + k]),
                              jax.numpy.ones(3), k=2.0)
    assert ms >= 0.0 and jms >= 0.0
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(out[1][0].numpy(), np.asarray(jout[1][0]))
    assert timing.timed(lambda: 7)[0] == 7


def test_profiler_trace_writes(tmp_path):
    with timing.profiler_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# ----------------------------------------------------- headers and native

HEADER = """/* a test problem in the reference's header layout */
#include "ecos.h"
idxint tp_n = 3;
idxint tp_m = 4;
idxint tp_p = 1;
idxint tp_l = 4;
idxint tp_ncones = 0;
pfloat tp_optval = -1.25e+00;
pfloat tp_c[3] = {-1.0, -0.5,
  2.5e-1};
pfloat tp_h[4] = {1, 1, .5, 7e-1};
idxint tp_Gjc[4] = {0, 2, 3, 4};
idxint tp_Gir[4] = {0, 2, 1, 3};
pfloat tp_Gpr[4] = {1.0, -1.0, 1.0, -0.125E+1};
idxint tp_Ajc[4] = {0, 1, 2, 3};
idxint tp_Air[3] = {0, 0, 0};
pfloat tp_Apr[3] = {1.0, 1.0, 1.0};
pfloat tp_b[1] = {1.0};
static pfloat tp_scratch[] = { -3.5, 4 };
pfloat *tp_q = NULL;
"""


def _same_dicts(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v and type(got[k]) is type(v)


def test_parse_header_matches_reference(tmp_path, monkeypatch):
    """``parse_header`` on a header written here, dict for dict with
    ``eicos_tpu.corpus.parse_header``, on the path that is live (the
    native scanner where the library builds) and on the regex fallback."""
    path = tmp_path / "tp.h"
    path.write_text(HEADER)
    want = jcorpus.parse_header(str(path))
    _same_dicts(corpus.parse_header(str(path)), want)
    assert want["tp_q"] is None and want["tp_n"] == 3
    monkeypatch.setattr(native, "_try_load", lambda: None)
    _same_dicts(corpus.parse_header(str(path)), want)


def test_parse_numbers_matches_reference(monkeypatch):
    text = b"x[] = {1.0, -2.5e3,\n 4, .5, 7e-2, -0.125E+1};"
    pos = text.index(b"{") + 1
    vals, end = native.parse_numbers(text, pos)
    jvals, jend = jnative.parse_numbers(text, pos)
    np.testing.assert_array_equal(vals, jvals)
    assert end == jend and text[end:end + 1] == b"}"
    monkeypatch.setattr(native, "_try_load", lambda: None)
    fvals, fend = native.parse_numbers(text.decode(), pos)
    np.testing.assert_array_equal(fvals, jvals)
    assert fend == end


def test_csc_helpers_match_reference():
    M = sp.random(37, 23, density=0.17, random_state=5, format="csc")
    dense = native.csc_to_dense(37, 23, M.data, M.indptr, M.indices)
    np.testing.assert_array_equal(
        dense, jnative.csc_to_dense(37, 23, M.data, M.indptr, M.indices))
    np.testing.assert_array_equal(dense, M.toarray())
    vals = native.dense_to_csc_values(dense, M.indptr, M.indices)
    np.testing.assert_array_equal(
        vals, jnative.dense_to_csc_values(dense, M.indptr, M.indices))
    np.testing.assert_array_equal(vals, M.data)
    np.testing.assert_array_equal(native.csc_to_dense(4, 3, None, None, None),
                                  np.zeros((4, 3)))


def test_load_matches_reference(tmp_path, monkeypatch):
    """``load`` of a registered problem from a corpus directory written
    here (the ``feas`` entry's names) and ``load_update_data`` give the
    JAX package's structure, data and expected codes; an absent header
    raises ``FileNotFoundError`` naming its path."""
    (tmp_path / "feasibilityProblems").mkdir()
    (tmp_path / "feasibilityProblems" / "feas.h").write_text(
        "pfloat feas_Gx[2] = {1.0, -1.0};\nidxint feas_Gp[2] = {0, 2};\n"
        "idxint feas_Gi[2] = {0, 1};\npfloat feas_c[1] = {0.0};\n"
        "pfloat feas_h[2] = {2.0, -1.0};\npfloat *feas_Apr = NULL;\n"
        "pfloat *feas_b = NULL;\n")
    (tmp_path / "updateData").mkdir()
    (tmp_path / "updateData" / "update_data.h").write_text(
        "idxint udd_n = 2;\nidxint udd_m = 2;\nidxint udd_p = 1;\n"
        "idxint udd_l = 2;\nidxint udd_Gjc[3] = {0, 1, 2};\n"
        "idxint udd_Gir[2] = {0, 1};\nidxint udd_Ajc[3] = {0, 1, 2};\n"
        "idxint udd_Air[2] = {0, 0};\npfloat udd_optval1 = 1.0;\n"
        "pfloat udd_optval2 = 2.0;\n"
        + "".join(f"pfloat udd_G{k}pr[2] = {{-1.0, -{k}.5}};\n"
                  f"pfloat udd_A{k}pr[2] = {{1.0, {k}.0}};\n"
                  f"pfloat udd_c{k}[2] = {{1.0, {k}.0}};\n"
                  f"pfloat udd_h{k}[2] = {{0.0, 0.0}};\n"
                  f"pfloat udd_b{k}[1] = {{{k}.0}};\n" for k in (1, 2)))
    for mod in (corpus, jcorpus):
        monkeypatch.setattr(mod, "REFERENCE_TEST_DIR", str(tmp_path))
        mod.load.cache_clear()
        mod.load_update_data.cache_clear()
    try:
        st, data, expected = corpus.load("feas")
        jst, jdata, jexpected = jcorpus.load("feas")
        assert (st.n, st.p, st.m, st.l, st.q) == (jst.n, jst.p, jst.m,
                                                  jst.l, jst.q)
        assert expected == jexpected == (pt.ExitCode.OPTIMAL,)
        for f in "GAchb":
            np.testing.assert_array_equal(getattr(data, f),
                                          np.asarray(getattr(jdata, f)))
        got, want = corpus.load_update_data(), jcorpus.load_update_data()
        assert got[0].n == want[0].n and got[3:] == want[3:]
        for a, b in zip(got[1:3], want[1:3]):
            for f in "GAchb":
                np.testing.assert_array_equal(getattr(a, f),
                                              np.asarray(getattr(b, f)))
        with pytest.raises(FileNotFoundError, match="infeasible1.h"):
            corpus.load("infeasible1")
        with pytest.raises(KeyError):
            corpus.load("no_such_problem")
    finally:
        for mod in (corpus, jcorpus):
            mod.load.cache_clear()
            mod.load_update_data.cache_clear()


def test_reference_corpus_loads_alike(monkeypatch):
    """Where the reference's test headers exist: every registered problem
    but the three largest whose header is there loads to the JAX package's
    structure and data, both packages reading the same directory."""
    names = [e.name for e in corpus.CORPUS
             if e.name not in ("MPC02", "lp_bnl1", "lp_25fv47")
             and os.path.isfile(os.path.join(corpus.REFERENCE_TEST_DIR,
                                             e.file))]
    if not names:
        pytest.skip(f"no reference test headers at "
                    f"{corpus.REFERENCE_TEST_DIR}")
    monkeypatch.setattr(jcorpus, "REFERENCE_TEST_DIR",
                        corpus.REFERENCE_TEST_DIR)
    jcorpus.load.cache_clear()
    try:
        for name in names:
            e = next(e for e in corpus.CORPUS if e.name == name)
            st, data, expected = corpus.load(e.name)
            jst, jdata, jexpected = jcorpus.load(e.name)
            assert (st.n, st.p, st.m, st.l, st.q) == (jst.n, jst.p, jst.m,
                                                      jst.l, jst.q)
            assert expected == jexpected
            for f in "GAchb":
                np.testing.assert_array_equal(getattr(data, f),
                                              np.asarray(getattr(jdata, f)))
    finally:
        jcorpus.load.cache_clear()


# --------------------------------------------------------------- ECOS shim

def _csc_args(G, A, c, h, b, q):
    Gs, As = sp.csc_matrix(G), sp.csc_matrix(A)
    m, n = G.shape
    return (n, m, A.shape[0], m - sum(q), len(q), np.array(q, np.int64), 0,
            Gs.data, Gs.indptr, Gs.indices, As.data, As.indptr, As.indices,
            c, h, b)


def test_ecos_shim_matches_reference():
    """setup, solve, update (new c; new G values with h) and re-solve,
    cleanup, and ``solve_ecos`` with scipy.sparse inputs: the JAX shim's
    exit codes, x within 1e-8."""
    G, A, c, h, b, q = socp()
    args = _csc_args(G, A, c, h, b, q)
    work = ecos_compat.ecos_setup(*args, device="cpu")
    jwork = jecos.ecos_setup(*args)
    assert ecos_compat.ecos_solve(work) == jecos.ecos_solve(jwork) == \
        ecos_compat.ECOS_OPTIMAL
    np.testing.assert_allclose(work.solution(), np.asarray(jwork.solution()),
                               rtol=0, atol=1e-8)
    c2 = c + 0.1
    Gpr2 = sp.csc_matrix(G).data * 1.1
    for w, mod in ((work, ecos_compat), (jwork, jecos)):
        mod.ecos_update_data(w, c=c2)
        mod.ecos_update_data(w, Gpr=Gpr2, h=h * 1.05)
    code, jcode = ecos_compat.ecos_solve(work), jecos.ecos_solve(jwork)
    assert code == jcode
    np.testing.assert_allclose(work.solution(), np.asarray(jwork.solution()),
                               rtol=0, atol=1e-8)
    ecos_compat.ecos_cleanup(work)
    dims = {"l": G.shape[0] - 3, "q": [3]}
    r = ecos_compat.solve_ecos(c, sp.csc_matrix(G), h, dims, sp.csc_matrix(A),
                               b, device="cpu")
    jr = jecos.solve_ecos(c, sp.csc_matrix(G), h, dims, sp.csc_matrix(A), b)
    assert r["exitFlag"] == jr["exitFlag"] == 0
    for f in ("x", "y", "z", "s"):
        assert isinstance(r[f], np.ndarray)
        np.testing.assert_allclose(r[f], np.asarray(jr[f]), rtol=0,
                                   atol=1e-8)
    assert (ecos_compat.ECOS_NUMERICS, ecos_compat.ECOS_FATAL) == (
        jecos.ECOS_NUMERICS, jecos.ECOS_FATAL)


# ------------------------------------------------------------ command line

def _summary(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("exit:", "iters:", "pcost:"))]


def test_cli_solve_matches_reference(tmp_path, capsys):
    """``solve`` (with --verbose) and ``solve --live`` on an .npz written
    with ``save_problem``: the JAX CLI's summary lines, the table streamed
    before the summary."""
    jst, d, st, pd = lp()
    path = str(tmp_path / "lp.npz")
    pt.save_problem(path, st, pd)
    assert pmain.main(["solve", path, "--verbose", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert jmain.main(["solve", path, "--verbose"]) == 0
    jout = capsys.readouterr().out
    assert "OPTIMAL" in out and _summary(out) == _summary(jout)
    assert pmain.main(["solve", path, "--live", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.index("It ") < out.index("Problem summary")
    assert _summary(out) == _summary(jout)


def test_cli_demo_matches_reference(capsys, monkeypatch):
    """``demo`` runs setup, solve, update_data, re-solve and a batch to
    exit 0 with the iteration counts of ``examples/run_demo.py``, run as a
    script (the JAX package's ``demo`` subcommand executes it without a
    ``__file__`` and raises NameError: ROADMAP Queue 3)."""
    assert pmain.main(["demo", "--horizon", "6", "--batch", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    demo = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "run_demo.py")
    monkeypatch.setattr(sys, "argv", [demo, "--horizon", "6"])
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(demo, run_name="__main__")
    jout = capsys.readouterr().out

    def iters(text):
        return [ln.split("->")[1].strip() for ln in text.splitlines()
                if "->" in ln]

    assert iters(out) == iters(jout) and len(iters(out)) == 2
    assert "Batch of 2:" in out and "2 optimal" in out


def test_cli_corpus_without_headers(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(corpus, "REFERENCE_TEST_DIR", str(tmp_path / "none"))
    assert pmain.main(["corpus", "--device", "cpu"]) != 0
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and str(tmp_path / "none") in err
