"""The port stands alone: importing it loads neither JAX nor eicos_tpu, its
sources import neither, and its entry points run on CUDA unless asked for
the CPU.  The configurations that once raised solve as the JAX package
solves them."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import eicos_tpu_torch as pt
from eicos_tpu_torch import corpus
from eicos_tpu_torch.plan import make_band_plan

PKG = pathlib.Path(pt.__file__).resolve().parent
MODULES = sorted(
    "eicos_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_import_loads_no_jax():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'eicos_tpu' "
            "or m.startswith('eicos_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=PKG.parent).stdout
    assert out.strip() == "[]"


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|eicos_tpu)(\.|\s|$)", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


@pytest.fixture
def lp():
    st, data = corpus.make_mpc_like(horizon=4, nx=2, nu=2, seed=1)
    st = st.with_gsplit(data.G, data.A)
    st = st.with_band_plan(make_band_plan(st, data.G, data.A))
    return st, data


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_batched_solver_needs_cuda_by_default(lp, no_cuda):
    st, _ = lp
    with pytest.raises(RuntimeError):
        pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"))


def test_solver_needs_cuda_by_default(lp, no_cuda):
    _, d = lp
    with pytest.raises(RuntimeError):
        pt.Solver(d.G, d.A, d.c, d.h, d.b,
                  settings=pt.Settings(kkt_strategy="banded"))


def test_solve_needs_cuda_by_default(lp, no_cuda):
    st, d = lp
    with pytest.raises(RuntimeError):
        pt.solve(st, d, pt.Settings(kkt_strategy="banded"))


def test_rescue_is_next_slice(lp):
    """The rescue, once the next slice, is ported: a rescue left at
    ``dense_solve="auto"`` is pinned to the inverse path and an explicit
    "subst" is kept, as ``eicos_tpu.api._rescue_settings`` does."""
    from eicos_tpu_torch.api import _rescue_settings

    st, _ = lp
    assert _rescue_settings(None) is None
    r = _rescue_settings(pt.Settings(kkt_strategy="reduced"))
    assert r.dense_solve == "inverse" and r.kkt_strategy == "reduced"
    assert _rescue_settings(pt.Settings(dense_solve="subst")).dense_solve \
        == "subst"
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          rescue=pt.Settings(kkt_strategy="reduced"),
                          device="cpu")
    assert bs.rescue == r and bs.last_rescued == ()


@pytest.mark.parametrize("case", ["float32", "bwb7", "block64"])
def test_unported_configurations_raise(lp, case):
    """The three configurations that raised until they were ported solve
    as the JAX package solves them: a block size of 64 under "reduced"
    (the plain leaf, as the JAX package runs it off 128) with the same
    exit code (OPTIMAL) and iteration count and the objective within 1e-8
    relative; a plan at block bandwidth above 6 (the LP's plan declared at
    7) likewise; an f32 factor under "banded", on a small SOCP under a
    keep_soc plan (an LP's RCM order puts -delta pivots early, which an
    f32 factor does not survive: ROADMAP Queue 3), with the same exit
    code and iteration count and the objective within 1e-6."""
    import dataclasses

    import eicos_tpu as jt
    from eicos_tpu import corpus as jcorpus
    from eicos_tpu.plan import make_band_plan as jplan

    from eicos_tpu_torch import problem
    from eicos_tpu_torch.api import _code_rank

    st, d = lp
    if case == "block64":
        jst, jd = jcorpus.make_mpc_like(horizon=4, nx=2, nu=2, seed=1)
        jst = jst.with_gsplit(jd.G, jd.A)
        cfg = dict(kkt_strategy="reduced", block=64)
        ref = jt.solve(jst, jd, jt.Settings(**cfg))
        sol = pt.solve(st, d, pt.Settings(**cfg), device="cpu")
        assert int(sol.exit_code) == int(ref.exit_code) == 0
        assert int(sol.info.iter) == int(ref.info.iter)
        want = float(ref.info.pcost)
        assert abs(float(sol.info.pcost) - want) <= 1e-8 * abs(want)
        return
    f32 = case == "float32"
    make = jcorpus.make_mpc_soc if f32 else jcorpus.make_mpc_like
    jst, jd = make(horizon=4, nx=2, nu=2, seed=2 if f32 else 1)
    jst = jst.with_gsplit(jd.G, jd.A)
    plan = jplan(jst, jd.G, jd.A, keep_soc=f32)
    cfg = dict(kkt_strategy="banded")
    if f32:
        cfg["factor_dtype"] = "float32"
    else:
        plan = dataclasses.replace(plan, bwb=7)
    jst = jst.with_band_plan(plan)
    st, pd = problem.from_reference(problem.structure_fields(jst), jd.G,
                                    jd.A, jd.c, jd.h, jd.b)
    assert st.band.bwb == plan.bwb
    ref = jt.solve(jst, jd, jt.Settings(**cfg))
    sol = pt.solve(st, pd, pt.Settings(**cfg), device="cpu")
    assert int(sol.exit_code) == int(ref.exit_code)
    assert int(sol.info.iter) == int(ref.info.iter)
    assert _code_rank(int(ref.exit_code)) > 0
    if not f32:
        assert int(sol.exit_code) == 0
    want = float(ref.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= (1e-6 if f32 else 1e-8
                                                  ) * abs(want)


@pytest.mark.parametrize("case", ["full", "normal", "subst", "float32"])
def test_dense_configurations_solve(case):
    """The dense configurations that raised before they were ported solve
    as the JAX package solves them: "full" (the default ``Settings()``),
    "normal", "reduced" on the substitution sweeps and "reduced" with an
    f32 factor: the same exit code and iteration count, the objective
    within 1e-8 relative; under the f32 factor, whose late iterations turn
    on the last bits, the same exit tier and the objective at 1e-6."""
    import eicos_tpu as jt
    from eicos_tpu import corpus as jcorpus

    from eicos_tpu_torch import problem
    from eicos_tpu_torch.api import _code_rank

    cfg = {"full": {}, "normal": dict(kkt_strategy="normal"),
           "subst": dict(kkt_strategy="reduced", dense_solve="subst"),
           "float32": dict(kkt_strategy="reduced",
                           factor_dtype="float32")}[case]
    jst, d = jcorpus.make_mpc_like(horizon=4, nx=2, nu=2,
                                   seed=2 if case == "float32" else 1)
    if case != "full":
        jst = jst.with_gsplit(d.G, d.A)
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    ref = jt.solve(jst, d, jt.Settings(**cfg))
    sol = pt.solve(st, pd, pt.Settings(**cfg), device="cpu")
    want = float(ref.info.pcost)
    assert int(ref.exit_code) == 0
    if case == "float32":
        assert _code_rank(int(sol.exit_code)) == 2
        assert abs(float(sol.info.pcost) - want) <= 1e-6 * abs(want)
        return
    assert int(sol.exit_code) == 0
    assert int(sol.info.iter) == int(ref.info.iter)
    assert abs(float(sol.info.pcost) - want) <= 1e-8 * abs(want)


def test_solver_default_settings_on_cpu(lp):
    """``Solver(G, A, c, h, b, device="cpu").solve()`` at the default
    ``Settings()`` ("full") returns OPTIMAL, with the objective of the
    banded solve of the same problem."""
    st, d = lp
    s = pt.Solver(d.G, d.A, d.c, d.h, d.b, device="cpu")
    assert s.get_settings().kkt_strategy == "full"
    assert s.solve() == pt.ExitCode.OPTIMAL
    banded = pt.solve(st, d, pt.Settings(kkt_strategy="banded"), device="cpu")
    want = float(banded.info.pcost)
    assert abs(float(s.get_info().pcost) - want) <= 1e-7 * abs(want)


def _reference_case(case):
    """The JAX package's structure and data of a configuration, and the
    same carried into the port: the narrow MPC LP under a plan declared at
    block bandwidth 2 (the wide kernels' layout; the second sub-diagonal
    holds zeros) or with one dense LP row in its gsplit, and the
    SOC-constrained MPC problem under a plain plan (the cones are
    eliminated) or a keep_soc plan."""
    import dataclasses

    import eicos_tpu as jt
    from eicos_tpu import corpus as jcorpus
    from eicos_tpu.plan import make_band_plan as jplan

    from eicos_tpu_torch import problem

    if case in ("soc", "keep_soc"):
        jst, d = jcorpus.make_mpc_soc(horizon=4, nx=2, nu=2, seed=1)
    else:
        jst, d = jcorpus.make_mpc_like(horizon=4, nx=2, nu=2, seed=1)
    if case == "dense_rows":
        G = np.vstack([np.asarray(d.G), np.zeros((1, jst.n))])
        G[-1, :6] = 0.3
        d = jt.ProblemData(G=G, A=d.A, c=d.c,
                           h=np.concatenate([np.asarray(d.h), [50.0]]),
                           b=d.b)
        jst = jt.ProblemStructure.create(jst.n, jst.p, jst.m + 1, jst.l + 1)
    jst = jst.with_gsplit(d.G, d.A)
    plan = jplan(jst, d.G, d.A, keep_soc=case == "keep_soc")
    if case == "bwb2":
        plan = dataclasses.replace(plan, bwb=2)
    jst = jst.with_band_plan(plan)
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    return jst, d, st, pd


@pytest.mark.parametrize("case", ["bwb2", "dense_rows", "soc"])
def test_ported_configurations_solve(case):
    """The configurations that raised before the banded strategy was whole
    now solve as the JAX package solves them under "banded": the same exit
    code and iteration count, the objective within 1e-8 relative.  Both
    packages factor the same matrix in each.  Eliminating the cones of the
    last case squares their conditioning, so whatever code the JAX package
    ends at there is the code to match (the keep_soc plan is the accurate
    layout)."""
    import eicos_tpu as jt

    jst, d, st, pd = _reference_case(case)
    if case == "dense_rows":
        assert st.gsplit.dense_rows
    assert st.band.bwb == (2 if case == "bwb2" else 1)
    ref = jt.solve(jst, d, jt.Settings(kkt_strategy="banded"))
    sol = pt.solve(st, pd, pt.Settings(kkt_strategy="banded"), device="cpu")
    assert int(sol.exit_code) == int(ref.exit_code)
    assert int(sol.info.iter) == int(ref.info.iter)
    want = float(ref.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-8 * abs(want)
    if case != "soc":
        assert int(sol.exit_code) == 0


def test_keep_soc_plan_is_next_slice():
    """The keep_soc plan, once the next slice, is ported: it covers
    [z_soc | x | y] and a SOCP solves under it.  On the CPU the JAX package
    factors the unscaled kept K where the port factors the NT-scaled one,
    so iteration counts are not compared: the port's exit tier is no worse
    than that of the JAX package's "banded" solve, and its objective is
    within 1e-7 relative of the JAX package's "reduced" solve."""
    import eicos_tpu as jt

    from eicos_tpu_torch.api import _code_rank

    jst, d, st, pd = _reference_case("keep_soc")
    assert st.band.keep_soc and st.band.dim >= st.cone.ms + st.n + st.p
    ref = jt.solve(jst, d, jt.Settings(kkt_strategy="banded"))
    red = jt.solve(jst, d, jt.Settings(kkt_strategy="reduced"))
    sol = pt.solve(st, pd, pt.Settings(kkt_strategy="banded"), device="cpu")
    assert int(red.exit_code) == 0
    assert _code_rank(int(sol.exit_code)) >= _code_rank(int(ref.exit_code))
    want = float(red.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-7 * abs(want)


def test_settings_validate_like_reference():
    with pytest.raises(ValueError):
        pt.Settings(kkt_strategy="banded ")
    assert pt.Settings(chunk_store="i8", pallas_leaf="off").block == 128
    assert np.isclose(pt.Settings().deltastat, 7e-8)


def test_reference_dir_follows_the_variable(tmp_path):
    """Both packages read the corpus headers from ``EICOS_REFERENCE_TESTS``
    when it is set.  Without it each has its own default: the JAX
    package a fixed absolute path, the port ``reference/test`` inside its
    checkout."""
    code = ("import eicos_tpu.corpus as j, eicos_tpu_torch.corpus as p\n"
            "print(j.REFERENCE_TEST_DIR)\nprint(p.REFERENCE_TEST_DIR)\n")
    env = dict(os.environ, EICOS_REFERENCE_TESTS=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=env,
                         cwd=PKG.parent).stdout.split("\n")
    assert out[0] == out[1] == str(tmp_path)
    env.pop("EICOS_REFERENCE_TESTS")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=env,
                         cwd=PKG.parent).stdout.split("\n")
    assert out[1] == str(PKG.parent / "reference" / "test")
