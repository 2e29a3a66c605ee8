"""The port stands alone: importing it loads neither JAX nor eicos_tpu, its
sources import neither, and its entry points run on CUDA unless asked for
the CPU."""

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


@pytest.mark.parametrize("case", ["full", "normal", "float32", "bwb2",
                                  "dense_rows", "soc", "subst"])
def test_unported_configurations_raise(lp, case):
    """Each structure or setting the slice does not cover raises
    NotImplementedError naming its slice; nothing falls back."""
    import dataclasses

    st, d = lp
    settings = pt.Settings(kkt_strategy="banded")
    if case in ("full", "normal"):
        settings = pt.Settings(kkt_strategy=case)
    elif case == "subst":
        settings = pt.Settings(kkt_strategy="reduced", dense_solve="subst")
    elif case == "float32":
        settings = pt.Settings(kkt_strategy="banded", factor_dtype="float32")
    elif case == "bwb2":
        st = dataclasses.replace(st, band=dataclasses.replace(st.band,
                                                              bwb=2))
    elif case == "dense_rows":
        st = dataclasses.replace(st, gsplit=dataclasses.replace(
            st.gsplit, dense_rows=(0,)))
    elif case == "soc":
        st, d = corpus.make_mpc_soc(horizon=4, nx=2, nu=2, seed=1)
        st = st.with_gsplit(d.G, d.A)
        st = st.with_band_plan(make_band_plan(st, d.G, d.A))
    with pytest.raises(NotImplementedError):
        pt.solve(st, d, settings, device="cpu")


def test_keep_soc_plan_is_next_slice():
    st, d = corpus.make_mpc_soc(horizon=4, nx=2, nu=2, seed=1)
    with pytest.raises(NotImplementedError):
        make_band_plan(st, d.G, d.A, keep_soc=True)


def test_settings_validate_like_reference():
    with pytest.raises(ValueError):
        pt.Settings(kkt_strategy="banded ")
    assert pt.Settings(chunk_store="i8", pallas_leaf="off").block == 128
    assert np.isclose(pt.Settings().deltastat, 7e-8)
