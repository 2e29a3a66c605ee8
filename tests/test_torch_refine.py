"""The card path's refinement on the CPU: with ``kkt._sliced_live`` forced
on, the port builds the operands of ``kkt.make_sliced`` from CPU tensors
(the plain gather and ``torch.matmul``) and refines in the JAX package's
rotated TPU loop.  Held against the JAX package with its own TPU gate
(``gemv_ds_available``) forced on, against the port's residual-first loop,
and counted: one corrective solve and one host sync fewer per refined
solve."""

import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import corpus as jcorpus
from eicos_tpu.ops import pallas_gemm_ds
from eicos_tpu.plan import make_band_plan as jplan

import eicos_tpu_torch as pt
from eicos_tpu_torch import corpus, kkt
from eicos_tpu_torch.ops import spmv
from eicos_tpu_torch.plan import make_band_plan
from eicos_tpu_torch.structure import ProblemStructure


def lp(banded: bool):
    st, d = corpus.make_mpc_like(8, 2, 3, seed=1)
    st = st.with_gsplit(d.G, d.A)
    if banded:
        st = st.with_band_plan(make_band_plan(st, d.G, d.A))
    return st, d


def counted_solve(monkeypatch, st, data, settings, live: bool):
    """Solve with the gate ``live`` and count the corrective solves (calls
    of every ``solve_exact``), the refined solves that have a lane to
    refine (their starts, ``kkt.refine_start``), and the host syncs."""
    counts = dict(solves=0, refined=0)
    real_factor, real_refined = kkt.factor, kkt.refine_start

    def factor(*args, **kw):
        solve_exact = real_factor(*args, **kw)

        def counted(rhs):
            counts["solves"] += 1
            return solve_exact(rhs)
        return counted

    def refined(*args, **kw):
        active = args[6] if len(args) > 6 else kw.get("active")
        counts["refined"] += int(active is None or bool(active.any()))
        return real_refined(*args, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(kkt, "factor", factor)
        mp.setattr(kkt, "refine_start", refined)
        if live:
            mp.setattr(kkt, "_sliced_live", lambda G: True)
        syncs0 = kkt.host_syncs
        sol = pt.solve(st, data, settings, device="cpu")
        counts["syncs"] = kkt.host_syncs - syncs0
    return sol, counts


def test_banded_operand_path_matches_jax(monkeypatch):
    """A banded solve of ``make_mpc_like(8, 2, 3, seed=1)`` (gsplit, RCM
    plan) on the operand path, every operand a gather, against the JAX
    package on its TPU path's operands and rotated loop (no Pallas call is
    reached there: every operand is a ``SparseOperand``): the same exit
    code and iteration count, objectives within 1e-10 relative."""
    monkeypatch.setattr(pallas_gemm_ds, "gemv_ds_available", lambda: True)
    jst, jd = jcorpus.make_mpc_like(8, 2, 3, seed=1)
    jst = jst.with_gsplit(jd.G, jd.A)
    jst = jst.with_band_plan(jplan(jst, jd.G, jd.A))
    ref = jt.solve(jst, jd, jt.Settings(kkt_strategy="banded"))
    st, d = lp(True)
    monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    ctx = kkt.make_context(st, torch.tensor(d.G), torch.tensor(d.A),
                           pt.Settings(kkt_strategy="banded"))
    assert all(type(getattr(ctx, k)) is spmv.SparseOperand for k in (
        "sG", "sGT", "sA", "sAT", "sGA", "sAGT", "sGe", "sGeT"))
    sol = pt.solve(st, d, pt.Settings(kkt_strategy="banded"), device="cpu")
    assert int(sol.exit_code) == int(ref.exit_code) == 0
    assert int(sol.info.iter) == int(ref.info.iter)
    want = float(ref.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-10 * abs(want)


def test_reduced_operand_path_matches_residual_first(monkeypatch):
    """"reduced" on the operand path against the port's own residual-first
    solve.  The JAX package cannot be the reference here: with its gate
    forced on, its dense recursion (``ops/ldl._use_ds_gemm`` reads the
    same gate) calls the Pallas GEMM, which on the CPU runs only in
    interpret mode and refuses.  The same exit code and iteration count,
    objectives within 1e-10 relative."""
    st, d = lp(False)
    cfg = pt.Settings(kkt_strategy="reduced")
    base, c0 = counted_solve(monkeypatch, st, d, cfg, live=False)
    sol, c1 = counted_solve(monkeypatch, st, d, cfg, live=True)
    assert int(sol.exit_code) == int(base.exit_code) == 0
    assert int(sol.info.iter) == int(base.info.iter)
    want = float(base.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-10 * abs(want)
    assert c1["solves"] < c0["solves"] and c1["syncs"] < c0["syncs"]


@pytest.mark.parametrize("strategy", ["reduced", "full"])
def test_rotated_loop_saves_one_backsolve(monkeypatch, strategy):
    """The rotated loop does one corrective solve and one host sync fewer
    per refined solve that has a lane to refine, and otherwise the same
    arithmetic.  On an LP without equality rows and without a recorded
    pattern every operand is the dense product of the residual-first path
    (``torch.matmul`` on the same matrices), so the two solves differ in
    the loop order alone: the same bits, the same refinement counts."""
    _, d = corpus.make_mpc_like(8, 2, 3, seed=1)
    m, n = d.G.shape
    st = ProblemStructure.create(n, 0, m, m)
    data = pt.ProblemData(G=d.G, A=np.zeros((0, n)), c=d.c, h=d.h,
                          b=np.zeros(0))
    cfg = pt.Settings(kkt_strategy=strategy)
    base, c0 = counted_solve(monkeypatch, st, data, cfg, live=False)
    sol, c1 = counted_solve(monkeypatch, st, data, cfg, live=True)
    assert int(base.exit_code) == 0
    for a, b in ((sol.x, base.x), (sol.z, base.z), (sol.info.iter,
                                                    base.info.iter)):
        assert torch.equal(a, b)
    for a, b in zip(sol.history[9:], base.history[9:]):
        assert torch.equal(a, b)
    assert c0["refined"] == c1["refined"] > 0
    assert c1["solves"] == c0["solves"] - c0["refined"]
    assert c1["syncs"] == c0["syncs"] - c0["refined"]


SITES = {
    # (caller, operand key): the fused call's form at that site
    ("solve_exact", "sGe"): dict(a2=False, base=True, op="add", w=False,
                                 x=False, split=None),
    ("solve_exact", "sGeT"): dict(a2=False, base=True, op="rsub", w=False,
                                  x=False, split=None),
    ("residual", "sGA"): dict(a2=True, base=True, op="sub", w=False,
                              x=True, split=None),
    ("residual", "sAGT"): dict(a2=False, base=(True, True), op="sub",
                               w=(False, True), x=(True, True), split="p"),
    ("_statistics", "sGA"): dict(a2=True, base=False, op="sub", w=False,
                                 x=False, split=None),
    ("_statistics", "sAGT"): dict(a2=False, base=(False, True), op="add",
                                  w=False, x=False, split="p"),
}
UNSTACKED = {
    ("residual", "sG"): dict(a2=False, base=True, op="sub", w=False, x=True,
                             split=None),
    ("residual", "sGT"): dict(a2=False, base=True, op="sub", w=True, x=True,
                              split=None),
    ("_statistics", "sG"): dict(a2=False, base=False, op="sub", w=False,
                                x=False, split=None),
    ("_statistics", "sGT"): dict(a2=False, base=True, op="add", w=False,
                                 x=False, split=None),
}


def spied_solve(monkeypatch, st, data, settings):
    """A CPU solve on the operand path with ``SparseOperand.rmatmul_fused``
    and ``torch.cat`` spied on: every fused call's caller, operand keys
    and form, and the callers of every ``torch.cat``."""
    import sys

    calls, cats, keys = [], [], {}
    real_fused = spmv.SparseOperand.rmatmul_fused
    real_cat = torch.cat
    real_sliced = kkt.make_sliced

    def present(v):
        return (tuple(t is not None for t in v) if isinstance(v, tuple)
                else v is not None)

    def fused(self, a, a2=None, base=None, op="add", w=None, gamma=0.0,
              x=None, split=None):
        calls.append((sys._getframe(1).f_code.co_name, keys[id(self)],
                      dict(a2=a2 is not None, base=present(base), op=op,
                           w=present(w), x=present(x), split=split)))
        return real_fused(self, a, a2, base, op, w, gamma, x, split)

    def cat(*args, **kw):
        cats.append(sys._getframe(1).f_code.co_name)
        return real_cat(*args, **kw)

    def sliced(*args, **kw):
        ops = real_sliced(*args, **kw)
        for key, op in ops.items():
            keys.setdefault(id(op), set()).add(key)
        return ops

    monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    monkeypatch.setattr(kkt, "make_sliced", sliced)
    monkeypatch.setattr(spmv.SparseOperand, "rmatmul_fused", fused)
    monkeypatch.setattr(torch, "cat", cat)
    sol = pt.solve(st, data, settings, device="cpu")
    return sol, calls, cats


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "p0"])
def test_operand_sites_call_the_fused_entry(monkeypatch, stacked):
    """With the gate forced on, every product site of ``solve_exact``'s
    elimination, ``residual`` and ``_statistics`` calls the fused entry
    with its tail in the call (the forms of ``SITES``: the stacked
    operands; ``UNSTACKED``: an LP without equality rows, whose residual
    takes G and G' alone), nothing else calls it, and neither
    ``residual`` nor ``_statistics`` calls ``torch.cat``: no operand is
    concatenated before its product.  The solve ends OPTIMAL."""
    st, d = lp(True)
    data = d
    if not stacked:
        st = ProblemStructure.create(st.n, 0, st.m, st.m).with_gsplit(
            d.G, np.zeros((0, st.n)))
        data = pt.ProblemData(G=d.G, A=np.zeros((0, st.n)), c=d.c, h=d.h,
                              b=np.zeros(0))
    sol, calls, cats = spied_solve(monkeypatch, st, data,
                                   pt.Settings(kkt_strategy="reduced"))
    assert int(sol.exit_code) == 0
    want = SITES if stacked else {
        ("solve_exact", "sGe"): SITES[("solve_exact", "sGe")],
        ("solve_exact", "sGeT"): SITES[("solve_exact", "sGeT")], **UNSTACKED}
    seen = {}
    for caller, keys, form in calls:
        site = [s for s in want if s[0] == caller and s[1] in keys]
        assert len(site) == 1, (caller, keys, form)
        expect = dict(want[site[0]])
        if expect["split"] == "p":
            expect["split"] = st.p
        assert form == expect, (site[0], form)
        seen[site[0]] = seen.get(site[0], 0) + 1
    assert set(seen) == set(want)
    assert "residual" not in cats and "_statistics" not in cats
