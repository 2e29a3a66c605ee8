"""The port's static-pattern products (ops/spmv.py) and the operand choice
of ``kkt.make_sliced`` against the JAX package on the CPU: ``csc_table``
gives the same tables, the plain ``SparseOperand.rmatmul`` the same
products (width groups included), and ``make_sliced`` the same kind of
operand per key as ``eicos_tpu.kkt._make_sliced`` with its TPU gate forced
on (that only builds operands; no kernel runs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu  # noqa: F401  (enables x64)
from eicos_tpu import corpus as jcorpus
from eicos_tpu import kkt as jkkt
from eicos_tpu.ops import pallas_gemm_ds
from eicos_tpu.ops import spmv as jspmv

from eicos_tpu_torch import corpus, kkt
from eicos_tpu_torch.ops import spmv

KEYS = ("sG", "sGT", "sA", "sAT", "sGA", "sAGT", "sGe", "sGeT")


def random_pattern(rng, km, nm, widths):
    """Nonzeros (src, out) of a (km, nm) operand whose column j holds
    ``widths[j]`` nonzeros at distinct random rows, listed in a shuffled
    order."""
    src, out = [], []
    for j, w in enumerate(widths):
        src += list(rng.choice(km, size=w, replace=False))
        out += [j] * w
    order = rng.permutation(len(src))
    return np.asarray(src)[order], np.asarray(out)[order]


def mpc_pattern(horizon=8, nx=2, nu=3):
    _, d = corpus.make_mpc_like(horizon, nx, nu, seed=1)
    gr, gc = np.nonzero(d.G)
    return d.G, gr, gc


@pytest.mark.parametrize("case", ["narrow", "mixed", "wide", "empty_cols",
                                  "mpc_G", "mpc_GT"])
def test_csc_table_matches_jax(case):
    rng = np.random.default_rng(3)
    if case.startswith("mpc"):
        G, gr, gc = mpc_pattern()
        m, n = G.shape
        args = (gr, gc, m, n) if case == "mpc_G" else (gc, gr, n, m)
    else:
        km, nm = 90, 300
        widths = {"narrow": rng.integers(1, 4, nm),
                  "mixed": rng.choice([1, 1, 1, 2, 9], nm),
                  "wide": rng.integers(1, 20, nm),
                  "empty_cols": rng.integers(0, 3, nm)}[case]
        widths[0] = {"wide": 17}.get(case, widths[0])
        src, out = random_pattern(rng, km, nm, widths)
        args = (src, out, km, nm)
    got, ref = spmv.csc_table(*args), jspmv.csc_table(*args)
    if ref is None:
        assert got is None
        return
    assert got[1] == ref[1]
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == ref[0].dtype


@pytest.mark.parametrize("case", ["grouped", "ungrouped", "mpc"])
@pytest.mark.parametrize("k", [1, 2])
def test_plain_rmatmul_matches_jax(case, k):
    """The plain product against ``eicos_tpu.ops.spmv.SparseOperand`` on
    one table and the same inputs, shared operand and per lane: within
    1e-14 relative (the same gathers and width groups; torch and XLA sum
    the slots in their own orders).  Grouping engages exactly where the
    JAX package's does."""
    rng = np.random.default_rng(5)
    if case == "mpc":
        G, gr, gc = mpc_pattern()
        km, nm = G.shape
        src, out = gr, gc
    else:
        km, nm = 120, 400 if case == "grouped" else 200
        widths = rng.choice([1, 1, 1, 2, 3, 8], nm)
        src, out = random_pattern(rng, km, nm, widths)
    idx, W = spmv.csc_table(src, out, km, nm)
    lanes = 3
    mats = np.zeros((lanes, km, nm))
    for l in range(lanes):
        mats[l, src, out] = rng.standard_normal(len(src))
    a = rng.standard_normal((lanes, k, km))
    shared = spmv.SparseOperand(torch.tensor(mats[0]), idx, W)
    per_lane = spmv.SparseOperand(torch.tensor(mats), idx, W)
    ref0 = jspmv.SparseOperand(jnp.asarray(mats[0]), idx, W)
    assert (shared.groups is None) == (ref0.groups is None)
    assert (shared.groups is None) == (case != "grouped")
    got = shared.rmatmul(torch.tensor(a)).numpy()
    want = np.asarray(ref0.rmatmul(jnp.asarray(a)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-14 * scale
    got = per_lane.rmatmul(torch.tensor(a)).numpy()
    for l in range(lanes):
        ref = jspmv.SparseOperand(jnp.asarray(mats[l]), idx, W)
        want = np.asarray(ref.rmatmul(jnp.asarray(a[l])))
        assert np.abs(got[l] - want).max() <= 1e-14 * np.abs(want).max()
    # a 2-d argument (one row a lane) gives the rows of the 3-d product
    flat = shared.rmatmul(torch.tensor(a[:, 0]))
    assert torch.equal(flat, shared.rmatmul(torch.tensor(a[:, :1]))[:, 0])
    # the CSC form lists every slot of the table once, in slot order
    valid = idx < km
    assert int(shared.colptr[-1]) == int(valid.sum())
    np.testing.assert_array_equal(shared.rows.numpy(), idx[valid])


@pytest.mark.parametrize("dims,wide", [
    ((8, 2, 3), ()),
    ((3, 24, 12), ("sA", "sAT", "sGA", "sAGT")),
])
def test_make_sliced_kinds_match_jax(monkeypatch, dims, wide):
    """``make_sliced`` with its gate forced on chooses, key by key, the
    kind of operand that ``eicos_tpu.kkt._make_sliced`` chooses with
    ``gemv_ds_available`` forced on: a gather where the pattern is narrow,
    the dense product (dgemm here, BigOperand there) where it is not."""
    monkeypatch.setattr(pallas_gemm_ds, "gemv_ds_available", lambda: True)
    monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    jst, jd = jcorpus.make_mpc_like(*dims, seed=1)
    jst = jst.with_gsplit(jd.G, jd.A)
    st, d = corpus.make_mpc_like(*dims, seed=1)
    st = st.with_gsplit(d.G, d.A)
    ref = jkkt._make_sliced(jst, jnp.asarray(jd.G), jnp.asarray(jd.A),
                            jst.l)
    got = kkt.make_sliced(st, torch.tensor(d.G), torch.tensor(d.A), st.l)
    for key in KEYS:
        sparse = type(got[key]) is spmv.SparseOperand
        assert sparse == (type(ref[key]) is jspmv.SparseOperand), key
        assert sparse == (key not in wide), key
    # with part of the rows eliminated the eliminated block has its own
    # operands; a wide one is the dense product of the same matrix
    half = st.l // 2
    mid = kkt.make_sliced(st, torch.tensor(d.G), torch.tensor(d.A), half)
    jmid = jkkt._make_sliced(jst, jnp.asarray(jd.G), jnp.asarray(jd.A), half)
    for key in ("sGe", "sGeT"):
        assert (type(mid[key]) is spmv.SparseOperand) == (
            type(jmid[key]) is jspmv.SparseOperand)
    x = torch.tensor(np.random.default_rng(0).standard_normal((2, 1, half)))
    np.testing.assert_allclose(mid["sGe"].rmatmul(x).numpy(),
                               (x @ torch.tensor(d.G[:half])).numpy(),
                               rtol=0, atol=1e-13)
    for key in wide:
        op = got[key]
        a = torch.tensor(np.random.default_rng(1).standard_normal(
            (2, 2, op.bmat.shape[0])))
        assert torch.equal(op.rmatmul(a), a @ op.bmat)


def test_no_operands_on_the_cpu():
    """Unforced, the gate is off for CPU tensors: no operand, so every CPU
    solve keeps its dense products and the residual-first loop."""
    st, d = corpus.make_mpc_like(4, 2, 2, seed=1)
    st = st.with_gsplit(d.G, d.A)
    assert kkt.make_sliced(st, torch.tensor(d.G), torch.tensor(d.A),
                           st.l) == {}
