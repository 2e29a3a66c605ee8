"""The port's static-pattern products (ops/spmv.py) and the operand choice
of ``kkt.make_sliced`` against the JAX package on the CPU: ``csc_table``
gives the same tables, the plain ``SparseOperand.rmatmul`` the same
products (width groups included), and ``make_sliced`` the same kind of
operand per key as ``eicos_tpu.kkt._make_sliced`` with its TPU gate forced
on (that only builds operands; no kernel runs)."""

import contextlib

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


# ---------------------------------------------------------- the fused call

def mpc_operands(monkeypatch):
    """``make_sliced``'s operands of ``make_mpc_like(8, 2, 3, seed=1)``
    (every one a gather) with the gate forced on, the JAX package's
    ``_make_sliced`` operands with its own gate forced on, and the
    structure."""
    monkeypatch.setattr(pallas_gemm_ds, "gemv_ds_available", lambda: True)
    monkeypatch.setattr(kkt, "_sliced_live", lambda G: True)
    jst, jd = jcorpus.make_mpc_like(8, 2, 3, seed=1)
    jst = jst.with_gsplit(jd.G, jd.A)
    st, d = corpus.make_mpc_like(8, 2, 3, seed=1)
    st = st.with_gsplit(d.G, d.A)
    ref = jkkt._make_sliced(jst, jnp.asarray(jd.G), jnp.asarray(jd.A), jst.m)
    got = kkt.make_sliced(st, torch.tensor(d.G), torch.tensor(d.A), st.m)
    return st, got, ref


DELTA = 7e-8


def site_inputs(rng, st, lead):
    """Random iterate-shaped inputs of one product site: the right-hand
    side rhs = [bx | by | bz] (the bases are views of it, as in
    ``solve_exact`` and ``residual``), dx, dy, dz, Wdz and s."""
    n, p, m = st.n, st.p, st.m
    return {name: rng.standard_normal(lead + (size,)) for name, size in (
        ("rhs", n + p + m), ("dx", n), ("dy", p), ("dz", m), ("Wdz", m),
        ("s", m))}


def fused_case(form, st, T, J, tops, jops):
    """Form ``form`` of the fused call on the torch operands ``tops`` with
    the torch inputs ``T`` and, beside it, the JAX package's expression at
    that site (``eicos_tpu/kkt.py`` ``residual`` and elimination,
    ``eicos_tpu/solver.py`` computeResiduals) with the JAX inputs ``J``."""
    n, p, m = st.n, st.p, st.m

    def split3(d):
        r = d["rhs"]
        return r[..., :n], r[..., n:n + p], r[..., n + p:]

    tbx, tby, tbz = split3(T)
    jbx, jby, jbz = split3(J)
    if form == "elim":          # r1 = bx + G' welim(bz)
        return (tops["sGe"].rmatmul_fused(T["dz"], base=tbx),
                jbx + jops["sGe"].rmatmul(J["dz"]))
    if form == "elim_t":        # G dx - bz
        return (tops["sGeT"].rmatmul_fused(T["dx"], base=tbz, op="rsub"),
                jops["sGeT"].rmatmul(J["dx"]) - jbz)
    if form == "rx":            # -[G; A]'[z | y]
        return (tops["sGA"].rmatmul_fused(T["dz"], T["dy"], op="sub"),
                -jops["sGA"].rmatmul(jnp.concatenate([J["dz"], J["dy"]],
                                                     -1)))
    if form == "ryz":           # [A x | s + G x]
        t = jops["sAGT"].rmatmul(J["dx"])
        return (tops["sAGT"].rmatmul_fused(T["dx"], base=(None, T["s"]),
                                           split=p),
                jnp.concatenate([t[..., :p], J["s"] + t[..., p:]], -1))
    if form == "ex":            # bx - [G; A]'[dz | dy] - d dx
        return (tops["sGA"].rmatmul_fused(T["dz"], T["dy"], base=tbx,
                                          op="sub", gamma=-DELTA,
                                          x=T["dx"]),
                jbx - jops["sGA"].rmatmul(jnp.concatenate(
                    [J["dz"], J["dy"]], -1)) - DELTA * J["dx"])
    assert form == "eyz"        # [by - A dx + d dy | bz - G dx + W dz + d dz]
    t = jops["sAGT"].rmatmul(J["dx"])
    return (tops["sAGT"].rmatmul_fused(
                T["dx"], base=(tby, tbz), op="sub", w=(None, T["Wdz"]),
                gamma=DELTA, x=(T["dy"], T["dz"]), split=p),
            jnp.concatenate([jby - t[..., :p] + DELTA * J["dy"],
                             jbz - t[..., p:] + J["Wdz"] + DELTA * J["dz"]],
                            -1))


FORMS = ("elim", "elim_t", "rx", "ryz", "ex", "eyz")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k", [None, 1, 2], ids=["flat", "k1", "k2"])
def test_fused_plain_matches_jax(monkeypatch, form, k):
    """The fused call's plain version (``rmatmul_plain`` of the
    concatenation, then ``fused_tail``) on every product site's form,
    two-segment inputs and split outputs included, on
    ``make_mpc_like(8, 2, 3)``'s operands, against the JAX package's
    ``SparseOperand.rmatmul`` and its ``jnp`` tail at that site on the
    same inputs: within 1e-14 relative.  Not bit-equal: the gathers and
    width groups are the same, but torch and XLA sum a column's slots in
    their own orders (a few ulps)."""
    st, tops, jops = mpc_operands(monkeypatch)
    lead = (3,) if k is None else (3, k)
    v = site_inputs(np.random.default_rng(17), st, lead)
    T = {key: torch.tensor(a) for key, a in v.items()}
    J = {key: jnp.asarray(a) for key, a in v.items()}
    got, want = fused_case(form, st, T, J, tops, jops)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def test_fused_tail_gives_the_sites_bits():
    """``fused_tail`` against the expressions the product sites ran before
    the fusion, bit for bit (signed zeros included), on values where
    base == acc, x == 0 and acc == 0 occur: ``y + (-d) * x`` is ``y - d *
    x``, and ``acc - base`` keeps its own zero sign."""
    rng = np.random.default_rng(2)
    acc = torch.tensor(rng.standard_normal((4, 2, 60)))
    base, w, x = (torch.tensor(rng.standard_normal((4, 2, 60)))
                  for _ in range(3))
    base[..., :10] = acc[..., :10]
    base[..., 10:15] = -0.0
    acc[..., 15:20] = 0.0
    x[..., 20:25] = 0.0
    w[..., 25:30] = -acc[..., 25:30] + base[..., 25:30]
    d = 3e-8

    def bits(t):
        return t.view(torch.int64)

    for got, want in (
            (spmv.fused_tail(acc, base), base + acc),
            (spmv.fused_tail(acc, base, "rsub"), acc - base),
            (spmv.fused_tail(acc, None, "sub"), -acc),
            (spmv.fused_tail(acc, base, "sub", gamma=-d, x=x),
             base - acc - d * x),
            (spmv.fused_tail(acc, base, "sub", w=w, gamma=d, x=x),
             base - acc + w + d * x),
            (spmv.fused_tail(acc, (None, base[..., 7:]), split=7),
             torch.cat([acc[..., :7], base[..., 7:] + acc[..., 7:]], -1))):
        assert torch.equal(bits(got), bits(want))


def kernel_rows_a_thread():
    """The kernel's rows a thread, ``R`` of ``csrc/spmv.cu``."""
    import os
    import re

    src = open(os.path.join(spmv.kernels.CSRC, "spmv.cu")).read()
    return int(re.search(r"constexpr int R = (\d+);", src).group(1))


KERNEL_R = kernel_rows_a_thread()


def emulated_spmv(args, stream):
    """``csrc/spmv.cu`` in numpy, read from its packed argument block: the
    groups of ``KERNEL_R`` rows, the two input segments, the split
    epilogue.  Each row is covered by one group exactly once."""
    import ctypes

    g = spmv._SpmvArgs.from_buffer_copy(args)
    lanes, k, km, nm, km0 = g.lanes, g.k, g.km, g.nm, g.km0

    def view(s, cols):
        if not s.p:
            return None
        ext = max((lanes - 1) * s.ls + (k - 1) * s.rs + cols, 1)
        buf = np.frombuffer((ctypes.c_double * ext).from_address(s.p))
        return np.lib.stride_tricks.as_strided(
            buf, (lanes, k, cols), (s.ls * 8, s.rs * 8, 8))

    def ints(p, size):
        return np.frombuffer((ctypes.c_int * size).from_address(p), np.int32)

    colptr = ints(g.colptr, nm + 1).astype(np.int64)
    nnz = int(colptr[-1])
    rows = ints(g.rows, nnz).astype(np.int64)
    vals = np.frombuffer((ctypes.c_double * (nnz * (lanes if g.vstride
                                                   else 1))).from_address(
        g.vals))
    a0, a1 = view(g.a0, km0), view(g.a1, km - km0) if km > km0 else None
    out = np.frombuffer((ctypes.c_double * (lanes * k * nm)).from_address(
        g.out)).reshape(lanes * k, nm)
    segs = [(slice(0, g.split), [view(s[0], g.split)
                                 for s in (g.base, g.w, g.x)]),
            (slice(g.split, nm), [view(s[1], nm - g.split)
                                  for s in (g.base, g.w, g.x)])]
    R = KERNEL_R
    if g.vstride:
        gpl = -(-k // R)
        groups = [(lane * k + r0, min(R, k - r0))
                  for lane in range(lanes) for r0 in range(0, gpl * R, R)]
    else:
        groups = [(q0, min(R, lanes * k - q0))
                  for q0 in range(0, lanes * k, R)]
    seen = np.zeros(lanes * k, np.int64)
    width = int(np.diff(colptr).max()) if nm else 0
    for q0, nr in groups:
        vl = vals[(q0 // k) * g.vstride:][:nnz]
        for q in range(q0, q0 + nr):
            seen[q] += 1
            lane, r = divmod(q, k)
            arow = a0[lane, r] if a1 is None else np.concatenate(
                [a0[lane, r], a1[lane, r]])
            acc = np.zeros(nm)
            for t_off in range(width):
                t = colptr[:-1] + t_off
                live = t < colptr[1:]
                acc[live] += vl[t[live]] * arow[rows[t[live]]]
            for sl, (base, w, x) in segs:
                y = acc[sl]
                if base is not None:
                    b = base[lane, r]
                    y = (b + y if g.op == 0 else b - y if g.op == 1
                         else y - b)
                elif g.op == 1:
                    y = -y
                if w is not None:
                    y = y + w[lane, r]
                if x is not None:
                    y = y + g.gamma * x[lane, r]
                out[q, sl] = y
    assert (seen == 1).all(), seen
    return 0


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lanes"])
def test_kernel_arguments_address_the_inputs(monkeypatch, k, per_lane):
    """The wrapper's argument block (``spmv.spmv``), read back by a numpy
    model of the kernel in place of the card: on strided views of a
    right-hand side, two input segments, a split epilogue and k rows a
    lane over 5 lanes (k = 1, 3: the kernel's rows a thread do not divide
    the rows, nor, at k = 3, a lane's), the kernel's function equals the
    plain fused call within 1e-14 relative for every op."""
    monkeypatch.setattr(spmv.kernels, "lib",
                        lambda name: type("L", (), dict(
                            eicos_spmv=staticmethod(emulated_spmv))))
    monkeypatch.setattr(spmv.kernels, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    rng = np.random.default_rng(k)
    km, nm, lanes = 70, 90, 5
    src, out = random_pattern(rng, km, nm, rng.choice([0, 1, 2, 3, 7], nm))
    idx, W = spmv.csc_table(src, out, km, nm)
    mats = np.zeros((lanes, km, nm))
    for l in range(lanes):
        mats[l, src, out] = rng.standard_normal(len(src))
    op = spmv.SparseOperand(torch.tensor(mats if per_lane else mats[0]),
                            idx, W)
    big = torch.tensor(rng.standard_normal((lanes, k, km + 2 * nm + 9)))
    a, a2 = big[..., 4:34], big[..., 34:km + 4]       # strided segments
    base, w, x = (big[..., km + 4 + 0:km + 4 + nm],
                  torch.tensor(rng.standard_normal((lanes, k, nm))),
                  big[..., km + nm + 9:])
    sp = 37
    for kw in (dict(), dict(a2=a2, op="sub"),
               dict(base=base, op="rsub"),
               dict(a2=a2, base=base, op="sub", gamma=-0.25, x=x),
               dict(base=(base[..., :sp], base[..., sp:]), op="sub",
                    w=(None, w[..., sp:]), gamma=0.5,
                    x=(x[..., :sp], x[..., sp:]), split=sp),
               dict(base=(None, base[..., sp:]), split=sp)):
        first = a if "a2" in kw else torch.cat([a, a2], -1)
        want = op.rmatmul_fused(first, **kw)
        got = spmv.spmv(first, op.colptr, op.rows, op.vals, nm, **kw)
        assert rel(got, want) <= 1e-14, kw


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_argument_block_matches_the_source():
    """``spmv._SpmvArgs`` lays out ``EicosSpmvArgs`` of ``csrc/spmv.cu``
    field for field, and ``spmv._PACK`` packs that many bytes: the
    structs, cut from the source, compiled by the host's C++ compiler,
    give every offset and the size.  (The packing order is read back by
    ``test_kernel_arguments_address_the_inputs``.)"""
    import ctypes
    import os
    import shutil
    import subprocess
    import tempfile

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = open(os.path.join(spmv.kernels.CSRC, "spmv.cu")).read()
    start = src.index("struct EicosStrided {")
    structs = src[start:src.index("namespace {", start)]
    names = [f[0] for f in spmv._SpmvArgs._fields_]
    prog = ("#include <cstdio>\n#include <cstddef>\n" + structs
            + "int main() {\n  std::printf(\"%zu\\n\", sizeof(EicosSpmvArgs));\n"
            + "".join(f"  std::printf(\"%zu\\n\", offsetof(EicosSpmvArgs, "
                      f"{name}));\n" for name in names) + "}\n")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "layout.cpp")
        with open(path, "w") as fh:
            fh.write(prog)
        subprocess.run([cxx, "-o", os.path.join(tmp, "layout"), path],
                       check=True)
        got = subprocess.run([os.path.join(tmp, "layout")], check=True,
                             capture_output=True, text=True).stdout.split()
    assert int(got[0]) == ctypes.sizeof(spmv._SpmvArgs) == spmv._PACK.size
    assert [int(v) for v in got[1:]] == [
        getattr(spmv._SpmvArgs, name).offset for name in names]
