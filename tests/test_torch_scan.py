"""The banded scan of the port (``ops/band_ldl.band_ldl_factor`` /
``band_ldl_solve``, the path of block bandwidths above 6 and of f32
factors) on the CPU against the JAX package's ``band_ldl_factor`` /
``band_ldl_solve`` and whole "banded" solves, inputs from a numpy seed.

On the CPU the JAX package takes its scan for every banded plan (its band
kernels are TPU-only); the port takes it where the reference's TPU path
does, so the factors here are the same function on both sides."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import corpus as jcorpus
from eicos_tpu.api import BatchedSolver as JBatched
from eicos_tpu.ops import band_ldl as jband
from eicos_tpu.plan import make_band_plan as jplan

import eicos_tpu_torch as pt
from eicos_tpu_torch import problem
from eicos_tpu_torch.api import _code_rank
from eicos_tpu_torch.ops import band, kernels
from eicos_tpu_torch.ops.band_ldl import band_ldl_factor, band_ldl_solve

B = 128
SHARED = ("G", "A", "h")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def wide_band(lanes, nb, bw, seed):
    """Random quasidefinite block-banded blocks Kd (lanes, nb, B, B) and
    Ksubs (lanes, nb, bw, B, B) with Ksubs[:, k, j-1] = K[k, k-j] (zero for
    k < j): mixed-sign diagonal, every row diagonally dominant."""
    rng = np.random.default_rng(seed)
    Kd = 0.3 * rng.standard_normal((lanes, nb, B, B)) / np.sqrt(B)
    Kd = Kd + Kd.transpose(0, 1, 3, 2)
    Ks = 0.3 * rng.standard_normal((lanes, nb, bw, B, B)) / np.sqrt(B)
    rows = np.abs(Kd).sum(-1)
    for j in range(1, bw + 1):
        Ks[:, :j, j - 1] = 0.0
        rows += np.abs(Ks[:, :, j - 1]).sum(-1)
        rows[:, :-j] += np.abs(Ks[:, j:, j - 1]).sum(-2)
    sign = np.where(rng.random((lanes, nb, B)) < 0.6, 1.0, -1.0)
    Kd[:, :, np.arange(B), np.arange(B)] = sign * (1.0 + rows)
    return Kd, Ks


def dense_from_blocks(Kd, Ks):
    nb, bw = Ks.shape[0], Ks.shape[1]
    K = np.zeros((nb * B, nb * B))
    for k in range(nb):
        K[k * B:(k + 1) * B, k * B:(k + 1) * B] = Kd[k]
        for j in range(1, min(bw, k) + 1):
            K[k * B:(k + 1) * B, (k - j) * B:(k - j + 1) * B] = Ks[k, j - 1]
            K[(k - j) * B:(k - j + 1) * B, k * B:(k + 1) * B] = Ks[k, j - 1].T
    return K


@pytest.mark.parametrize("bw,nb,kind", [(7, 10, "f64"), (9, 12, "f64"),
                                        (7, 10, "gemm32"), (9, 11, "f32")])
def test_scan_matches_reference(bw, nb, kind):
    """The scan factor and solves against the JAX package's on one lane
    each of two: in f64 within 1e-12 relative (the same elimination in
    IEEE f64), with f32 block products (``gemm_dtype``) or an f32 factor
    within 1e-5 (f32 sums in another order on each side)."""
    lanes = 2
    Kd, Ks = wide_band(lanes, nb, bw, seed=bw + nb)
    dt = torch.float32 if kind == "f32" else torch.float64
    gdt = torch.float32 if kind == "gemm32" else None
    jgdt = jnp.float32 if kind == "gemm32" else None
    tol = 1e-12 if kind == "f64" else 1e-5
    fac = band_ldl_factor(torch.tensor(Kd, dtype=dt),
                          torch.tensor(Ks, dtype=dt), gemm_dtype=gdt)
    assert fac.L.shape == (lanes, nb, bw, B, B) and fac.d.dtype == dt
    assert not fac.L[:, 0].any()
    rhs = np.random.default_rng(bw).standard_normal((lanes, 2, nb * B))
    x = band_ldl_solve(fac, torch.tensor(rhs, dtype=dt), gemm_dtype=gdt)
    for lane in range(lanes):
        K = jnp.asarray(dense_from_blocks(Kd[lane], Ks[lane]),
                        jnp.float32 if kind == "f32" else jnp.float64)
        ref = jband.band_ldl_factor(K, bw, use_pallas="off", gemm_dtype=jgdt)
        assert rel(fac.L[lane], ref.Lband) < tol
        assert rel(fac.Dinv[lane], ref.Dinv) < tol
        assert rel(fac.d[lane].reshape(-1), ref.d) < tol
        want = jband.band_ldl_solve(ref, jnp.asarray(rhs[lane].T, K.dtype),
                                    bw, gemm_dtype=jgdt)
        assert rel(x[lane], np.asarray(want).T) < tol


def test_band_dispatches_to_scan():
    """``ops/band.band_factor`` / ``band_solve`` send a band wider than 6
    and an f32 factor to the scan (the same bits as calling it), launch no
    kernel on CPU tensors, and the kernel wrappers keep their bound."""
    Kd, Ks = (torch.tensor(a) for a in wide_band(1, 9, 8, seed=3))
    before = dict(kernels.COUNTS)
    assert band.scan(Ks, torch.float64)
    assert band.scan(Ks[:, :, :2], torch.float32)
    assert not band.scan(Ks[:, :, :2], torch.float64)
    assert band.scan(Ks[:, :, :1], torch.float32)     # bw 1 too
    fac = band.band_factor(Kd, Ks)
    want = band_ldl_factor(Kd, Ks)
    assert all(torch.equal(a, b) for a, b in zip(fac, want))
    rhs = torch.tensor(np.random.default_rng(0).standard_normal((1, 3,
                                                                  9 * B)))
    assert torch.equal(band.band_solve(fac, rhs), band_ldl_solve(want, rhs))
    f32 = band.band_factor(Kd.float(), Ks[:, :, :2].float())
    assert f32.d.dtype == torch.float32
    assert torch.equal(f32.d, band_ldl_factor(Kd.float(),
                                              Ks[:, :, :2].float()).d)
    assert kernels.COUNTS == before
    with pytest.raises(ValueError):
        band.band_factor_bw(Kd, Ks)
    with pytest.raises(ValueError):
        band.band_fwd_bw(fac, rhs)
    with pytest.raises(ValueError):
        band.band_bwd_bw(fac, rhs)


def wide_case(lanes):
    """``make_mpc_like(horizon=3, nx=256, nu=128, seed=3)`` (n 1152, p 768,
    m 2816; Dp 1920, block bandwidth 7) with its gsplit and the JAX
    package's plan carried into the port, and ``lanes`` lanes made as
    the card tests make them (lane seed 7)."""
    jst, d = jcorpus.make_mpc_like(horizon=3, nx=256, nu=128, seed=3)
    jst = jst.with_gsplit(d.G, d.A)
    jst = jst.with_band_plan(jplan(jst, d.G, d.A))
    st, _ = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                   d.c, d.h, d.b)
    rng = np.random.default_rng(7)
    probs = []
    for _ in range(lanes):
        c = np.asarray(d.c) + 0.02 * rng.standard_normal(jst.n)
        b = np.asarray(d.b).copy()
        b[:256] += 0.05 * rng.standard_normal(256)
        probs.append(dict(G=np.asarray(d.G), A=np.asarray(d.A), c=c,
                          h=np.asarray(d.h), b=b))
    return jst, st, probs


@pytest.mark.parametrize("gemm", ["float64", "float32"])
def test_wide_plan_solves_match(gemm):
    """Whole "banded" solves of two lanes at block bandwidth 7 (the scan)
    in both packages: equal exit codes and iteration counts, objectives
    within 1e-8 relative on lanes that exit with an answer.  In f64 every
    lane ends OPTIMAL.  Under ``band_gemm="float32"`` every lane ends at
    NUMERICS at iteration 0 in both packages: f32 block products leave
    the factor of this LP short of what refinement needs
    (``deltastat`` = 7e-8 is below f32's epsilon), as an f32 factor does."""
    jst, st, probs = wide_case(2)
    assert (st.band.bwb, st.band.dim) == (7, 1920)
    cfg = dict(kkt_strategy="banded", band_gemm=gemm)
    ref = JBatched(jst, jt.Settings(**cfg), shared=SHARED).solve(
        JBatched.stack([jt.ProblemData(**q) for q in probs], shared=SHARED))
    sol = pt.BatchedSolver(st, pt.Settings(**cfg), shared=SHARED,
                           device="cpu").solve(pt.BatchedSolver.stack(
                               [problem.ProblemData(**q) for q in probs],
                               shared=SHARED))
    codes = np.asarray(ref.exit_code)
    np.testing.assert_array_equal(sol.exit_code.numpy(), codes)
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    if gemm == "float64":
        assert not codes.any()
    else:
        assert (codes == -2).all() and not np.asarray(ref.info.iter).any()
    answer = np.array([_code_rank(int(c)) > 0 for c in codes])
    want = np.asarray(ref.info.pcost)[answer]
    got = sol.info.pcost.numpy()[answer]
    assert np.all(np.abs(got - want) <= 1e-8 * np.abs(want))


def test_f32_banded_socp_matches_tier():
    """A small SOCP under "banded" with ``factor_dtype="float32"`` (keep_soc
    plan, so the f32 band blocks come from the dense K through the scan
    and the f32 leaf): the JAX package's exit tier, here an answer at
    reduced accuracy, and its objective within 1e-6 relative.  The
    problem is chosen away from the f32 edge of ROADMAP Queue 3: both
    packages end it at CLOSE_TO_OPTIMAL."""
    jst, d = jcorpus.make_mpc_soc(horizon=4, nx=2, nu=2, seed=1)
    jst = jst.with_gsplit(d.G, d.A)
    jst = jst.with_band_plan(jplan(jst, d.G, d.A, keep_soc=True))
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    cfg = dict(kkt_strategy="banded", factor_dtype="float32")
    ref = jt.solve(jst, d, jt.Settings(**cfg))
    sol = pt.solve(st, pd, pt.Settings(**cfg), device="cpu")
    rank = _code_rank(int(ref.exit_code))
    assert rank > 0
    assert _code_rank(int(sol.exit_code)) == rank
    want = float(ref.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-6 * abs(want)
