"""The wide band (block bandwidth 2..6) of the port on the CPU against the
JAX package: the plans, the gather maps, the plain twins of the wide band
kernels (ops/band_ldl.py, reached through the ops/band.py wrappers on CPU
tensors) against the f64 scan ``band_ldl_factor`` / ``band_ldl_solve`` and
the Pallas kernels ``band_factor_ds_bw`` / ``band_solve_ds_bw`` in interpret
mode, the dense H assembly behind the gathered band blocks, and whole
solves."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import corpus as jcorpus
from eicos_tpu import kkt as jkkt
from eicos_tpu.api import BatchedSolver as JBatched
from eicos_tpu.equilibrate import equilibrate as jequil
from eicos_tpu.ops import band_ldl as jband
from eicos_tpu.ops import pallas_band_ds as jds
from eicos_tpu.plan import make_band_plan as jplan
from eicos_tpu.settings import Settings as JSettings

import eicos_tpu_torch as pt
from eicos_tpu_torch import corpus, kkt, problem
from eicos_tpu_torch.equilibrate import equilibrate
from eicos_tpu_torch.ops import band, kernels
from eicos_tpu_torch.ops.band_ldl import (KP, band_bwd_bw_plain,
                                          band_factor_bw_plain,
                                          band_fwd_bw_plain)
from eicos_tpu_torch.plan import make_band_plan
from eicos_tpu_torch.settings import Settings

B = 128
SHARED = ("G", "A", "h")
BANDED = dict(kkt_strategy="banded")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
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


def wide_lp(gsplit=True):
    """make_mpc_like with wide stages (block bandwidth 2 at Dp = 640) in
    both packages, the plan carried across."""
    jst, d = jcorpus.make_mpc_like(horizon=6, nx=40, nu=20, seed=3)
    if gsplit:
        jst = jst.with_gsplit(d.G, d.A)
    jst = jst.with_band_plan(jplan(jst, d.G, d.A))
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    return jst, d, st, pd


# ------------------------------------------------------------------ plans

def test_wide_plan_matches():
    """The RCM plan of a wide-stage LP: the JAX package's permutation,
    block bandwidth 2 and dimension 640."""
    jst, d = jcorpus.make_mpc_like(horizon=6, nx=40, nu=20, seed=3)
    st, pd = corpus.make_mpc_like(horizon=6, nx=40, nu=20, seed=3)
    want = jplan(jst, d.G, d.A)
    got = make_band_plan(st, pd.G, pd.A)
    assert got.perm == want.perm
    assert got.bwb == want.bwb == 2 and got.dim == want.dim == 640


def test_wide_structure_carries_over():
    """``structure_fields`` / ``from_reference`` carry a bwb > 1 plan."""
    jst, _, st, _ = wide_lp()
    assert st.band.bwb == 2 and st.band.perm == tuple(jst.band.perm)
    assert not st.band.keep_soc
    assert problem.structure_fields(st) == problem.structure_fields(jst)


def test_band_gather_split_bwb2_matches():
    """The gather maps at block bandwidth 2 (one sub-block map per distance)
    equal the JAX package's."""
    jst, _, st, _ = wide_lp()
    (jm, jh, jo), jsubs = jkkt._band_gather_split(
        jst.n, jst.p, jst.band.dim, tuple(jst.band.perm), 2, 0)
    (m, h, o), (sm, sh, so) = kkt._band_gather_split(
        st.n, st.p, st.band.dim, np.asarray(st.band.perm, np.int64), 2, 0)
    for got, want in ((m, jm), (h, jh), (o, jo)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(jsubs) == 2
    for j, (wm, wh, wo) in enumerate(jsubs):
        np.testing.assert_array_equal(sm[:, j], np.asarray(wm))
        np.testing.assert_array_equal(sh[:, j], np.asarray(wh))
        np.testing.assert_array_equal(so[:, j], np.asarray(wo))


# ------------------------------------------------------------------ twins

@pytest.mark.parametrize("bw", [2, 3])
def test_bw_twins_match_f64_scan(bw):
    """``band_factor`` / ``band_solve`` on 5-d CPU blocks (the wide twins)
    against ``band_ldl_factor`` / ``band_ldl_solve`` (f64 scan, no Pallas)
    at nb = 4: the factor within 1e-11 and the solution within 1e-12
    relative (the same elimination in IEEE f64, summation order only), and
    a backward error below 1e-12."""
    nb, lanes = 4, 2
    Kd, Ks = wide_band(lanes, nb, bw, seed=bw)
    fac = band.band_factor(torch.tensor(Kd), torch.tensor(Ks))
    assert fac.L.shape == (lanes, nb, bw, B, B)
    rhs = np.random.default_rng(20 + bw).standard_normal((lanes, 3, nb * B))
    x = band.band_solve(fac, torch.tensor(rhs)).numpy()
    for lane in range(lanes):
        K = dense_from_blocks(Kd[lane], Ks[lane])
        ref = jband.band_ldl_factor(jnp.asarray(K), bw, use_pallas="off")
        assert rel(fac.L[lane], ref.Lband) < 1e-11
        assert rel(fac.Dinv[lane], ref.Dinv) < 1e-11
        assert rel(fac.d[lane].reshape(-1), ref.d) < 1e-11
        want = np.asarray(jband.band_ldl_solve(
            ref, jnp.asarray(rhs[lane].T), bw)).T
        assert rel(x[lane], want) < 1e-12
        assert rel(x[lane] @ K, rhs[lane]) < 1e-12


def test_bw_twins_match_pallas_interpret():
    """Against the TPU kernels ``band_factor_ds_bw`` and ``band_solve_ds_bw``
    in interpret mode at bw = 2, nb = 4: within 1e-8 relative, the
    double-single kernels' own accuracy (~2^-48 times the conditioning,
    with the sqrt|d| balancing)."""
    nb, bw = 4, 2
    Kd, Ks = wide_band(1, nb, bw, seed=11)
    fac = band.band_factor(torch.tensor(Kd), torch.tensor(Ks))
    dsfac = jds.band_factor_ds_bw(jnp.asarray(Kd[0]), jnp.asarray(Ks[0]),
                                  interpret=True)
    Lh, Ll, Dh, Dl, dh, dl = (np.asarray(a, np.float64) for a in dsfac)
    assert rel(fac.L[0], Lh + Ll) < 1e-8
    assert rel(fac.Dinv[0], Dh + Dl) < 1e-8
    assert rel(fac.d[0], (dh + dl)[:, 0]) < 1e-8
    rhs = np.random.default_rng(4).standard_normal((KP, nb * B))
    want = np.asarray(jds.band_solve_ds_bw(dsfac, jnp.asarray(rhs),
                                           interpret=True))
    x = band.band_solve(fac, torch.tensor(rhs[None]))[0].numpy()
    assert rel(x, want) < 1e-8


def test_bw1_layouts_agree():
    """Block bandwidth 1 given as 4-d sub-diagonal blocks (read as the
    band layout's bandwidth 1) gives the bits of the 5-d factor, an ``L``
    of the band layout and the same solution; ``band_factor`` and the wide
    twins agree within 1e-13; rows left of block column 0 are never read
    and come back as zeros; no kernel launch is counted on CPU tensors."""
    Kd, Ks = wide_band(2, 3, 1, seed=5)
    Ks[:, 0, 0] = 1e300          # K[0, -1]: never read
    Kd, Ks = torch.tensor(Kd), torch.tensor(Ks)
    before = dict(kernels.COUNTS)
    narrow = band.band_factor(Kd, Ks[:, :, 0].contiguous())
    five = band.band_factor(Kd, Ks)
    wide = band.band_factor_bw(Kd, Ks)
    assert all(torch.equal(a, b) for a, b in zip(narrow, five))
    assert narrow.L.dim() == 5
    assert not wide.L[:, 0].any()
    for a, b in zip(wide, five):
        assert rel(a, b) < 1e-13
    rhs = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 2, 3 * B)))
    assert torch.equal(band.band_solve(five, rhs),
                       band.band_solve(narrow, rhs))
    assert rel(band.band_bwd_bw(wide, band.band_fwd_bw(wide, rhs)),
               band.band_solve(narrow, rhs)) < 1e-13
    assert kernels.COUNTS == before
    # the wrappers run exactly the twins on CPU tensors
    assert all(torch.equal(a, b)
               for a, b in zip(wide, band_factor_bw_plain(Kd, Ks)))
    w = band_fwd_bw_plain(wide, rhs)
    assert torch.equal(band.band_fwd_bw(wide, rhs), w)
    assert torch.equal(band.band_bwd_bw(wide, w), band_bwd_bw_plain(wide, w))


def test_band_wider_than_six_raises():
    """The kernel wrappers take block bandwidths 1..6 and raise at 7;
    ``band_factor`` sends a band of 7 to the scan (``band_ldl_factor``)
    instead."""
    Kd, Ks = (torch.tensor(a) for a in wide_band(1, 8, 7, seed=0))
    with pytest.raises(ValueError):
        band.band_factor_bw(Kd, Ks)
    fac = band.band_factor(Kd, Ks[:, :, :2].contiguous())
    rhs = torch.zeros(1, 1, 8 * B, dtype=torch.float64)
    with pytest.raises(ValueError):
        band.band_fwd_bw(fac._replace(L=Ks), rhs)
    with pytest.raises(ValueError):
        band.band_bwd_bw(fac._replace(L=Ks), rhs)
    wide = band.band_factor(Kd, Ks)
    assert wide.L.shape == Ks.shape
    assert all(torch.equal(a, b)
               for a, b in zip(wide, band.band_ldl_factor(Kd, Ks)))


H100_SMEM_BLOCK = 232448    # shared memory a block may opt in to, H100
H100_SMEM_SM, H100_SMS = 233472, 132   # and an SM, of which 1 KB a CTA


def h100_resident(bw, kt):
    """Clusters of the sweep (2 CTAs of 288 threads) an H100 holds at once
    at each ring depth: by shared memory, and by registers (fewer than 114
    a thread at width 2, as the build reports, more at 8 and 16)."""
    def resident(stages):
        smem = band.sweep_smem(stages, bw, kt)
        if smem > H100_SMEM_BLOCK:
            return 0
        ctas = min(H100_SMEM_SM // (smem + 1024), 2 if kt == 2 else 1)
        return H100_SMS * ctas // 2
    return resident


@pytest.mark.parametrize("kt", band.SWEEP_KT)
@pytest.mark.parametrize("bw", range(1, band.BW_MAX + 1))
def test_sweep_ring_fits_the_card(bw, kt):
    """The sweeps' panel ring at every bandwidth and width: its slots, the
    y blocks, the residual, the join's sums and the barriers fit the
    card's shared memory a block; it keeps as many clusters resident as
    the 4 slots it had before the rule, is never shallower, and one slot
    more would not fit or would hold fewer clusters."""
    resident = h100_resident(bw, kt)
    stages = band.sweep_stages(bw, kt, H100_SMEM_BLOCK, resident)
    assert stages >= band.SWEEP_STAGES_MIN
    assert band.sweep_smem(stages, bw, kt) <= H100_SMEM_BLOCK
    assert resident(stages) == resident(band.SWEEP_STAGES_MIN) > 0
    assert resident(stages + 1) < resident(stages)
    assert band.sweep_kt(kt) == kt
    assert band.sweep_kt(kt - 1) == kt


def test_sweeps_on_cpu_never_ask_the_card(monkeypatch):
    """CPU tensors take the plain twins: the sweeps neither build a kernel
    nor ask the card for its shared memory."""
    def refuse(*args):
        raise AssertionError("a CPU tensor asked the card")

    monkeypatch.setattr(band, "_sweep_stages", refuse)
    monkeypatch.setattr(kernels, "lib", refuse)
    Kd, Ks = (torch.tensor(a) for a in wide_band(2, 4, 2, seed=5))
    fac = band.band_factor(Kd, Ks)
    rhs = torch.tensor(np.random.default_rng(5).standard_normal((2, 2,
                                                                 4 * B)))
    w = band.band_fwd_bw(fac, rhs)
    assert torch.equal(w, band_fwd_bw_plain(fac, rhs))
    assert torch.equal(band.band_bwd_bw(fac, w), band_bwd_bw_plain(fac, w))


# ---------------------------------------------- KKT assembly, factor, solve

def lp_case(kind):
    """JAX structure and data of the wide-stage LP (bwb 2, with its gsplit
    on the direct scatter, without it off), and of the narrow MPC LP (bwb
    1) without a gsplit or with one dense LP row, which leave the direct
    scatter."""
    if kind in ("bwb2", "bwb2_nosplit"):
        jst, d, _, _ = wide_lp(gsplit=kind == "bwb2")
        return jst, d
    jst, d = jcorpus.make_mpc_like(horizon=20, nx=2, nu=4, seed=3)
    if kind == "dense_rows":
        # one LP row over 6 neighbouring columns: too wide for a scatter row
        G = np.vstack([np.asarray(d.G), np.zeros((1, jst.n))])
        G[-1, :6] = 0.3
        h = np.concatenate([np.asarray(d.h), [50.0]])
        d = jt.ProblemData(G=G, A=d.A, c=d.c, h=h, b=d.b)
        jst = jt.ProblemStructure.create(jst.n, jst.p, jst.m + 1, jst.l + 1,
                                         jst.q)
    if kind != "nosplit":
        jst = jst.with_gsplit(d.G, d.A)
    return jst.with_band_plan(jplan(jst, d.G, d.A)), d


@pytest.mark.parametrize("kind", ["bwb2", "bwb2_nosplit", "nosplit",
                                  "dense_rows"])
def test_gathered_band_refined_solve_matches(kind):
    """The dense H assembly and the gathered band blocks, and at bwb 2
    with a gsplit the direct scatter's blocks (the JAX package gathers
    there): the port's blocks equal the blocks of the JAX package's dense
    K[perm][:, perm] within 1e-13 of its scale, and one ``solve_refined``
    at an interior scaling gives dx, dy, dz within 1e-9 relative."""
    jst, d = lp_case(kind)
    if kind == "dense_rows":
        assert jst.gsplit.dense_rows
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    bw = st.band.bwb
    assert bw == (2 if kind.startswith("bwb2") else 1)
    jset, pset = JSettings(**BANDED), Settings(**BANDED)
    jeq = jequil(jst, *[jnp.asarray(getattr(d, f)) for f in "GAchb"])
    t = torch.tensor
    peq = equilibrate(st, t(pd.G), t(pd.A), t(pd.c)[None], t(pd.h)[None],
                      t(pd.b)[None])
    jctx = jkkt.make_context(jst, jeq.G, jeq.A, jset)
    pctx = kkt.make_context(st, peq.G, peq.A, pset)
    direct = kind == "bwb2"
    assert (pctx.band.scatter is not None) == direct
    rng = np.random.default_rng(5)
    s, z = rng.random(st.m) * 3 + 0.01, rng.random(st.m) * 3 + 0.01
    from eicos_tpu import cones as jcones
    from eicos_tpu_torch import cones
    jscal, _ = jcones.update_scalings(jst.cone, jnp.asarray(s),
                                      jnp.asarray(z))
    pscal, _ = cones.update_scalings(st.cone, t(s)[None], t(z)[None])
    delta = pset.deltastat

    # blocks against the reference's dense assembly
    winv = 1.0 / (pscal.v_lp + delta)
    if direct:
        Kd, Ksubs = kkt.band_blocks(st, pctx, winv, delta, pscal)
    else:
        Hm = torch.zeros(1, st.n, st.n, dtype=torch.float64)
        kkt._assemble_h(st, pctx, pctx.dense, Hm, pscal, winv, delta)
        Kd, Ksubs = kkt._gathered_blocks(pctx, Hm.view(1, -1))
    Ge = np.asarray(jeq.G)
    Href = Ge.T @ (Ge / (np.asarray(jscal.v_lp) + delta)[:, None]) \
        + delta * np.eye(st.n)
    K = jkkt._assemble_dense(jst, jctx, jnp.asarray(Href), 0, None, None,
                             jnp.float64, jset)
    perm = np.asarray(jst.band.perm)
    Kd_ref, Kband = jband._band_views(K[perm][:, perm], bw, B)
    scale = np.abs(np.asarray(Kd_ref)).max()
    assert np.abs(Kd[0].numpy() - np.asarray(Kd_ref)).max() < 1e-13 * scale
    assert np.abs(Ksubs[0].numpy() - np.asarray(Kband)).max() < 1e-13 * scale

    n, p, m = st.n, st.p, st.m
    rhs = np.stack([
        np.concatenate([np.zeros(n), np.asarray(jeq.b), np.asarray(jeq.h)]),
        rng.standard_normal(n + p + m)])
    jsolve = jkkt.factor(jst, jctx, jscal, jset)
    ref = jkkt.solve_refined(jst, jctx, jsolve, jscal, jnp.asarray(rhs), jset)
    psolve = kkt.factor(st, pctx, pscal, pset, 1)
    got = kkt.solve_refined(st, pctx, psolve, pscal, t(rhs)[None], pset)
    for f in ("dx", "dy", "dz"):
        assert rel(getattr(got, f)[0], getattr(ref, f)) < 1e-9, f


def lanes_of(base, n, nx, seed, count):
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(count):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(n)
        b = np.asarray(base.b).copy()
        b[:nx] += 0.05 * rng.standard_normal(nx)
        probs.append(dict(G=np.asarray(base.G), A=np.asarray(base.A), c=c,
                          h=np.asarray(base.h), b=b))
    return probs


@pytest.mark.parametrize("kind,count", [("bwb2", 4), ("nosplit", 2),
                                        ("dense_rows", 2)])
def test_gathered_band_solves_match(kind, count):
    """Whole solves off the direct scatter, lane by lane against the JAX
    package on the CPU: equal exit codes (all OPTIMAL) and iteration
    counts, the objective within 1e-9 relative."""
    jst, d = lp_case(kind)
    st, _ = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                   d.c, d.h, d.b)
    probs = lanes_of(d, jst.n, 40 if kind == "bwb2" else 2, 7, count)
    ref = JBatched(jst, jt.Settings(**BANDED), shared=SHARED).solve(
        JBatched.stack([jt.ProblemData(**q) for q in probs], shared=SHARED))
    sol = pt.BatchedSolver(st, pt.Settings(**BANDED), shared=SHARED,
                           device="cpu").solve(pt.BatchedSolver.stack(
                               [problem.ProblemData(**q) for q in probs],
                               shared=SHARED))
    assert not np.asarray(ref.exit_code).any()
    np.testing.assert_array_equal(sol.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    want = np.asarray(ref.info.pcost)
    assert np.all(np.abs(sol.info.pcost.numpy() - want) <= 1e-9 * np.abs(want))


def test_plan_wider_than_six_raises(monkeypatch):
    """A plan beyond the kernels' bandwidth, the wide LP's bwb-2 plan
    declared at 7, solves through the scan as the JAX package's scan
    solves it: the same exit code (OPTIMAL) and iteration count, the
    objective within 1e-8 relative, and the same bits as the port's own
    bwb-2 solve on the same gathered blocks (the five extra sub-diagonals
    are zero and contribute exact zeros; at bwb 2 the blocks come from
    the direct scatter unless it is switched off); no kernel launch is
    counted.  The band kernel's wrapper itself still raises at bandwidth
    7."""
    jst, d, st, pd = wide_lp()
    st7 = dataclasses.replace(st, band=dataclasses.replace(st.band, bwb=7))
    jst7 = jst.with_band_plan(dataclasses.replace(jst.band, bwb=7))
    before = dict(kernels.COUNTS)
    sol = pt.solve(st7, pd, pt.Settings(**BANDED), device="cpu")
    assert kernels.COUNTS == before
    ref = jt.solve(jst7, d, jt.Settings(**BANDED))
    assert int(sol.exit_code) == int(ref.exit_code) == 0
    assert int(sol.info.iter) == int(ref.info.iter)
    want = float(ref.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-8 * abs(want)
    direct = pt.solve(st, pd, pt.Settings(**BANDED), device="cpu")
    assert int(direct.exit_code) == 0
    assert abs(float(direct.info.pcost) - want) <= 1e-8 * abs(want)
    monkeypatch.setattr(kkt, "_direct_band", lambda st, settings: False)
    narrow = pt.solve(st, pd, pt.Settings(**BANDED), device="cpu")
    assert torch.equal(sol.x, narrow.x) and torch.equal(sol.z, narrow.z)
    nb = st.band.dim // B
    with pytest.raises(ValueError):
        band.band_factor_bw(torch.zeros(1, nb, B, B, dtype=torch.float64),
                            torch.zeros(1, nb, 7, B, B, dtype=torch.float64))
