"""Second-order cones under the port's "banded" strategy on the CPU against
the JAX package on the CPU: the ``keep_soc`` plan, the static maps and the
per-lane values of the NT-scaled kept layout and of the eliminating layout,
the assembled band blocks, one refined solve, and whole solves.

On the CPU the JAX package leaves the scaled kept layout (it lives on its
TPU kernel path) and factors the unscaled dense K[perm][:, perm] with
``band_ldl_factor``; the port runs the scaled layout everywhere.  Both are
exact factorizations of the same regularized system, so refined directions
agree, while whole solves may differ in their endgame (see the last test).
"""

import torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import cones as jcones
from eicos_tpu import corpus as jcorpus
from eicos_tpu import kkt as jkkt
from eicos_tpu.api import BatchedSolver as JBatched
from eicos_tpu.equilibrate import equilibrate as jequil
from eicos_tpu.plan import make_band_plan as jplan
from eicos_tpu.settings import Settings as JSettings

import eicos_tpu_torch as pt
from eicos_tpu_torch import api, cones, corpus, kkt, problem
from eicos_tpu_torch.equilibrate import equilibrate
from eicos_tpu_torch.plan import make_band_plan
from eicos_tpu_torch.settings import Settings

B = 128
SHARED = ("G", "A", "h")
BANDED = dict(kkt_strategy="banded")
LANES = 2


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def interior(rng, cone):
    """A strictly interior point of the cone: positive LP part, SOC heads
    above their tails' norm."""
    x = rng.random(cone.m) + 0.5
    for c, off in enumerate(cone.head_offsets):
        a = cone.l + int(off)
        b = a + cone.q[c]
        x[a + 1:b] = 0.3 * rng.standard_normal(cone.q[c] - 1)
        x[a] = np.linalg.norm(x[a + 1:b]) + 0.2 + rng.random()
    return x


def socp(layout, horizon=12, nx=2, nu=3, seed=4):
    """The JAX-side structure (gsplit, socsplit and a band plan) and data of
    a small SOC-constrained MPC problem, and the same in the port.
    ``layout``: "kept" (keep_soc plan), "elim" (plain plan: the cones are
    eliminated) or "kept_dense" (keep_soc plan without a gsplit, off the
    scatter path)."""
    jst, d = jcorpus.make_mpc_soc(horizon=horizon, nx=nx, nu=nu, seed=seed)
    if layout != "kept_dense":
        jst = jst.with_gsplit(d.G, d.A)
    jst = jst.with_band_plan(jplan(jst, d.G, d.A,
                                   keep_soc=layout != "elim"))
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    return jst, d, st, pd


def scalings(jst, seed, lanes=LANES):
    """Per-lane JAX scalings at interior points, and the port's stacked."""
    rng = np.random.default_rng(seed)
    js = [jcones.update_scalings(jst.cone,
                                 jnp.asarray(interior(rng, jst.cone)),
                                 jnp.asarray(interior(rng, jst.cone)))[0]
          for _ in range(lanes)]
    return js, problem.scaling_from_reference(js)


# ------------------------------------------------------------------ plans

def test_keep_soc_plan_matches():
    """The keep_soc plan has the permutation, bandwidth and dimension of
    the JAX package's (same native RCM), over [z_soc | x | y]."""
    jst, d = jcorpus.make_mpc_soc(horizon=12, nx=2, nu=3, seed=4)
    st, pd = corpus.make_mpc_soc(horizon=12, nx=2, nu=3, seed=4)
    want = jplan(jst, d.G, d.A, keep_soc=True)
    got = make_band_plan(st, pd.G, pd.A, keep_soc=True)
    assert got.keep_soc and want.keep_soc
    assert got.perm == want.perm and got.bwb == want.bwb == 1
    assert got.dim == want.dim == 256
    assert sorted(got.perm[:st.cone.ms + st.n + st.p]) == list(
        range(st.cone.ms + st.n + st.p))
    # without cones keep_soc means nothing, as in the reference
    lst, ld = corpus.make_mpc_like(horizon=4, nx=2, nu=2, seed=1)
    assert not make_band_plan(lst, ld.G, ld.A, keep_soc=True).keep_soc


def test_keep_soc_structure_carries_over():
    """``structure_fields`` / ``from_reference`` carry a keep_soc plan, the
    gsplit and the socsplit across as plain fields."""
    jst, _, st, _ = socp("kept")
    assert st.band.keep_soc and st.band.perm == tuple(jst.band.perm)
    assert st.band.bwb == jst.band.bwb and st.band.dim == jst.band.dim
    assert st.socsplit.cols == tuple(jst.socsplit.cols)
    assert st.socsplit.width == jst.socsplit.width
    assert st.gsplit.sing_rows == tuple(jst.gsplit.sing_rows)
    assert problem.structure_fields(st) == problem.structure_fields(jst)


def test_scaling_carries_over():
    """``scaling_from_reference`` stacks per-lane JAX scalings into the
    port's: equal to the port's own update_scalings within 1e-13."""
    jst, _, st, _ = socp("kept")
    rng = np.random.default_rng(3)
    s = np.stack([interior(rng, jst.cone) for _ in range(LANES)])
    z = np.stack([interior(rng, jst.cone) for _ in range(LANES)])
    js = [jcones.update_scalings(jst.cone, jnp.asarray(s[i]),
                                 jnp.asarray(z[i]))[0] for i in range(LANES)]
    got = problem.scaling_from_reference(js)
    own, _ = cones.update_scalings(st.cone, torch.tensor(s), torch.tensor(z))
    for f in cones.Scaling._fields:
        assert getattr(got, f).shape == getattr(own, f).shape, f
        assert rel(getattr(got, f), getattr(own, f)) < 1e-13, f


# ------------------------------------------------------------------ cones

def test_cone_closed_forms_match_batched():
    """``scale_winv_soc`` and ``scale2reg_inv_soc`` on (L, k, ms) stacks
    against the JAX functions lane by lane and column by column, within
    1e-13 relative."""
    jst, _, st, _ = socp("kept")
    js, ps = scalings(jst, 8)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((LANES, 3, st.cone.ms))
    delta = Settings().deltastat
    got_w = cones.scale_winv_soc(st.cone, ps, torch.tensor(x))
    got_r = cones.scale2reg_inv_soc(st.cone, ps, delta, torch.tensor(x))
    for i in range(LANES):
        for k in range(3):
            v = jnp.asarray(x[i, k])
            assert rel(got_w[i, k], jcones.scale_winv_soc(
                jst.cone, js[i], v)) < 1e-13
            assert rel(got_r[i, k], jcones.scale2reg_inv_soc(
                jst.cone, js[i], delta, v)) < 1e-13


# --------------------------------------------------------- maps and values

@pytest.mark.parametrize("layout", ["lp", "elim", "kept"])
def test_band_scatter_idx_matches(layout):
    """The scatter targets of all three layouts equal the JAX package's."""
    if layout == "lp":
        jst, d = jcorpus.make_mpc_like(horizon=20, nx=2, nu=4, seed=3)
        jst = jst.with_gsplit(d.G, d.A)
        jst = jst.with_band_plan(jplan(jst, d.G, d.A))
        st, _ = problem.from_reference(problem.structure_fields(jst), d.G,
                                       d.A, d.c, d.h, d.b)
    else:
        jst, _, st, _ = socp(layout)
    sp = jst.gsplit
    want = jkkt._band_scatter_idx(
        jst.n, jst.p, jst.band.dim, tuple(jst.band.perm), sp.sing_cols,
        sp.spr_cols, sp.spr_width,
        jst.socsplit.cols if jst.n_sc else (),
        jst.socsplit.width if jst.n_sc else 0,
        jst.q if layout == "kept" else ())
    got = kkt._band_scatter_idx(
        st.n, st.band.dim, np.asarray(st.band.perm, np.int64), st.gsplit,
        st.socsplit, st.q if layout == "kept" else ())
    np.testing.assert_array_equal(got, np.asarray(want))


def test_band_gather_with_kept_rows_matches():
    """The base's gather maps with ms kept rows (Z and C positions on the
    shared zero) equal the JAX package's."""
    jst, _, st, _ = socp("kept")
    ms = st.cone.ms
    (jm, jh, jo), [(jsm, jsh, jso)] = jkkt._band_gather_split(
        jst.n, jst.p, jst.band.dim, tuple(jst.band.perm), 1, ms)
    (m, h, o), (sm, sh, so) = kkt._band_gather_split(
        st.n, st.p, st.band.dim, np.asarray(st.band.perm, np.int64), 1, ms)
    for got, want in ((m, jm), (h, jh), (o, jo), (sm[:, 0], jsm),
                      (sh[:, 0], jsh), (so[:, 0], jso)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("name", ["kept", "coupling", "elim"])
def test_soc_values_match(name, scaled):
    """``_soc_scaled_kept_vals``, ``_soc_coupling_vals`` and
    ``_soc_band_vals``, batched over two lanes, against the per-lane JAX
    functions within 1e-13 relative, at the identity scaling and at
    scalings from interior points."""
    layout = "elim" if name == "elim" else "kept"
    jst, d, st, pd = socp(layout)
    pset = Settings(**BANDED)
    delta = pset.deltastat
    G = torch.tensor(pd.G)
    ctx = kkt.make_context(st, G, torch.tensor(pd.A), pset)
    js, ps = scalings(jst, 9) if scaled else ([None] * LANES, None)
    if name == "kept":
        got = kkt._soc_scaled_kept_vals(st, ctx, ps, delta, LANES)
    elif name == "coupling":
        got = kkt._soc_coupling_vals(st, ctx, ps, LANES)
    else:
        got = kkt._soc_band_vals(st, ctx, ps, delta, LANES)
    Gj = jnp.asarray(np.asarray(d.G))
    for i in range(LANES):
        if name == "kept":
            want = jkkt._soc_scaled_kept_vals(jst, js[i], delta, jnp.float64)
        elif name == "coupling":
            want = jkkt._soc_coupling_vals(jst, Gj, js[i], jnp.float64)
        else:
            want = jkkt._soc_band_vals(jst, Gj, js[i], delta, jnp.float64)
        assert got[i].shape == want.shape
        assert rel(got[i], want) < 1e-13


@pytest.mark.parametrize("scaled", [False, True])
def test_keep_soc_blocks_match_dense_scaled_kkt(scaled):
    """The band blocks of a keep_soc plan against the dense S K S with
    S = diag(W^-1, I, I) in [z_soc | x | y], permuted: within 1e-10 of its
    scale, and every nonzero of the dense matrix inside the band."""
    jst, d, st, pd = socp("kept")
    pset = Settings(**BANDED)
    delta = pset.deltastat
    n, p, l, ms = st.n, st.p, st.l, st.cone.ms
    D, Dp = ms + n + p, st.band.dim
    ctx = kkt.make_context(st, torch.tensor(pd.G), torch.tensor(pd.A), pset)
    js, ps = scalings(jst, 9) if scaled else ([None] * LANES, None)
    if scaled:
        winv = 1.0 / (ps.v_lp + delta)
    else:
        winv = torch.full((LANES, l), 1.0 / (1.0 + delta),
                          dtype=torch.float64)
    Kd, Ks = kkt.band_blocks(st, ctx, winv, delta, ps)
    G, A = np.asarray(d.G), np.asarray(d.A)
    perm = np.asarray(st.band.perm)
    nb = Dp // B
    for i in range(LANES):
        if scaled:
            Winv = np.asarray(jax.vmap(lambda e: jcones.scale_winv_soc(
                jst.cone, js[i], e))(jnp.eye(ms))).T
        else:
            Winv = np.eye(ms)
        wl = winv[i].numpy()
        M = np.zeros((Dp, Dp))
        M[:ms, :ms] = -(np.eye(ms) + delta * (Winv @ Winv))
        M[:ms, ms:ms + n] = Winv @ G[l:]
        M[ms:ms + n, :ms] = M[:ms, ms:ms + n].T
        M[ms:ms + n, ms:ms + n] = (G[:l].T @ (G[:l] * wl[:, None])
                                   + delta * np.eye(n))
        M[ms:ms + n, ms + n:D] = A.T
        M[ms + n:D, ms:ms + n] = A
        M[ms + n:D, ms + n:D] = -delta * np.eye(p)
        M[np.arange(D, Dp), np.arange(D, Dp)] = 1.0
        Mp = M[perm][:, perm].reshape(nb, B, nb, B).transpose(0, 2, 1, 3)
        scale = max(1.0, np.abs(Mp).max())
        for k in range(nb):
            assert np.abs(Kd[i, k].numpy() - Mp[k, k]).max() < 1e-10 * scale
            if k:
                assert np.abs(Ks[i, k].numpy() - Mp[k, k - 1]).max() \
                    < 1e-10 * scale
            for c in range(nb):
                if abs(k - c) > 1:
                    assert not Mp[k, c].any()


# ------------------------------------------------------- factor and solve

@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("layout", ["kept", "elim", "kept_dense"])
def test_banded_socp_refined_solve_matches(layout, scaled):
    """``factor`` and one ``solve_refined`` of the SOCP under "banded" in
    the kept (scaled), the eliminating and the off-scatter kept layouts,
    against ``eicos_tpu.kkt.factor`` on the CPU: dx, dy, dz within 1e-9
    relative to their size (two exact factorizations of one regularized
    system, refined to 1e-14 residuals)."""
    jst, d, st, pd = socp(layout)
    jset, pset = JSettings(**BANDED), Settings(**BANDED)
    jeq = jequil(jst, *[jnp.asarray(getattr(d, f)) for f in "GAchb"])
    t = torch.tensor
    peq = equilibrate(st, t(pd.G), t(pd.A), t(pd.c)[None], t(pd.h)[None],
                      t(pd.b)[None])
    jctx = jkkt.make_context(jst, jeq.G, jeq.A, jset)
    pctx = kkt.make_context(st, peq.G, peq.A, pset)
    assert (pctx.band.scatter is None) == (layout == "kept_dense")
    jscal = pscal = None
    if scaled:
        js, pscal = scalings(jst, 5, lanes=1)
        jscal = js[0]
    n, p, m = st.n, st.p, st.m
    rng = np.random.default_rng(6)
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


@pytest.mark.parametrize("layout", ["elim", "kept_dense"])
def test_banded_socp_solve_matches(layout):
    """Whole solves of two lanes where both packages factor the same
    matrix (the cones eliminated, or kept unscaled off the scatter path):
    equal exit codes and iteration counts, objective within 1e-8
    relative."""
    jst, d, st, _ = socp(layout, horizon=10, nx=2, nu=4, seed=5)
    probs = lanes_of(d, jst.n, 2, 11, 2)
    ref = JBatched(jst, jt.Settings(**BANDED), shared=SHARED).solve(
        JBatched.stack([jt.ProblemData(**q) for q in probs], shared=SHARED))
    sol = pt.BatchedSolver(st, pt.Settings(**BANDED), shared=SHARED,
                           device="cpu").solve(pt.BatchedSolver.stack(
                               [problem.ProblemData(**q) for q in probs],
                               shared=SHARED))
    np.testing.assert_array_equal(sol.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    want = np.asarray(ref.info.pcost)
    assert np.all(np.abs(sol.info.pcost.numpy() - want) <= 1e-8 * np.abs(want))


def test_keep_soc_batch_solves():
    """The bench's SOCP lane in small: four lanes under "banded" with a
    keep_soc plan and the "reduced" rescue.  On the CPU the JAX package
    factors the unscaled kept K where the port factors the NT-scaled one,
    so the two take different endgames and iteration counts are not
    compared.  The port's lanes are held to: an exit tier no worse than
    the JAX lane's, and the objective within 1e-7 relative of the JAX
    package's "reduced" solve of the same lane."""
    jst, d, st, _ = socp("kept", horizon=10, nx=2, nu=4, seed=5)
    probs = lanes_of(d, jst.n, 2, 11, 4)
    jbatch = JBatched.stack([jt.ProblemData(**q) for q in probs],
                            shared=SHARED)
    ref = JBatched(jst, jt.Settings(**BANDED), shared=SHARED).solve(jbatch)
    red = JBatched(jst, jt.Settings(kkt_strategy="reduced"),
                   shared=SHARED).solve(jbatch)
    bs = pt.BatchedSolver(st, pt.Settings(**BANDED), shared=SHARED,
                          rescue=pt.Settings(kkt_strategy="reduced"),
                          device="cpu")
    sol = bs.solve(pt.BatchedSolver.stack(
        [problem.ProblemData(**q) for q in probs], shared=SHARED))
    want = np.asarray(red.info.pcost)
    for i in range(4):
        assert api._code_rank(int(sol.exit_code[i])) >= api._code_rank(
            int(ref.exit_code[i])), i
        assert int(red.exit_code[i]) == 0
        assert abs(float(sol.info.pcost[i]) - want[i]) <= 1e-7 * abs(want[i])
    assert torch.isfinite(sol.x).all() and torch.isfinite(sol.z).all()
