"""Host-side modules of the port against the JAX package: the generators,
the structure's symbolic plans (GSplit, SOCSplit, MatvecPattern, BandPlan)
and equilibration."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

import eicos_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from eicos_tpu import corpus as jcorpus
from eicos_tpu import equilibrate as jeq
from eicos_tpu import native as jnative
from eicos_tpu.plan import make_band_plan as jplan

from eicos_tpu_torch import corpus, equilibrate, native, problem
from eicos_tpu_torch.plan import make_band_plan

H = 50


def both(gen, **kw):
    jst, jd = getattr(jcorpus, gen)(**kw)
    st, d = getattr(corpus, gen)(**kw)
    return jst, jd, st, d


@pytest.mark.parametrize("gen", ["make_mpc_like", "make_mpc_soc"])
def test_generators_match(gen):
    jst, jd, st, d = both(gen, horizon=H, nx=2, nu=4, seed=3)
    assert (st.n, st.p, st.l, st.q) == (jst.n, jst.p, jst.l, jst.q)
    for f in "GAchb":
        np.testing.assert_array_equal(getattr(d, f), np.asarray(getattr(jd, f)))


@pytest.mark.parametrize("gen", ["make_mpc_like", "make_mpc_soc"])
def test_gsplit_socsplit_matvec_match(gen):
    jst, jd, st, d = both(gen, horizon=H, nx=2, nu=4, seed=3)
    jst = jst.with_gsplit(jd.G, jd.A)
    st = st.with_gsplit(d.G, d.A)
    jf, f = problem.structure_fields(jst), problem.structure_fields(st)
    assert set(jf) == set(f)
    assert f == jf


def test_band_plan_matches():
    """Same RCM permutation, block bandwidth 1, Dp = 512 at horizon 50."""
    assert native.available() == jnative.available()
    jst, jd, st, d = both("make_mpc_like", horizon=H, nx=2, nu=4, seed=3)
    jp = jplan(jst, jd.G, jd.A)
    p = make_band_plan(st, d.G, d.A)
    assert p.perm == jp.perm
    assert (p.bwb, p.block, p.dim) == (jp.bwb, jp.block, jp.dim) == (1, 128,
                                                                       512)


def test_from_reference_round_trip():
    jst, jd, _, _ = both("make_mpc_like", horizon=H, nx=2, nu=4, seed=3)
    jst = jst.with_gsplit(jd.G, jd.A)
    jst = jst.with_band_plan(jplan(jst, jd.G, jd.A))
    st, d = problem.from_reference(problem.structure_fields(jst), jd.G, jd.A,
                                   jd.c, jd.h, jd.b)
    assert problem.structure_fields(st) == problem.structure_fields(jst)
    own = corpus.make_mpc_like(horizon=H, nx=2, nu=4, seed=3)[0]
    own = own.with_gsplit(d.G, d.A)
    assert own.with_band_plan(make_band_plan(own, d.G, d.A)) == st


@pytest.mark.parametrize("gen", ["make_mpc_like", "make_mpc_soc"])
@pytest.mark.parametrize("shared", [True, False])
def test_equilibration_matches(gen, shared):
    """Equilibrated G, A, c, h, b and the scalings within 1e-14 relative;
    shared G/A (one equilibration for all lanes) or per-lane G/A."""
    jst, jd, st, d = both(gen, horizon=H, nx=2, nu=4, seed=3)
    rng = np.random.default_rng(0)
    lanes = 3
    c = d.c + 0.02 * rng.standard_normal((lanes, st.n))
    b = np.repeat(d.b[None], lanes, 0)
    h = np.repeat(d.h[None], lanes, 0)
    G, A = d.G, d.A
    if not shared:
        G = np.stack([d.G * (1.0 + 0.1 * j) for j in range(lanes)])
        A = np.stack([d.A] * lanes)
    t = torch.tensor
    eq = equilibrate.equilibrate(st, t(G), t(A), t(c), t(h), t(b))
    for j in range(lanes):
        Gj = G if shared else G[j]
        Aj = A if shared else A[j]
        ref = jeq.equilibrate(jst, jnp.asarray(Gj), jnp.asarray(Aj),
                              jnp.asarray(c[j]), jnp.asarray(h[j]),
                              jnp.asarray(b[j]))
        for f in ref._fields:
            got = getattr(eq, f)
            if got.dim() > np.ndim(getattr(ref, f)):
                got = got[j]
            want = np.asarray(getattr(ref, f))
            err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(),
                                                         1e-300)
            assert err < 1e-14, (f, err)
