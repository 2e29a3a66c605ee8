"""The port's banded KKT (kkt.py) against eicos_tpu.kkt on the CPU, where
the JAX package assembles the dense K and factors K[perm][:, perm] with
band_ldl_factor: the band blocks from the port's direct scatter, and one
refined solve from the same factor state."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu  # noqa: F401  (enables x64)
from eicos_tpu import cones as jcones
from eicos_tpu import corpus as jcorpus
from eicos_tpu import kkt as jkkt
from eicos_tpu.equilibrate import equilibrate as jequil
from eicos_tpu.ops.band_ldl import _band_views
from eicos_tpu.plan import make_band_plan as jplan
from eicos_tpu.settings import Settings as JSettings

from eicos_tpu_torch import cones, kkt, problem
from eicos_tpu_torch.equilibrate import equilibrate
from eicos_tpu_torch.settings import Settings

H = 50
B = 128


@pytest.fixture(scope="module")
def setup():
    jst, d = jcorpus.make_mpc_like(horizon=H, nx=2, nu=4, seed=3)
    jst = jst.with_gsplit(d.G, d.A)
    jst = jst.with_band_plan(jplan(jst, d.G, d.A))
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    jset = JSettings(kkt_strategy="banded")
    pset = Settings(kkt_strategy="banded")
    jeq = jequil(jst, *[jnp.asarray(getattr(d, f)) for f in "GAchb"])
    t = torch.tensor
    peq = equilibrate(st, t(pd.G), t(pd.A), t(pd.c)[None], t(pd.h)[None],
                      t(pd.b)[None])
    jctx = jkkt.make_context(jst, jeq.G, jeq.A, jset)
    pctx = kkt.make_context(st, peq.G, peq.A, pset)
    # an interior LP iterate for a non-identity scaling
    rng = np.random.default_rng(5)
    s = rng.random(st.m) * 3 + 0.01
    z = rng.random(st.m) * 3 + 0.01
    jscal, _ = jcones.update_scalings(jst.cone, jnp.asarray(s),
                                      jnp.asarray(z))
    pscal, _ = cones.update_scalings(st.cone, t(s)[None], t(z)[None])
    return dict(jst=jst, st=st, jset=jset, pset=pset, jeq=jeq, peq=peq,
                jctx=jctx, pctx=pctx, jscal=jscal, pscal=pscal)


@pytest.mark.parametrize("scaled", [False, True])
def test_band_blocks_match_dense_assembly(setup, scaled):
    """Kd/Ks of the direct scatter (Ks in the band layout at bandwidth 1)
    equal the reference's dense-assembled _band_views(K[perm][:, perm])
    within 1e-13 relative; the dump slot, element (0, 0) of Ks[0], is
    excluded (the factor never reads it)."""
    jst, st = setup["jst"], setup["st"]
    delta = setup["pset"].deltastat
    G = setup["jeq"].G
    if scaled:
        winv = 1.0 / (setup["jscal"].v_lp + delta)
        pwinv = 1.0 / (setup["pscal"].v_lp + delta)
    else:
        winv = jnp.full((st.l,), 1.0 / (1.0 + delta))
        pwinv = torch.full((1, st.l), 1.0 / (1.0 + delta),
                           dtype=torch.float64)
    with jax.default_matmul_precision("highest"):
        Hm = G.T @ (G * winv[:, None]) + delta * jnp.eye(st.n)
    K = jkkt._assemble_dense(jst, setup["jctx"], Hm, 0, None, None,
                             jnp.float64, setup["jset"])
    perm = np.asarray(jst.band.perm)
    Kd_ref, Kband = _band_views(K[perm][:, perm], 1, B)
    Ks_ref = np.asarray(Kband)[:, 0]
    Kd, Ks = kkt.band_blocks(st, setup["pctx"], pwinv, delta)
    Kd, Ks = Kd[0].numpy(), Ks[0, :, 0].numpy().copy()
    scale = np.abs(np.asarray(Kd_ref)).max()
    assert np.abs(Kd - np.asarray(Kd_ref)).max() / scale < 1e-13
    Ks[0, 0, 0] = Ks_ref[0, 0, 0]
    assert np.abs(Ks - Ks_ref).max() / scale < 1e-13


@pytest.mark.parametrize("scaled", [False, True])
def test_refined_solve_matches(setup, scaled):
    """One solve_refined with the init factor (identity scalings) or an
    interior scaling: dx, dy, dz within 1e-10 relative to their size, and
    the same refinement counts."""
    jst, st = setup["jst"], setup["st"]
    jeq, peq = setup["jeq"], setup["peq"]
    n, p, m = st.n, st.p, st.m
    jscal = setup["jscal"] if scaled else None
    pscal = setup["pscal"] if scaled else None
    rhs = np.stack([
        np.concatenate([np.zeros(n), np.asarray(jeq.b), np.asarray(jeq.h)]),
        np.concatenate([-np.asarray(jeq.c), np.zeros(p + m)]),
    ])
    js = jkkt.factor(jst, setup["jctx"], jscal, setup["jset"])
    ref = jkkt.solve_refined(jst, setup["jctx"], js, jscal, jnp.asarray(rhs),
                             setup["jset"])
    ps = kkt.factor(st, setup["pctx"], pscal, setup["pset"], 1)
    got = kkt.solve_refined(st, setup["pctx"], ps, pscal,
                            torch.tensor(rhs)[None], setup["pset"])
    for f in ("dx", "dy", "dz"):
        a, b = getattr(got, f)[0].numpy(), np.asarray(getattr(ref, f))
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-10, f
    np.testing.assert_array_equal(got.nitref[0].numpy(),
                                  np.asarray(ref.nitref))


def test_inactive_lanes_skip_refinement(setup):
    """Lanes marked inactive start stopped: their count stays 0 and the
    active lane's answer is unchanged."""
    st, pctx, pset = setup["st"], setup["pctx"], setup["pset"]
    rng = np.random.default_rng(1)
    rhs = torch.tensor(rng.standard_normal((1, 2, st.dim_kkt)))
    one = kkt.solve_refined(st, pctx, kkt.factor(st, pctx, None, pset, 1),
                            None, rhs, pset)
    two = kkt.solve_refined(st, pctx, kkt.factor(st, pctx, None, pset, 2),
                            None, rhs.expand(2, -1, -1).contiguous(), pset,
                            active=torch.tensor([True, False]))
    assert int(two.nitref[1].abs().sum()) == 0
    assert torch.equal(two.nitref[0], one.nitref[0])
    assert int(one.nitref.min()) >= 1
    for f in ("dx", "dy", "dz"):
        a, b = getattr(two, f)[0], getattr(one, f)[0]
        assert float((a - b).abs().max() / b.abs().max()) < 1e-14
