"""The port's batched cone algebra against eicos_tpu.cones (vmapped over
lanes) on a mixed LP + SOC cone: every function within 1e-13 relative."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu  # noqa: F401  (enables x64)
from eicos_tpu import cones as jc
from eicos_tpu.structure import ConeStructure as JCone

from eicos_tpu_torch import cones as pc
from eicos_tpu_torch.structure import ConeStructure

L, Q = 7, (3, 5)
LANES = 4
TOL = 1e-13


def interior(m, q, l, rng):
    v = rng.standard_normal(m)
    lp = np.abs(v[:l]) + 0.5
    soc = v[l:].copy()
    off = 0
    for d in q:
        soc[off] = np.linalg.norm(soc[off + 1:off + d]) + 0.5 + abs(soc[off])
        off += d
    return np.concatenate([lp, soc])


@pytest.fixture(scope="module")
def data():
    jst, st = JCone(l=L, q=Q), ConeStructure(l=L, q=Q)
    m = st.m
    rng = np.random.default_rng(11)
    s = np.stack([interior(m, Q, L, rng) for _ in range(LANES)])
    z = np.stack([interior(m, Q, L, rng) for _ in range(LANES)])
    u = rng.standard_normal((LANES, m))
    v = rng.standard_normal((LANES, m))
    tau = rng.random(LANES) + 0.5
    dtau = rng.standard_normal(LANES)
    kap = rng.random(LANES) + 0.5
    dkap = rng.standard_normal(LANES)
    jscal, jlam = jax.vmap(lambda a, b: jc.update_scalings(jst, a, b))(
        jnp.asarray(s), jnp.asarray(z))
    scal, lam = pc.update_scalings(st, torch.tensor(s), torch.tensor(z))
    return dict(jst=jst, st=st, s=s, z=z, u=u, v=v, tau=tau, dtau=dtau,
                kap=kap, dkap=dkap, jscal=jscal, jlam=jlam, scal=scal,
                lam=lam)


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err < TOL, err


def test_update_scalings(data):
    for f in data["jscal"]._fields:
        close(getattr(data["scal"], f), getattr(data["jscal"], f))
    close(data["lam"], data["jlam"])


def _vec(name, fn_j, fn_p):
    def test(data):
        jst, st = data["jst"], data["st"]
        u, jscal, scal = data["u"], data["jscal"], data["scal"]
        want = jax.vmap(lambda sc, x: fn_j(jst, sc, x))(jscal, jnp.asarray(u))
        close(fn_p(st, scal, torch.tensor(u)), want)
    test.__name__ = f"test_{name}"
    return test


test_scale = _vec("scale", jc.scale, pc.scale)
test_scale2 = _vec("scale2", jc.scale2, pc.scale2)
test_scale2_inv = _vec("scale2_inv", jc.scale2_inv, pc.scale2_inv)
test_scale2reg_inv = _vec(
    "scale2reg_inv", lambda st, sc, x: jc.scale2reg_inv(st, sc, 7e-8, x),
    lambda st, sc, x: pc.scale2reg_inv(st, sc, 7e-8, x))
test_scale_winv_soc = _vec(
    "scale_winv_soc", lambda st, sc, x: jc.scale_winv_soc(st, sc, x[L:]),
    lambda st, sc, x: pc.scale_winv_soc(st, sc, x[:, L:]))


def test_scale2_takes_stacked_columns(data):
    """Refinement applies W^2 to (lanes, k, m) stacks."""
    st, scal = data["st"], data["scal"]
    u = torch.tensor(np.stack([data["u"], data["v"]], 1))
    got = pc.scale2(st, scal, u)
    for j in range(2):
        close(got[:, j], pc.scale2(st, scal, u[:, j]))


def test_conic_product(data):
    jst, st = data["jst"], data["st"]
    w, mu = jax.vmap(lambda a, b: jc.conic_product(jst, a, b))(
        jnp.asarray(data["u"]), jnp.asarray(data["v"]))
    pw, pmu = pc.conic_product(st, torch.tensor(data["u"]),
                               torch.tensor(data["v"]))
    close(pw, w)
    close(pmu, mu)


def test_conic_division(data):
    jst, st = data["jst"], data["st"]
    want = jax.vmap(lambda a, b: jc.conic_division(jst, a, b))(
        jnp.asarray(data["s"]), jnp.asarray(data["v"]))
    close(pc.conic_division(st, torch.tensor(data["s"]),
                            torch.tensor(data["v"])), want)


def test_line_search(data):
    jst, st = data["jst"], data["st"]
    args = [data[k] for k in ("u", "v", "tau", "dtau", "kap", "dkap")]
    want = jax.vmap(lambda lam, a, b, t, dt, k, dk: jc.line_search(
        jst, lam, a, b, t, dt, k, dk, 1e-6, 0.999))(
        data["jlam"], *[jnp.asarray(a) for a in args])
    got = pc.line_search(st, data["lam"], *[torch.tensor(a) for a in args],
                         1e-6, 0.999)
    close(got, want)


@pytest.mark.parametrize("which", ["u", "s"])
def test_bring_to_cone(data, which):
    jst, st = data["jst"], data["st"]
    r = data[which]
    want = jax.vmap(lambda x: jc.bring_to_cone(jst, x, 0.99))(jnp.asarray(r))
    close(pc.bring_to_cone(st, torch.tensor(r), 0.99), want)


def test_w2_dense(data):
    jst, st = data["jst"], data["st"]
    want = jax.vmap(lambda sc: jc.w2_dense(jst, sc, jnp.float64))(
        data["jscal"])
    close(pc.w2_dense(st, data["scal"]), want)


def test_lp_only_cone(data):
    """An LP-only cone takes the SOC-free branches."""
    jst, st = JCone(l=5, q=()), ConeStructure(l=5, q=())
    rng = np.random.default_rng(2)
    s, z = rng.random((LANES, 5)) + 0.1, rng.random((LANES, 5)) + 0.1
    jscal, jlam = jax.vmap(lambda a, b: jc.update_scalings(jst, a, b))(
        jnp.asarray(s), jnp.asarray(z))
    scal, lam = pc.update_scalings(st, torch.tensor(s), torch.tensor(z))
    close(lam, jlam)
    close(pc.scale2(st, scal, torch.tensor(s)),
          jax.vmap(lambda sc, x: jc.scale2(jst, sc, x))(jscal, jnp.asarray(s)))
