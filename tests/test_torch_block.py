"""``Settings(block != 128)`` on the CPU against the JAX package, which
runs every strategy at any block size and reaches no Pallas leaf there:
the dense recursion and the banded scan on blocks of 64, the plain leaf,
and the inverse solves on a factor padded to 128."""

import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import corpus as jcorpus
from eicos_tpu.plan import make_band_plan as jplan

import eicos_tpu_torch as pt
from eicos_tpu_torch import corpus
from eicos_tpu_torch.ops import ldl
from eicos_tpu_torch.plan import make_band_plan


@pytest.mark.parametrize("strategy,horizon", [
    ("reduced", 8), ("banded", 8), ("banded", 20), ("full", 8)])
def test_block64_matches_jax(strategy, horizon):
    """``make_mpc_like(horizon, 2, 3, seed=1)`` at ``block=64`` (under
    "banded" a plan of 64-blocks: one block at horizon 8, three at 20):
    the same exit code and iteration count as the JAX package, objectives
    within 1e-8 relative."""
    jst, jd = jcorpus.make_mpc_like(horizon, 2, 3, seed=1)
    jst = jst.with_gsplit(jd.G, jd.A)
    st, d = corpus.make_mpc_like(horizon, 2, 3, seed=1)
    st = st.with_gsplit(d.G, d.A)
    if strategy == "banded":
        jst = jst.with_band_plan(jplan(jst, jd.G, jd.A, block=64))
        st = st.with_band_plan(make_band_plan(st, d.G, d.A, block=64))
        assert st.band.dim == jst.band.dim and st.band.dim % 64 == 0
    cfg = dict(kkt_strategy=strategy, block=64)
    ref = jt.solve(jst, jd, jt.Settings(**cfg))
    sol = pt.solve(st, d, pt.Settings(**cfg), device="cpu")
    assert int(sol.exit_code) == int(ref.exit_code) == 0
    assert int(sol.info.iter) == int(ref.info.iter)
    want = float(ref.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-8 * abs(want)


def test_block64_factor_pads_for_the_inverse_solves():
    """A factor whose Dp is a multiple of 64 and not of 128 is held padded
    to 128 (zero rows and columns of Linv, pivots 1), and a solve with it
    equals the unpadded one's arithmetic: K x = b to f64 accuracy."""
    rng = np.random.default_rng(2)
    D = 192
    M = rng.standard_normal((2, D, D)) / np.sqrt(D)
    K = M + M.transpose(0, 2, 1)
    sign = np.where(rng.random(D) < 0.5, 1.0, -1.0)
    K[:, np.arange(D), np.arange(D)] = sign * (2.0 + np.abs(K).sum(-1))
    fac = ldl.ldl_factor(torch.tensor(K), block=64)
    assert fac.Linv.shape == (2, 256, 256) and fac.d.shape == (2, 256)
    assert torch.all(fac.Linv[:, D:] == 0) and torch.all(fac.Linv[:, :, D:]
                                                          == 0)
    assert torch.all(fac.d[:, D:] == 1)
    b = rng.standard_normal((2, 3, D))
    x = ldl.ldl_solve(fac, torch.tensor(b)).numpy()
    assert x.shape == (2, 3, D)
    res = np.einsum("lij,lkj->lki", K, x) - b
    assert np.abs(res).max() <= 1e-11 * np.abs(b).max()
    with pytest.raises(ValueError):
        ldl.ldl_factor(torch.tensor(K[:, :160, :160]), block=64)
