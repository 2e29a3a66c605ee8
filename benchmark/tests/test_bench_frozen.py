"""The frozen copies against what they were copied from."""

import numpy as np
import pytest

import frozen
import mixes


@pytest.mark.parametrize("family,horizon,nx,nu,seed", [
    ("mpc_like", 6, 2, 4, 3), ("mpc_like", 5, 3, 2, 11)])
def test_generators_equal_the_corpus(family, horizon, nx, nu, seed):
    from eicos_tpu_torch import corpus

    st, want = getattr(corpus, "make_" + family)(horizon=horizon, nx=nx,
                                                  nu=nu, seed=seed)
    make = mixes.family(family)
    G, A, c, h, b, l, q = make(dict(horizon=horizon, nx=nx, nu=nu), seed)
    for name, got in dict(G=G, A=A, c=c, h=h, b=b).items():
        np.testing.assert_array_equal(got, getattr(want, name), name)
    assert (l, tuple(q)) == (st.l, tuple(st.q))


def test_lanes_perturb_c_and_the_initial_state_only():
    rng = np.random.default_rng(0)
    c, b = np.arange(5.0), np.arange(4.0)
    C, Bv = frozen.perturbed_lanes(rng, c, b, 3, 2, 2, 0.02, 0.05)
    assert C.shape == (3, 2, 5) and Bv.shape == (3, 2, 4)
    np.testing.assert_array_equal(Bv[:, :, 2:], np.broadcast_to(b[2:],
                                                                (3, 2, 2)))
    assert np.all(Bv[:, :, :2] != b[:2]) and np.all(C != c)


def test_band_factor_work_is_chip_smoke_pr3_count():
    # chip_smoke.py's bw-1 record: 128 lanes, nb 16
    nbytes, ops = frozen.band_factor_work(128, 16)
    B = 128
    assert nbytes == 128 * 16 * (4 * B * B * 8 + B * 8)
    assert ops == 128 * (15 * 2 * B ** 3 + 16 * (B ** 3 // 2 + B ** 3 // 3))
    ms, by = frozen.bound(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_random_band_is_quasidefinite_and_seeded():
    import torch

    Kd, Ks = frozen.random_band(torch, 2, 3, 2 ** 33 + 7, "cpu")
    Kd2, _ = frozen.random_band(torch, 2, 3, 2 ** 33 + 7, "cpu")
    assert torch.equal(Kd, Kd2)
    assert torch.all(Ks[:, 0] == 0)
    assert torch.equal(Kd, Kd.transpose(-1, -2))
    diag = Kd.diagonal(dim1=-2, dim2=-1).abs()
    off = Kd.abs().sum(-1) - diag + Ks.abs().sum(-1)
    off[:, :-1] += Ks[:, 1:].abs().sum(-2)
    assert torch.all(diag > off)
