"""The band LDL^T module of the port (ops/band_ldl.py plain twins, reached
through the ops/band.py wrappers on CPU tensors) against the JAX package:
its f64 banded factor (ops/band_ldl.py, XLA on the CPU) and its Pallas
double-single kernels in interpret mode (ops/pallas_band_ds.py)."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eicos_tpu  # noqa: F401  (enables x64)
from eicos_tpu.ops import band_ldl as jband
from eicos_tpu.ops import pallas_band_ds as jds

from eicos_tpu_torch.ops import band, kernels
from eicos_tpu_torch.ops.band_ldl import (KP, band_factor_plain,
                                          band_solve_plain)

B = 128


def band_quasidefinite(nb, seed):
    """Random quasidefinite block-tridiagonal blocks (Kd, Ks), Ks[0] = 0:
    mixed-sign diagonal, each row diagonally dominant, so every pivot of
    the unpivoted elimination is O(1)."""
    rng = np.random.default_rng(seed)
    D = nb * B
    Kd = 0.3 * rng.standard_normal((nb, B, B)) / np.sqrt(B)
    Kd = Kd + Kd.transpose(0, 2, 1)
    Ks = 0.3 * rng.standard_normal((nb, B, B)) / np.sqrt(B)
    Ks[0] = 0.0
    rows = np.abs(Kd).sum(-1) + np.abs(Ks).sum(-1)
    rows[:-1] += np.abs(Ks[1:]).sum(-2)
    sign = np.where(rng.random(D) < 0.6, 1.0, -1.0).reshape(nb, B)
    for k in range(nb):
        Kd[k][np.arange(B), np.arange(B)] = sign[k] * (1.0 + rows[k])
    return Kd, Ks


def dense_from_blocks(Kd, Ks):
    nb = Kd.shape[0]
    K = np.zeros((nb * B, nb * B))
    for k in range(nb):
        K[k * B:(k + 1) * B, k * B:(k + 1) * B] = Kd[k]
        if k:
            K[k * B:(k + 1) * B, (k - 1) * B:k * B] = Ks[k]
            K[(k - 1) * B:k * B, k * B:(k + 1) * B] = Ks[k].T
    return K


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def case():
    nb, lanes = 3, 2
    blocks = [band_quasidefinite(nb, seed) for seed in range(lanes)]
    Kd = np.stack([b[0] for b in blocks])
    Ks = np.stack([b[1] for b in blocks])
    fac = band.band_factor(torch.tensor(Kd), torch.tensor(Ks))
    return Kd, Ks, fac


def test_factor_matches_f64_reference(case):
    """band_factor on CPU tensors (the plain twin) vs band_ldl_factor at
    bwb = 1, f64, no Pallas: the same elimination in IEEE f64, so within
    1e-11 relative (summation order only)."""
    Kd, Ks, fac = case
    for lane in range(Kd.shape[0]):
        ref = jband.band_ldl_factor(
            jnp.asarray(dense_from_blocks(Kd[lane], Ks[lane])), 1,
            use_pallas="off")
        assert rel(fac.L[lane], np.asarray(ref.Lband)[:, 0]) < 1e-11
        assert rel(fac.Dinv[lane], ref.Dinv) < 1e-11
        assert rel(fac.d[lane].reshape(-1), ref.d) < 1e-11


def test_factor_matches_pallas_interpret(case):
    """vs the TPU kernel _band_factor_ds_impl in interpret mode (hi + lo
    pairs): within 1e-9, the double-single scheme's ~2^-48 times the
    conditioning of these blocks."""
    Kd, Ks, fac = case
    Lh, Ll, Dh, Dl, dh, dl = jds._band_factor_ds_impl(
        jnp.asarray(Kd[0]), jnp.asarray(Ks[0]), interpret=True)
    f64 = np.float64
    assert rel(fac.L[0], np.asarray(Lh, f64) + np.asarray(Ll, f64)) < 1e-9
    assert rel(fac.Dinv[0], np.asarray(Dh, f64) + np.asarray(Dl, f64)) < 1e-9
    d = np.asarray(dh, f64)[:, 0] + np.asarray(dl, f64)[:, 0]
    assert rel(fac.d[0], d) < 1e-9


def test_factor_serves_lane_tiled_kernel():
    """The lane-tiled TPU factor _band_factor_ds_batch (reached only from
    tests and tools) computes the same function: one port kernel serves
    the single-lane and the lane-tiled Pallas kernels.  Within 1e-9."""
    Kd, Ks = (a[None] for a in band_quasidefinite(2, 7))
    fac = band.band_factor(torch.tensor(Kd), torch.tensor(Ks))
    Lh, Ll, Dh, Dl, dh, dl = jds._band_factor_ds_batch(
        jnp.asarray(Kd), jnp.asarray(Ks), T=1, interpret=True)
    f64 = np.float64
    assert rel(fac.L, np.asarray(Lh, f64) + np.asarray(Ll, f64)) < 1e-9
    assert rel(fac.Dinv, np.asarray(Dh, f64) + np.asarray(Dl, f64)) < 1e-9
    assert rel(fac.d, np.asarray(dh, f64)[:, :, 0]
               + np.asarray(dl, f64)[:, :, 0]) < 1e-9


@pytest.mark.parametrize("k", [1, 2, KP])
def test_solve_matches_f64_reference(case, k):
    """band_solve vs band_ldl_solve (f64) within 1e-11 relative, for k
    right-hand sides in the (k, D) layout of band_solve_ds."""
    Kd, Ks, fac = case
    rng = np.random.default_rng(10 + k)
    nb = Kd.shape[1]
    rhs = rng.standard_normal((Kd.shape[0], k, nb * B))
    x = band.band_solve(fac, torch.tensor(rhs)).numpy()
    for lane in range(Kd.shape[0]):
        K = dense_from_blocks(Kd[lane], Ks[lane])
        ref_fac = jband.band_ldl_factor(jnp.asarray(K), 1, use_pallas="off")
        ref = np.asarray(jband.band_ldl_solve(
            ref_fac, jnp.asarray(rhs[lane].T), 1)).T
        assert rel(x[lane], ref) < 1e-11
        # and it solves the system: f64 backward error
        assert rel(x[lane] @ K, rhs[lane]) < 1e-12


def test_solve_matches_pallas_interpret(case):
    """vs band_solve_ds in interpret mode (KP rows, D columns) within
    1e-9: the double-single factor and sweeps."""
    Kd, Ks, fac = case
    rng = np.random.default_rng(4)
    nb = Kd.shape[1]
    rhs = rng.standard_normal((KP, nb * B))
    dsfac = jds._band_factor_ds_impl(jnp.asarray(Kd[0]), jnp.asarray(Ks[0]),
                                     interpret=True)
    ref = np.asarray(jds.band_solve_ds(dsfac, jnp.asarray(rhs),
                                       interpret=True))
    x = band.band_solve(
        band.BandFactors(fac.L[:1], fac.Dinv[:1], fac.d[:1]),
        torch.tensor(rhs[None]))[0].numpy()
    assert rel(x, ref) < 1e-9


def test_dump_slot_is_never_read(case):
    """The KKT scatter sends out-of-band contributions to element (0, 0)
    of Ks[0]; garbage there leaves the factor exactly unchanged."""
    Kd, Ks, fac = case
    Ks2 = Ks.copy()
    Ks2[:, 0, 0, 0] = 1e300
    Ks2[:, 0, 5, 7] = -3.0
    fac2 = band.band_factor(torch.tensor(Kd), torch.tensor(Ks2))
    for a, b in zip(fac, fac2):
        assert torch.equal(a, b)


def test_fwd_bwd_compose_to_solve(case):
    """band_solve is band_bwd after band_fwd, and the plain twins are what
    the wrappers run on CPU tensors (no kernel launch is counted)."""
    Kd, Ks, fac = case
    rhs = torch.tensor(np.random.default_rng(5).standard_normal(
        (Kd.shape[0], 3, Kd.shape[1] * B)))
    before = dict(kernels.COUNTS)
    x = band.band_bwd(fac, band.band_fwd(fac, rhs))
    assert torch.equal(x, band_solve_plain(fac, rhs))
    fac_p = band_factor_plain(torch.tensor(Kd), torch.tensor(Ks))
    assert all(torch.equal(a, b) for a, b in zip(fac, fac_p))
    assert kernels.COUNTS == before


def test_wrapper_takes_only_cuda_or_cpu():
    """A tensor on any other device neither launches nor runs the twin."""
    t = torch.empty(1, 1, B, B, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError):
        band.band_factor(t, t)
