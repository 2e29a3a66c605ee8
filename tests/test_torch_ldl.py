"""The port's dense LDL^T pieces (ops/leaf.py, ops/gemm.py, ops/ldl.py) on
the CPU, where each wrapper runs its plain version, against the JAX
package: the Pallas kernels they replace in interpret mode (K9/K10, K13,
K14), and the f64 recursion ``eicos_tpu.ops.ldl`` that the JAX package
runs on the CPU.

Tolerances: the GEMM kernels compute in double-single, about 2^-48 an
operation, so against them the plain versions agree to 1e-12 relative.
The double-single leaf kernels (K9/K10) are less exact: against an LDL^T
in extended precision (``np.longdouble``) their pivots are off by up to
2.5e-11 and their inverses by up to 8.1e-10 relative on the blocks below,
where the plain leaf is within 1.3e-15; so the plain leaf is held to the
extended-precision factor at 1e-14, and to the TPU kernels at 1e-10 (d)
and 5e-9 (Linv).  Against the JAX package's own f64 path, which differs
only in summation order: 1e-12 (factor, compounded over the recursion)
and 1e-13 (one solve)."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu  # noqa: F401  (enables x64)
from eicos_tpu.ops import ldl as jldl
from eicos_tpu.ops import pallas_gemm_ds as pg
from eicos_tpu.ops.pallas_leaf_ds import _leaf_ds_batch, leaf_ldl_pallas_ds

from eicos_tpu_torch.ops import gemm, ldl, leaf

B = 128


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def quasidefinite(D, rng, pos=None):
    """A symmetric quasidefinite D x D matrix: a positive definite leading
    block of ``pos`` rows (all rows by default), a negative definite
    trailing block, coupled by a random off-diagonal block."""
    pos = D if pos is None else pos
    M = rng.standard_normal((D, D)) / np.sqrt(D)
    M = 0.5 * (M + M.T)
    rows = np.abs(M).sum(1)
    sign = np.where(np.arange(D) < pos, 1.0, -1.0)
    M[np.arange(D), np.arange(D)] = sign * (1.0 + rows)
    return M


def ldl_extended(M):
    """(Linv, d) of the unpivoted LDL^T of M in extended precision."""
    W = M.astype(np.longdouble)
    n = len(M)
    L = np.eye(n, dtype=np.longdouble)
    d = np.zeros(n, np.longdouble)
    for j in range(n):
        d[j] = W[j, j]
        col = W[j + 1:, j] / d[j]
        L[j + 1:, j] = col
        W[j + 1:, j + 1:] -= d[j] * np.outer(col, col)
    X = np.eye(n, dtype=np.longdouble)
    for i in range(n):                 # L X = I by substitution
        X[i] -= L[i, :i] @ X[:i]
    return X.astype(np.float64), d.astype(np.float64)


@pytest.fixture(scope="module")
def leaves():
    """3 lanes of A A' + 128 I and one mixed-sign quasidefinite block."""
    rng = np.random.default_rng(11)
    blocks = []
    for _ in range(3):
        A = rng.standard_normal((B, B))
        blocks.append(A @ A.T + B * np.eye(B))
    blocks.append(quasidefinite(B, rng, pos=80))
    return np.stack(blocks)


def test_leaf_plain_matches_tiled_kernel(leaves):
    """K10, the lane-tiled leaf, at T = 2, and the extended-precision
    factor of every block."""
    Linv_j, d_j = _leaf_ds_batch(jnp.asarray(leaves), T=2, interpret=True)
    Linv, d = leaf.leaf_ldl(torch.tensor(leaves))
    for i in range(len(leaves)):
        X, dx = ldl_extended(leaves[i])
        assert rel(d[i], dx) < 1e-14, i
        assert rel(Linv[i], X) < 1e-14, i
        assert rel(d[i], d_j[i]) < 1e-10, i
        assert rel(Linv[i], Linv_j[i]) < 5e-9, i


def test_leaf_plain_matches_single_kernel(leaves):
    """K9, one block a grid step, on the mixed-sign block; and the
    factor itself: Linv M Linv' = diag(d)."""
    M = leaves[-1]
    _, d_j, Linv_j = leaf_ldl_pallas_ds(jnp.asarray(M[None]), interpret=True)
    Linv, d = leaf.leaf_ldl(torch.tensor(M[None]))
    assert rel(d[0], d_j[0]) < 1e-10
    assert rel(Linv[0], Linv_j[0]) < 5e-9
    X = Linv[0].numpy()
    assert np.all(np.triu(X, 1) == 0.0)
    resid = X @ M @ X.T - np.diag(d[0].numpy())
    assert np.abs(resid).max() / np.abs(M).max() < 1e-12


def test_leaf_writes_into_views(leaves):
    """``out=`` views of a larger factor receive the same values."""
    Ms = torch.tensor(leaves)
    big = torch.zeros(4, 2 * B, 2 * B, dtype=torch.float64)
    dbig = torch.zeros(4, 2 * B, dtype=torch.float64)
    leaf.leaf_ldl(Ms, out=(big[:, B:, B:], dbig[:, B:]))
    Linv, d = leaf.leaf_ldl(Ms)
    assert torch.equal(big[:, B:, B:], Linv) and torch.equal(dbig[:, B:], d)
    assert not big[:, :B].any()


def test_matmul_plain_matches_batched_kernel(monkeypatch):
    """K13 (``_bmatmul_ds``, interpret mode) on a ragged 37x150x77 case."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 37, 150))
    b = rng.standard_normal((3, 150, 77))
    monkeypatch.setattr(pg, "_BMM_INTERPRET", True)
    want = np.asarray(pg._bmatmul_ds(jnp.asarray(a), jnp.asarray(b)))
    got = gemm.matmul(torch.tensor(a), torch.tensor(b))
    assert rel(got, want) < 1e-12


def test_matmul_plain_shared_operand_and_views():
    """K12's form, one right operand for every lane, against the f64 ``_mm``
    of the JAX recursion; transposed views and the fused beta form."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 37, 150))
    b = rng.standard_normal((150, 77))
    want = np.stack([np.asarray(jldl._mm(jnp.asarray(x), jnp.asarray(b),
                                         False)) for x in a])
    assert rel(gemm.matmul(torch.tensor(a), torch.tensor(b)), want) < 1e-14
    # a @ bT.T read in place, then c <- c - a @ bT.T
    bT = torch.tensor(rng.standard_normal((3, 77, 150)))
    c0 = torch.tensor(rng.standard_normal((3, 37, 77)))
    c = c0.clone()
    out = gemm.matmul(torch.tensor(a), bT.transpose(-1, -2), c=c, alpha=-1.0,
                      beta=1.0)
    assert out is c
    ref = c0.numpy() - a @ bT.numpy().transpose(0, 2, 1)
    assert rel(c, ref) < 1e-14
    # beta = 0 ignores what c held
    c.fill_(np.nan)
    gemm.matmul(torch.tensor(a), bT.transpose(-1, -2), c=c)
    assert rel(c, a @ bT.numpy().transpose(0, 2, 1)) < 1e-14


@pytest.fixture(scope="module")
def factor384():
    """2 lanes of a quasidefinite 384 x 384 matrix (nb = 3: splits 1 | 2)
    and the JAX package's f64 factor of each."""
    rng = np.random.default_rng(6)
    K = np.stack([quasidefinite(384, rng, pos=250) for _ in range(2)])
    ref = [jldl.ldl_factor(jnp.asarray(k), use_pallas="off") for k in K]
    return K, ref


def test_linv_solve_plain_matches_prechunked_kernel(factor384, monkeypatch):
    """K14 (``PrechunkedOperand.rmatmul``, interpret mode) for both passes,
    and ``ldl_solve`` against the JAX package's f64 ``ldl_solve``."""
    K, ref = factor384
    Linv = np.asarray(ref[0].Linv)
    d = np.asarray(ref[0].d)
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((2, 384))
    hi = Linv.astype(np.float32)
    lo = (Linv - hi.astype(np.float64)).astype(np.float32)
    monkeypatch.setattr(pg, "_PRE_INTERPRET", True)
    t_j = np.asarray(pg.PrechunkedOperand(
        jnp.asarray(hi), jnp.asarray(lo), transpose_b=True).rmatmul(
            jnp.asarray(rhs))) / d[None, :]
    x_j = np.asarray(pg.PrechunkedOperand(
        jnp.asarray(hi), jnp.asarray(lo), transpose_b=False).rmatmul(
            jnp.asarray(t_j)))
    Lt, dt = torch.tensor(Linv)[None], torch.tensor(d)[None]
    t = gemm.linv_fwd(Lt, dt, torch.tensor(rhs)[None])
    assert rel(t[0], t_j) < 1e-12
    x = gemm.linv_bwd(Lt, t)
    assert rel(x[0], x_j) < 1e-12
    want = np.asarray(jldl.ldl_solve(ref[0], jnp.asarray(rhs.T))).T
    got = ldl.ldl_solve(ldl.LDLFactors(Linv=Lt, d=dt), torch.tensor(rhs)[None])
    assert rel(got[0], want) < 1e-13


@pytest.mark.parametrize("D", [384, 640])
def test_ldl_factor_matches_jax(D, factor384):
    """Batched factor at Dp = 384 and 640 (uneven splits) against JAX's
    ``ldl_factor`` lane by lane; then one solve's residual."""
    if D == 384:
        K, ref = factor384
    else:
        rng = np.random.default_rng(8)
        K = np.stack([quasidefinite(D, rng, pos=400) for _ in range(2)])
        ref = [jldl.ldl_factor(jnp.asarray(k), use_pallas="off") for k in K]
    fac = ldl.ldl_factor(torch.tensor(K))
    for i in range(2):
        assert rel(fac.Linv[i], ref[i].Linv) < 1e-12, i
        assert rel(fac.d[i], ref[i].d) < 1e-12, i
    assert torch.all(torch.triu(fac.Linv, 1) == 0.0)
    rhs = np.random.default_rng(9).standard_normal((2, 3, D))
    x = ldl.ldl_solve(fac, torch.tensor(rhs)).numpy()
    resid = np.einsum("lij,lkj->lki", K, x) - rhs
    assert np.abs(resid).max() / np.abs(rhs).max() < 1e-12


def test_ldl_factor_rejects_unpadded():
    with pytest.raises(ValueError):
        ldl.ldl_factor(torch.zeros(1, 200, 200, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_leaf_plain_clamps_pivots_like_reference(dtype):
    """A block with a zero row and column has a zero pivot: the plain leaf
    clamps it to 1e-150 in f64 (1e-20 in f32), as the reference's
    ``_unblocked_ldl`` does, and gives its d and L to 1e-12 (f64; XLA
    fuses the update in another order) or 1e-5 (f32), with no NaN."""
    rng = np.random.default_rng(9)
    M = rng.standard_normal((128, 128)) / np.sqrt(128)
    M = 0.5 * (M + M.T)
    M[np.arange(128), np.arange(128)] = np.where(
        np.arange(128) < 70, 1.0, -1.0) * (1.0 + np.abs(M).sum(1))
    M[37, :] = M[:, 37] = 0.0
    M = M.astype(dtype)
    L, d = leaf._unblocked_ldl(torch.tensor(M)[None])
    jL, jd = jldl._unblocked_ldl(jnp.asarray(M))
    tiny = 1e-150 if dtype == np.float64 else 1e-20
    assert d[0, 37].item() == np.asarray(jd)[37] == dtype(tiny)
    assert torch.isfinite(L).all() and torch.isfinite(d).all()
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(d[0].numpy(), np.asarray(jd), rtol=tol)
    np.testing.assert_allclose(L[0].numpy(), np.asarray(jL), rtol=tol,
                               atol=tol * 1e-3)
