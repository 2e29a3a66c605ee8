"""``gemm.matmul``'s structure flags on the CPU, where the wrapper runs its
plain version: a lower-only result leaves the rest of ``c`` bit for bit,
the triangular-operand flags change no value, and the dense recursion,
which passes the flags at its six products, keeps the bits it had without
them (held against an inline copy of the unflagged recursion)."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

from eicos_tpu_torch.ops import gemm, ldl
from eicos_tpu_torch.ops.dense import pack_dense_plain
from eicos_tpu_torch.ops.leaf import leaf_ldl

B = 128


def bits(t):
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64
                               else torch.int32)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.0, 1.0), (2.0, 0.5)])
@pytest.mark.parametrize("fn", [gemm.matmul, gemm.matmul_plain],
                         ids=["matmul", "plain"])
def test_c_lower_writes_the_lower_triangle_only(fn, alpha, beta):
    """The elements with column <= row get the bits of the unflagged
    product; the strict upper triangle keeps its bits, signed zeros and
    NaNs included, also when c is a block of a larger matrix."""
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.standard_normal((3, 70, 40)))
    b = torch.tensor(rng.standard_normal((3, 90, 40))).transpose(-1, -2)
    big = torch.tensor(rng.standard_normal((3, 100, 120)))
    up = torch.ones(70, 90, dtype=torch.bool).triu(1)
    c = big[:, 10:80, 20:110]
    c[:, up] = torch.tensor([-0.0, float("nan"), 1.5], dtype=c.dtype).repeat(
        int(up.sum()) // 3 + 1)[:int(up.sum())]
    before = big.clone()
    want = gemm.matmul_plain(a, b, c.clone(), alpha, beta)
    kw = dict(c=c, alpha=alpha, beta=beta, c_lower=True)
    out = fn(a, b, **kw) if fn is gemm.matmul else fn(a, b, c, alpha, beta,
                                                      True)
    assert out is c
    assert torch.equal(bits(c[:, ~up]), bits(want[:, ~up]))
    assert torch.equal(bits(c[:, up]), bits(before[:, 10:80, 20:110][:, up]))
    outside = torch.ones(100, 120, dtype=torch.bool)
    outside[10:80, 20:110] = False
    assert torch.equal(bits(big[:, outside]), bits(before[:, outside]))


@pytest.mark.parametrize("side,tri", [("a", "lower"), ("a", "upper"),
                                      ("b", "lower"), ("b", "upper")])
def test_triangular_flags_change_no_value(side, tri):
    """On exactly triangular operands the flagged product has the bits of
    ``torch.matmul``'s, as a plain view (a) or a transpose (b) alike."""
    rng = np.random.default_rng(2)
    mask = torch.tril if tri == "lower" else torch.triu
    if side == "a":
        a = mask(torch.tensor(rng.standard_normal((2, 150, 150))))
        b = torch.tensor(rng.standard_normal((2, 150, 37)))
    else:
        a = torch.tensor(rng.standard_normal((2, 37, 150)))
        b = mask(torch.tensor(rng.standard_normal((2, 150, 150))).transpose(
            -1, -2))
    got = gemm.matmul(a, b, **{f"{side}_tri": tri})
    assert torch.equal(bits(got), bits(torch.matmul(a, b)))


@pytest.mark.parametrize("kw", [dict(a_tri="lower"), dict(b_tri="upper"),
                                dict(a_tri="diagonal"), dict(c_lower=True)],
                         ids=["a-not-square", "b-not-square", "bad-name",
                              "c_lower-without-c"])
def test_flags_are_checked(kw):
    a, b = torch.zeros(2, 4, 5, dtype=torch.float64), torch.zeros(
        2, 5, 3, dtype=torch.float64)
    if kw.get("a_tri") == "diagonal":
        a = torch.zeros(2, 5, 5, dtype=torch.float64)
    with pytest.raises(ValueError):
        gemm.matmul(a, b, **kw)


# ------------------------------------------- the unflagged recursion

def _rec_unflagged(K, Linv, d):
    """``ldl._ldl_rec`` as it was before the flags: full products, the
    Schur update into all of K22."""
    D = K.shape[-1]
    if D <= B:
        leaf_ldl(K, out=(Linv, d))
        return
    h = (D // B // 2) * B
    L11inv, d1 = Linv[:, :h, :h], d[:, :h]
    _rec_unflagged(K[:, :h, :h], L11inv, d1)
    L21 = torch.matmul(K[:, h:, :h], L11inv.transpose(-1, -2))
    L21 /= d1[:, None, :]
    K22 = K[:, h:, h:]
    K22.add_(-torch.matmul(L21 * d1[:, None, :], L21.transpose(-1, -2)))
    L22inv = Linv[:, h:, h:]
    _rec_unflagged(K22, L22inv, d[:, h:])
    Linv[:, h:, :h].copy_(-torch.matmul(L22inv, torch.matmul(L21, L11inv)))


def _rec_subst_unflagged(K, Linv, Xinv, d):
    """``ldl._ldl_rec_subst`` as it was before the flags."""
    D = K.shape[-1]
    if D <= B:
        leaf_ldl(K, out=(Xinv[:, 0], d))
        if Linv is not None:
            Linv.copy_(Xinv[:, 0])
        return
    h = (D // B // 2) * B
    d1 = d[:, :h]
    L11inv = K.new_zeros(K.shape[0], h, h) if Linv is None else Linv[:, :h, :h]
    _rec_subst_unflagged(K[:, :h, :h], L11inv, Xinv[:, :h // B], d1)
    L21 = torch.matmul(K[:, h:, :h], L11inv.transpose(-1, -2))
    L21 /= d1[:, None, :]
    K22 = K[:, h:, h:]
    K22.add_(-torch.matmul(L21 * d1[:, None, :], L21.transpose(-1, -2)))
    K[:, h:, :h] = L21
    if Linv is None:
        _rec_subst_unflagged(K22, None, Xinv[:, h // B:], d[:, h:])
        return
    L22inv = Linv[:, h:, h:]
    _rec_subst_unflagged(K22, L22inv, Xinv[:, h // B:], d[:, h:])
    Linv[:, h:, :h].copy_(-torch.matmul(L22inv, torch.matmul(L21, L11inv)))


def _quasidefinite(lanes, D, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((lanes, D, D)) / np.sqrt(D)
    M = 0.5 * (M + M.transpose(0, 2, 1))
    sign = np.where(np.arange(D) < 2 * D // 3, 1.0, -1.0)
    M[:, np.arange(D), np.arange(D)] = sign * (1.0 + np.abs(M).sum(-1))
    return torch.tensor(M, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("D", [384, 640])
def test_ldl_factor_keeps_its_bits(D, dtype):
    """d, Linv and the lower triangle of the consumed K of the flagged
    recursion have the unflagged recursion's bits."""
    K = _quasidefinite(2, D, D, dtype)
    K_new, K_old = K.clone(), K.clone()
    fac = ldl.ldl_factor(K_new)
    Linv = torch.zeros_like(K)
    d = K.new_empty(2, D)
    _rec_unflagged(K_old, Linv, d)
    assert torch.equal(bits(fac.d), bits(d))
    assert torch.equal(bits(fac.Linv), bits(Linv))
    assert torch.equal(bits(torch.tril(K_new)), bits(torch.tril(K_old)))


@pytest.mark.parametrize("D", [384, 640, 1152])
def test_ldl_factor_subst_keeps_its_bits(D):
    """The substitution form's pivots, leaf inverses and packed L have the
    unflagged recursion's bits."""
    K = _quasidefinite(2, D, D + 1)
    K_old = K.clone()
    fac = ldl.ldl_factor_subst(K.clone())
    Xinv = K.new_empty(2, D // B, B, B)
    d = K.new_empty(2, D)
    _rec_subst_unflagged(K_old, None, Xinv, d)
    assert torch.equal(bits(fac.d), bits(d))
    assert torch.equal(bits(fac.pre.Xinv), bits(Xinv))
    assert torch.equal(bits(fac.pre.Lp), bits(pack_dense_plain(K_old)))
