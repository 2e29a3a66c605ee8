"""The port on the card: its CUDA kernels against their plain twins, at
small shapes and at the shapes of the paths, and each path of the solver
at full size (``test_path_at_full_size``) against the CPU plain path, its
eager segments and its own repeats.  These tests need an NVIDIA GPU and
nvcc (a CUDA kernel has no CPU mode) and skip elsewhere; run them on a GPU
machine (which has no JAX: ``--noconftest``) with

    python3 -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import torch_threads  # noqa: F401  (one torch thread a worker)

import json
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

B = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def band_case(lanes, nb, seed):
    rng = np.random.default_rng(seed)
    Kd = 0.3 * rng.standard_normal((lanes, nb, B, B)) / np.sqrt(B)
    Kd = Kd + Kd.transpose(0, 1, 3, 2)
    Ks = 0.3 * rng.standard_normal((lanes, nb, B, B)) / np.sqrt(B)
    Ks[:, 0] = 0.0
    rows = np.abs(Kd).sum(-1) + np.abs(Ks).sum(-1)
    rows[:, :-1] += np.abs(Ks[:, 1:]).sum(-2)
    sign = np.where(rng.random((lanes, nb, B)) < 0.6, 1.0, -1.0)
    Kd[:, :, np.arange(B), np.arange(B)] = sign * (1.0 + rows)
    return Kd, Ks


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


CONE_KERNELS = ("cone_scalings", "cone_eig", "cone_rotate",
                "cone_line_search")


def factor_name(lanes, bw=1):
    """The ``kernels.COUNTS`` name of the band factor kernel that
    ``ops/band.band_factor_bw`` launches on this card for ``lanes`` lanes
    at block bandwidth ``bw``: one CTA a lane, or a cluster of them where
    the lanes leave SMs idle (``band.clusters``)."""
    from eicos_tpu_torch.ops import band

    if band.clusters(lanes, bw, torch.device("cuda")) > 1:
        return "band_factor_cluster"
    return "band_factor_bw"


def test_band_kernels_match_plain(cuda):
    """Block bandwidth 1 on the card runs the band kernels and matches the
    plain twins within 1e-10 relative (the two differ in summation order
    and in how the leaf inverse is formed, by blocks against
    Newton-Schulz)."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    Kd, Ks = (torch.tensor(a, device=cuda) for a in band_case(3, 4, 0))
    Ks = Ks[:, :, None]
    before = dict(kernels.COUNTS)
    fk = band.band_factor(Kd, Ks)
    fp = plain.band_factor_bw_plain(Kd, Ks)
    for a, b in zip(fk, fp):
        assert rel(a, b) < 1e-10
    rng = np.random.default_rng(1)
    for k in (1, 2, 16):
        r = torch.tensor(rng.standard_normal((3, k, 4 * B)), device=cuda)
        assert rel(band.band_fwd(fk, r), plain.band_fwd_bw_plain(fk, r)) \
            < 1e-10
        assert rel(band.band_bwd(fk, r), plain.band_bwd_bw_plain(fk, r)) \
            < 1e-10
    torch.cuda.synchronize()
    name = factor_name(3)
    assert kernels.COUNTS[name] == before[name] + 1
    assert kernels.COUNTS["band_fwd_bw"] == before["band_fwd_bw"] + 3
    assert kernels.COUNTS["band_bwd_bw"] == before["band_bwd_bw"] + 3


def test_band_wrappers_check_inputs(cuda):
    from eicos_tpu_torch.ops import band

    Kd, Ks = (torch.tensor(a, device=cuda) for a in band_case(1, 2, 2))
    with pytest.raises(ValueError):
        band.band_factor_bw(Kd.float(), Ks[:, :, None].float())
    fac = band.band_factor(Kd, Ks)
    with pytest.raises(ValueError):
        band.band_solve(fac, torch.zeros(1, 17, 2 * B, dtype=torch.float64,
                                         device=cuda))


def test_solver_on_card_matches_cpu(cuda):
    """Two lanes of a small MPC LP: the kernels' solve and the CPU plain
    path give the same exit codes and iteration counts, and every band
    kernel was launched."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.plan import make_band_plan

    st, base = corpus.make_mpc_like(horizon=30, nx=2, nu=4, seed=3)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(2)]
    batch = pt.BatchedSolver.stack(probs, shared=("G", "A", "h"))
    settings = pt.Settings(kkt_strategy="banded")
    kernels.reset_counts()
    gpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h")).solve(batch)
    assert all(kernels.COUNTS[n] > 0
               for n in (factor_name(2), "band_fwd_bw", "band_bwd_bw"))
    cpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)


def quasidefinite(lanes, D, pos, seed):
    """Symmetric quasidefinite (lanes, D, D) blocks: positive diagonal
    on the first ``pos`` rows, negative after, every row dominant."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((lanes, D, D)) / np.sqrt(D)
    M = 0.5 * (M + M.transpose(0, 2, 1))
    rows = np.abs(M).sum(-1)
    sign = np.where(np.arange(D) < pos, 1.0, -1.0)
    M[:, np.arange(D), np.arange(D)] = sign * (1.0 + rows)
    return M


def test_leaf_kernel_matches_plain_and_band_leaf(cuda):
    """leaf_ldl against its plain version within 1e-10 relative (summation
    order, and a substitution inverse against Newton-Schulz), read from and
    written to strided views, ||Linv M Linv' - diag(d)|| within 1e-9 of
    ||diag(d)||; and bit for bit the band factor's first leaf, which runs
    the same device code."""
    from eicos_tpu_torch.ops import band, kernels, leaf

    M = torch.tensor(quasidefinite(3, 2 * B, 150, 3), device=cuda)
    blk = M[:, B:, B:]
    before = kernels.COUNTS["leaf_ldl"]
    Linv = torch.zeros(3, 2 * B, 2 * B, dtype=torch.float64, device=cuda)
    d = torch.zeros(3, 2 * B, dtype=torch.float64, device=cuda)
    leaf.leaf_ldl(blk, out=(Linv[:, :B, B:], d[:, B:]))
    Lp, dp = leaf.leaf_ldl_plain(blk)
    torch.cuda.synchronize()
    assert kernels.COUNTS["leaf_ldl"] == before + 1
    assert rel(Linv[:, :B, B:], Lp) < 1e-10 and rel(d[:, B:], dp) < 1e-10
    assert not Linv[:, B:].any() and not Linv[:, :B, :B].any()
    Li = Linv[:, :B, B:]
    assert rel(Li @ blk @ Li.transpose(-1, -2), torch.diag_embed(d[:, B:])) \
        < 1e-9
    Kd, Ks = (torch.tensor(a, device=cuda) for a in band_case(3, 2, 5))
    fac = band.band_factor(Kd, Ks)
    Lk, dk = leaf.leaf_ldl(Kd[:, 0])
    assert torch.equal(Lk, fac.Dinv[:, 0]) and torch.equal(dk, fac.d[:, 0])


@pytest.mark.parametrize("form", [
    "lanes", "shared_b", "shared_a", "transposed", "beta", "ragged",
    "unaligned", "c_lower", "c_lower_block", "a_lower", "a_upper", "b_lower",
    "b_upper", "b_upper_transposed", "folded"])
def test_dgemm_kernel_matches_plain(cuda, form):
    """dgemm against its plain version on the card within 1e-12 relative
    (summation order only): ragged shapes (37x150x77, 129x300x65), an
    operand whose rows are not 16-byte aligned, a c that is a block of a
    larger matrix, each structure flag on exactly triangular operands (a
    lower-only c keeps its strict upper triangle bit for bit), and the
    shared right operand folded into one product."""
    from eicos_tpu_torch.ops import gemm, kernels

    rng = np.random.default_rng(4)
    t = lambda *s: torch.tensor(rng.standard_normal(s), device=cuda)  # noqa
    a, b = t(3, 37, 150), t(3, 150, 77)
    c = None
    kw = {}
    if form == "shared_b":
        b = t(150, 77)
    elif form == "shared_a":
        a = t(37, 150)
    elif form == "transposed":
        a = t(3, 150, 37).transpose(-1, -2)
        b = t(3, 77, 150).transpose(-1, -2)
    elif form == "beta":
        c = t(3, 50, 90)[:, 5:42, 3:80]
        kw = dict(alpha=-1.0, beta=1.0)
    elif form == "ragged":
        a, b = t(3, 129, 300), t(3, 300, 65)
    elif form == "unaligned":
        a = t(3, 129, 301)[:, :, 1:]        # rows start 8 bytes off
        b = t(3, 301, 65)[:, 1:]
    elif form == "c_lower":
        a, b = t(3, 300, 150), t(3, 150, 300)
        c = t(3, 300, 300)
        kw = dict(alpha=-1.0, beta=1.0, c_lower=True)
    elif form == "c_lower_block":           # the Schur form into K[:, h:, h:]
        x = t(3, 384, 128)
        a, b = x, x.transpose(-1, -2)
        c = t(3, 640, 640)[:, 256:, 256:]
        kw = dict(alpha=-1.0, beta=1.0, c_lower=True)
    elif form in ("a_lower", "a_upper"):
        tri = torch.tril if form == "a_lower" else torch.triu
        a, b = tri(t(3, 300, 300)), t(3, 300, 77)
        kw = dict(a_tri=form[2:])
    elif form in ("b_lower", "b_upper"):
        tri = torch.tril if form == "b_lower" else torch.triu
        a, b = t(3, 37, 300), tri(t(3, 300, 300))
        kw = dict(b_tri=form[2:])
    elif form == "b_upper_transposed":      # L21 = K21 L11inv^T
        a = t(3, 512, 640)[:, 256:, :256]
        b = torch.tril(t(3, 256, 256)).transpose(-1, -2)
        kw = dict(b_tri="upper")
    elif form == "folded":
        a, b = t(3, 16, 300), t(300, 260)
    want = gemm.matmul_plain(a, b, None if c is None else c.clone(), **kw)
    before = kernels.COUNTS["dgemm"]
    got = gemm.matmul(a, b, c=c, **kw)
    torch.cuda.synchronize()
    assert kernels.COUNTS["dgemm"] == before + 1
    assert rel(got, want) < 1e-12
    if kw.get("c_lower"):
        up = torch.ones(c.shape[-2:], dtype=torch.bool, device=cuda).triu(1)
        assert torch.equal(got[:, up], want[:, up])


def test_dgemm_repeats_bits_and_checks_flags(cuda):
    """A repeated product gives the same bits (one fixed summation order,
    no atomics); a triangular flag on a non-square operand and c_lower
    without c raise."""
    from eicos_tpu_torch.ops import gemm

    rng = np.random.default_rng(5)
    t = lambda *s: torch.tensor(rng.standard_normal(s), device=cuda)  # noqa
    a, b = t(4, 300, 520), t(4, 520, 260)
    assert torch.equal(gemm.matmul(a, b), gemm.matmul(a, b))
    with pytest.raises(ValueError):
        gemm.matmul(a, b, a_tri="lower")
    with pytest.raises(ValueError):
        gemm.matmul(a, b, b_tri="upper")
    with pytest.raises(ValueError):
        gemm.matmul(a, b, c_lower=True)
    with pytest.raises(ValueError):
        gemm.matmul(a, t(4, 520, 520), b_tri="diagonal")


def test_subst_factor_bits_equal_inverse_factor_on_card(cuda):
    """At Dp 1152 (nb 9, uneven splits, tiles clipped by the triangle
    flags) ``ldl_factor_subst``'s pivots and leaf inverses have the bits
    of ``ldl_factor``'s: both recursions make the same products with the
    same flags."""
    from eicos_tpu_torch.ops import ldl

    K = torch.tensor(quasidefinite(2, 9 * B, 700, 12), device=cuda)
    inv = ldl.ldl_factor(K.clone())
    fs = ldl.ldl_factor_subst(K.clone())
    torch.cuda.synchronize()
    assert torch.equal(fs.d, inv.d)
    for i in range(9):
        assert torch.equal(fs.pre.Xinv[:, i],
                           inv.Linv[:, i * B:(i + 1) * B, i * B:(i + 1) * B])
    assert not torch.triu(inv.Linv, 1).any()
    r = torch.tensor(np.random.default_rng(13).standard_normal((2, 2, 9 * B)),
                     device=cuda)
    assert rel(torch.matmul(ldl.ldl_solve(inv, r), K), r) < 1e-11


def test_linv_kernels_match_plain(cuda):
    """linv_fwd / linv_bwd against their plain versions at k = 1, 2, 5, 16,
    within 1e-10 relative, on a factor of the dense recursion."""
    from eicos_tpu_torch.ops import gemm, kernels, ldl

    K = torch.tensor(quasidefinite(2, 384, 250, 6))
    fac = ldl.ldl_factor(K.clone())
    Linv, d = fac.Linv.to(cuda), fac.d.to(cuda)
    rng = np.random.default_rng(7)
    before = dict(kernels.COUNTS)
    for k in (1, 2, 5, 16):
        r = torch.tensor(rng.standard_normal((2, k, 384)), device=cuda)
        tk = gemm.linv_fwd(Linv, d, r)
        assert rel(tk, gemm.linv_fwd_plain(Linv, d, r)) < 1e-10
        assert rel(gemm.linv_bwd(Linv, tk),
                   gemm.linv_bwd_plain(Linv, tk)) < 1e-10
    torch.cuda.synchronize()
    assert kernels.COUNTS["linv_fwd"] == before["linv_fwd"] + 4
    assert kernels.COUNTS["linv_bwd"] == before["linv_bwd"] + 4


def test_dense_wrappers_check_inputs(cuda):
    from eicos_tpu_torch.ops import gemm, leaf

    f64 = dict(dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        leaf.leaf_ldl(torch.zeros(2, B, B, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        leaf.leaf_ldl(torch.zeros(2, B, 64, **f64))
    with pytest.raises(ValueError):
        gemm.matmul(torch.zeros(2, 4, 5, **f64), torch.zeros(2, 6, 3, **f64))
    with pytest.raises(ValueError):
        gemm.matmul(torch.zeros(2, 4, 5, **f64), torch.zeros(2, 5, 3))
    Linv = torch.zeros(1, B, B, **f64)
    d = torch.ones(1, B, **f64)
    with pytest.raises(ValueError):
        gemm.linv_fwd(Linv, d, torch.zeros(1, 17, B, **f64))
    with pytest.raises(ValueError):
        gemm.linv_fwd(Linv, d.cpu(), torch.zeros(1, 2, B, **f64))


def test_reduced_solver_on_card_matches_cpu(cuda):
    """Two lanes of a small MPC LP under "reduced" on the inverse path:
    the kernels' solve and the CPU plain path agree, and every kernel of
    that path was launched."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.ops import kernels

    st, base = corpus.make_mpc_like(horizon=30, nx=2, nu=4, seed=3)
    st = st.with_gsplit(base.G, base.A)
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(2)]
    batch = pt.BatchedSolver.stack(probs, shared=("G", "A", "h"))
    settings = pt.Settings(kkt_strategy="reduced", dense_solve="inverse")
    kernels.reset_counts()
    gpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h")).solve(batch)
    for name in ("leaf_ldl", "dgemm", "linv_fwd", "linv_bwd"):
        assert kernels.COUNTS[name] > 0, name
    assert kernels.COUNTS["dense_fwd"] == 0
    cpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)


def wide_band_case(lanes, nb, bw, seed):
    """Random quasidefinite block-banded blocks with Ksubs[:, k, j-1] =
    K[k, k-j] (zero for k < j), every row diagonally dominant."""
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


@pytest.mark.parametrize("bw,nb", [(2, 5), (3, 7), (6, 9), (6, 4)])
def test_wide_band_kernels_match_plain(cuda, bw, nb):
    """band_factor_bw, band_fwd_bw and band_bwd_bw against their plain
    twins within 1e-12 relative (summation order, and a substitution leaf
    inverse against Newton-Schulz), at block counts that are no multiple
    of the bandwidth and one below it (nb = 4 < bw = 6); garbage left of
    block column 0 is never read and L is zero there."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    Kd, Ks = (torch.tensor(a, device=cuda)
              for a in wide_band_case(3, nb, bw, 10 * bw + nb))
    for j in range(1, bw + 1):
        Ks[:, :j, j - 1] = 1e300
    before = dict(kernels.COUNTS)
    fk = band.band_factor(Kd, Ks)
    fp = plain.band_factor_bw_plain(Kd, Ks)
    for a, b in zip(fk, fp):
        assert rel(a, b) < 1e-12
    for j in range(1, bw + 1):
        assert not fk.L[:, :j, j - 1].any()
    rng = np.random.default_rng(1)
    for k in (1, 2, 16):
        r = torch.tensor(rng.standard_normal((3, k, nb * B)), device=cuda)
        assert rel(band.band_fwd(fk, r), plain.band_fwd_bw_plain(fk, r)) < 1e-12
        assert rel(band.band_bwd(fk, r), plain.band_bwd_bw_plain(fk, r)) < 1e-12
    torch.cuda.synchronize()
    assert kernels.COUNTS["band_factor_bw"] == before["band_factor_bw"] + 1
    assert kernels.COUNTS["band_fwd_bw"] == before["band_fwd_bw"] + 3
    assert kernels.COUNTS["band_bwd_bw"] == before["band_bwd_bw"] + 3
    assert "band_factor" not in kernels.COUNTS    # retired: one band factor


def random_band_factor(lanes, nb, bw, device, seed):
    """A synthetic factor for the sweeps: random L blocks (zero left of
    block column 0), unit-lower Dinv with exact zeros above the diagonal,
    pivots of both signs away from zero; made on the card."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    L = 0.3 * torch.randn(lanes, nb, bw, B, B, **f64) / B ** 0.5
    for j in range(1, bw + 1):
        L[:, :j, j - 1] = 0.0
    Dinv = torch.tril(0.3 * torch.randn(lanes, nb, B, B, **f64) / B ** 0.5, -1)
    Dinv.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    d = torch.randn(lanes, nb, B, **f64)
    d = torch.where(d < 0, d - 0.5, d + 0.5)
    from eicos_tpu_torch.ops.band_ldl import BandFactors
    return BandFactors(L=L, Dinv=Dinv, d=d)


# (bw, nb, lane counts, k): every bandwidth at block counts below, at and
# far above it; then the cells' shapes (bw 2 at nb 71, bw 1 at nb 23 and
# 16, 16 and 128 lanes) and bw 6 at k 16, the shallowest panel ring
SWEEP_CASES = [pytest.param(bw, nb, (1, 3, 64, 130), (1, 2, 16),
                            id=f"{bw}-{nb}")
               for nb in (2, 5, 38) for bw in range(1, 7)] + [
    pytest.param(2, 71, (128,), (1, 2), id="dist33"),
    pytest.param(1, 23, (128,), (1, 2), id="pdg"),
    pytest.param(1, 16, (16, 128), (1, 2), id="mpc-lp"),
    pytest.param(6, 9, (128,), (16,), id="bw6-k16"),
]


@pytest.mark.parametrize("bw,nb,lane_counts,ks", SWEEP_CASES)
def test_wide_band_sweeps_match_plain(cuda, bw, nb, lane_counts, ks):
    """band_fwd_bw and band_bwd_bw against their plain twins within 1e-12
    relative (2 to 260 CTAs in clusters of 2); a repeated sweep gives the
    same bits, and a lane alone the bits it has inside a call of 64 or
    more lanes."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain
    from eicos_tpu_torch.ops.band_ldl import BandFactors

    rng = np.random.default_rng(bw * 100 + nb)
    for lanes in lane_counts:
        fac = random_band_factor(lanes, nb, bw, cuda, seed=lanes + bw + nb)
        for k in ks:
            r = torch.tensor(rng.standard_normal((lanes, k, nb * B)),
                             device=cuda)
            before = dict(kernels.COUNTS)
            w = band.band_fwd_bw(fac, r)
            z = band.band_bwd_bw(fac, w)
            torch.cuda.synchronize()
            assert kernels.COUNTS["band_fwd_bw"] == before["band_fwd_bw"] + 1
            assert kernels.COUNTS["band_bwd_bw"] == before["band_bwd_bw"] + 1
            assert rel(w, plain.band_fwd_bw_plain(fac, r)) < 1e-12, (lanes, k)
            assert rel(z, plain.band_bwd_bw_plain(fac, w)) < 1e-12, (lanes, k)
            if lanes in (3, 128):
                assert torch.equal(w, band.band_fwd_bw(fac, r))
                assert torch.equal(z, band.band_bwd_bw(fac, w))
            if lanes >= 64:
                for i in (0, lanes - 1):
                    one = BandFactors(*(t[i:i + 1].contiguous() for t in fac))
                    assert torch.equal(
                        band.band_fwd_bw(one, r[i:i + 1].contiguous()),
                        w[i:i + 1]), (lanes, k, i)
                    assert torch.equal(
                        band.band_bwd_bw(one, w[i:i + 1].contiguous()),
                        z[i:i + 1]), (lanes, k, i)
        del fac
        torch.cuda.empty_cache()


def test_wide_band_kernel_at_bw1_matches_band_factor(cuda):
    """A 4-d ``Ks`` (lanes, nb, 128, 128), which ``band_factor`` reads as
    block bandwidth 1 (``benchmark/`` times it so), launches the band
    kernels once each and gives the bits of the band layout's factor and
    solve."""
    from eicos_tpu_torch.ops import band, kernels

    Kd, Ks = (torch.tensor(a, device=cuda) for a in wide_band_case(3, 5, 1, 3))
    r = torch.tensor(np.random.default_rng(2).standard_normal((3, 2, 5 * B)),
                     device=cuda)
    before = dict(kernels.COUNTS)
    narrow = band.band_factor(Kd, Ks[:, :, 0].contiguous())
    x4 = band.band_solve(narrow, r)
    torch.cuda.synchronize()
    for name in (factor_name(3), "band_fwd_bw", "band_bwd_bw"):
        assert kernels.COUNTS[name] == before[name] + 1, name
    assert narrow.L.shape == (3, 5, 1, B, B)
    wide = band.band_factor_bw(Kd, Ks)
    assert all(torch.equal(a, b) for a, b in zip(wide, narrow))
    assert torch.equal(band.band_bwd_bw(wide, band.band_fwd_bw(wide, r)), x4)


def test_wide_band_wrappers_check_inputs(cuda):
    from eicos_tpu_torch.ops import band

    Kd, Ks = (torch.tensor(a, device=cuda) for a in wide_band_case(1, 8, 7, 0))
    with pytest.raises(ValueError):
        band.band_factor_bw(Kd, Ks)
    with pytest.raises(ValueError):
        band.band_factor(Kd, Ks[:, :, :2])      # not contiguous


@pytest.mark.parametrize("gsplit", [True, False], ids=["scatter", "dense"])
def test_keep_soc_solver_on_card_matches_cpu(cuda, gsplit):
    """Four lanes of a small SOCP under "banded" with a keep_soc plan.
    With a gsplit the NT-scaled kept cones go through the direct scatter:
    the kernels' solve and the CPU plain path give the same exit codes and
    iteration counts.  Without one the band blocks are gathered from the
    unscaled dense K, whose endgame turns on the last bits (one lane of
    this batch ends at CLOSE_TO_OPTIMAL on the CPU and at OPTIMAL on an
    H100): there each lane's exit tier is no worse than the CPU's and its
    objective is within 1e-7 relative of the CPU's "reduced" solve."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.api import _code_rank
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.plan import make_band_plan

    st, base = corpus.make_mpc_soc(horizon=30, nx=2, nu=4, seed=5)
    if gsplit:
        st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A, keep_soc=True))
    rng = np.random.default_rng(11)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(4)]
    batch = pt.BatchedSolver.stack(probs, shared=("G", "A", "h"))
    settings = pt.Settings(kkt_strategy="banded")
    kernels.reset_counts()
    gpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h")).solve(batch)
    assert all(kernels.COUNTS[n] > 0 for n in
               (factor_name(4, st.band.bwb), "band_fwd_bw", "band_bwd_bw"))
    cpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    if gsplit:
        assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
        assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
        np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                                   cpu.info.pcost.numpy(), rtol=1e-8)
        return
    red = pt.BatchedSolver(st, pt.Settings(kkt_strategy="reduced"),
                           shared=("G", "A", "h"), device="cpu").solve(batch)
    assert not red.exit_code.any()
    for i in range(4):
        assert _code_rank(int(gpu.exit_code[i])) >= _code_rank(
            int(cpu.exit_code[i])), i
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               red.info.pcost.numpy(), rtol=1e-7)


def test_wide_band_solver_on_card_matches_cpu(cuda):
    """Two lanes of a wide-stage LP (block bandwidth 2): the wide kernels'
    solve equals the CPU plain path, and each wide kernel was launched."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.plan import make_band_plan

    st, base = corpus.make_mpc_like(horizon=6, nx=40, nu=20, seed=3)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    assert st.band.bwb == 2
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(2)]
    batch = pt.BatchedSolver.stack(probs, shared=("G", "A", "h"))
    settings = pt.Settings(kkt_strategy="banded")
    kernels.reset_counts()
    gpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h")).solve(batch)
    assert all(kernels.COUNTS[n] > 0
               for n in ("band_factor_bw", "band_fwd_bw", "band_bwd_bw"))
    cpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)


# ------------------------------------- substitution path, f32 leaf, "full"

@pytest.mark.parametrize("D", [128, 384, 640])
def test_dense_pack_and_sweeps_match_plain(cuda, D):
    """dense_pack bit for bit (it moves values), dense_fwd / dense_bwd
    within 1e-12 relative of their plain versions at k = 1, 2, 5, 16, and
    the substitution factor's pivots and leaf inverses with the bits of
    the inverse factor's."""
    from eicos_tpu_torch.ops import dense, kernels, ldl

    K = torch.tensor(quasidefinite(2, D, 2 * D // 3, 8), device=cuda)
    before = dict(kernels.COUNTS)
    K2 = K.clone()
    fs = ldl.ldl_factor_subst(K2)
    inv = ldl.ldl_factor(K.clone())
    torch.cuda.synchronize()
    nb = D // B
    assert kernels.COUNTS["dense_pack"] == before["dense_pack"] + (nb > 1)
    assert torch.equal(fs.pre.Lp, dense.pack_dense_plain(K2))
    assert torch.equal(fs.d, inv.d)
    for i in range(nb):
        assert torch.equal(fs.pre.Xinv[:, i],
                           inv.Linv[:, i * B:(i + 1) * B, i * B:(i + 1) * B])
    rng = np.random.default_rng(9)
    for k in (1, 2, 5, 16):
        r = torch.tensor(rng.standard_normal((2, k, D)), device=cuda)
        w = dense.dense_fwd(fs.pre, r)
        assert rel(w, dense.dense_fwd_plain(fs.pre, r)) < 1e-12
        z = dense.dense_bwd(fs.pre, w)
        assert rel(z, dense.dense_bwd_plain(fs.pre, w)) < 1e-12
        assert rel(torch.matmul(z, K), r) < 1e-11
        assert rel(ldl.ldl_solve(fs, r), ldl.ldl_solve(inv, r)) < 1e-11
    torch.cuda.synchronize()
    assert kernels.COUNTS["dense_fwd"] == before["dense_fwd"] + 8
    assert kernels.COUNTS["dense_bwd"] == before["dense_bwd"] + 8


def test_leaf_f32_kernel_matches_plain(cuda):
    """leaf_ldl at f32 against its plain version and the f64 leaf within
    2e-4 relative (f32 over 128 dependent steps), into strided views, and
    ||Linv M Linv' - diag(d)|| within 2e-4 of ||diag(d)||."""
    from eicos_tpu_torch.ops import kernels, leaf

    M = torch.tensor(quasidefinite(3, 2 * B, 150, 3), device=cuda)
    blk = M[:, B:, B:].to(torch.float32)
    before = kernels.COUNTS["leaf_ldl_f32"]
    Linv = torch.zeros(3, 2 * B, 2 * B, dtype=torch.float32, device=cuda)
    d = torch.zeros(3, 2 * B, dtype=torch.float32, device=cuda)
    leaf.leaf_ldl(blk, out=(Linv[:, :B, B:], d[:, B:]))
    Lp, dp = leaf.leaf_ldl_plain(blk)
    L64, d64 = leaf.leaf_ldl(M[:, B:, B:])
    torch.cuda.synchronize()
    assert kernels.COUNTS["leaf_ldl_f32"] == before + 1
    assert rel(Linv[:, :B, B:], Lp) < 2e-4 and rel(d[:, B:], dp) < 2e-4
    assert rel(Linv[:, :B, B:].double(), L64) < 2e-4
    assert rel(d[:, B:].double(), d64) < 2e-4
    assert not Linv[:, B:].any() and not Linv[:, :B, :B].any()
    Li = Linv[:, :B, B:].double()
    assert rel(Li @ blk.double() @ Li.transpose(-1, -2),
               torch.diag_embed(d[:, B:].double())) < 2e-4


def test_subst_wrappers_check_inputs(cuda):
    from eicos_tpu_torch.ops import dense, ldl

    f64 = dict(dtype=torch.float64, device=cuda)
    fac = dense.DenseFac(Lp=torch.zeros(1, 1, B, B, **f64),
                         Xinv=torch.zeros(1, 2, B, B, **f64),
                         d=torch.ones(1, 2 * B, **f64))
    with pytest.raises(ValueError):
        dense.dense_fwd(fac, torch.zeros(1, 17, 2 * B, **f64))
    with pytest.raises(ValueError):
        dense.dense_fwd(fac, torch.zeros(1, 2, 3 * B, **f64))
    with pytest.raises(ValueError):
        dense.dense_bwd(fac._replace(Lp=fac.Lp.cpu()),
                        torch.zeros(1, 2, 2 * B, **f64))
    with pytest.raises(ValueError):
        dense.pack_dense(torch.zeros(1, 200, 200, **f64), fac.Xinv, fac.d)
    with pytest.raises(ValueError):
        ldl.ldl_factor_subst(torch.zeros(1, B, B, dtype=torch.float32,
                                         device=cuda))


def _lp_batch(pt, corpus, lanes=2):
    st, base = corpus.make_mpc_like(horizon=30, nx=2, nu=4, seed=3)
    st = st.with_gsplit(base.G, base.A)
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(lanes)]
    return st, probs, pt.BatchedSolver.stack(probs, shared=("G", "A", "h"))


@pytest.mark.parametrize("cfg,must,never", [
    (dict(kkt_strategy="reduced"), ("dense_pack", "dense_fwd", "dense_bwd"),
     ("linv_fwd", "linv_bwd")),
    (dict(kkt_strategy="normal"), ("dense_pack", "dense_fwd", "dense_bwd"),
     ("linv_fwd", "linv_bwd")),
    (dict(), ("linv_fwd", "linv_bwd"), ("dense_fwd", "dense_bwd")),
    (dict(dense_solve="subst"), ("dense_pack", "dense_fwd", "dense_bwd"),
     ("linv_fwd", "linv_bwd")),
], ids=["reduced-auto", "normal-auto", "full", "full-subst"])
def test_dense_strategies_on_card_match_cpu(cuda, cfg, must, never):
    """Two lanes of a small MPC LP under the dense strategies: on the card
    ``dense_solve="auto"`` takes the substitution kernels under "reduced"
    and "normal" and the inverse kernels under "full"; each agrees with
    the CPU plain path (under "subst" where the card took it)."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.ops import kernels

    st, _, batch = _lp_batch(pt, corpus)
    settings = pt.Settings(**cfg)
    kernels.reset_counts()
    gpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h")).solve(batch)
    for name in ("leaf_ldl", "dgemm") + must:
        assert kernels.COUNTS[name] > 0, name
    for name in never:
        assert kernels.COUNTS[name] == 0, name
    if "dense_fwd" in must:
        cfg = dict(cfg, dense_solve="subst")
    cpu = pt.BatchedSolver(st, pt.Settings(**cfg), shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert int(cpu.exit_code[0]) == 0
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)


def test_solver_at_default_settings_on_card(cuda):
    """``Solver(G, A, c, h, b).solve()``: the default device and the
    default ``Settings()``."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus

    _, probs, _ = _lp_batch(pt, corpus, lanes=1)
    p0 = probs[0]
    s = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b)
    assert s.device.type == "cuda"
    assert s.solve() == pt.ExitCode.OPTIMAL
    ref = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b, device="cpu")
    assert ref.solve() == pt.ExitCode.OPTIMAL
    assert abs(float(s.get_info().pcost) - float(ref.get_info().pcost)) \
        <= 1e-8 * abs(float(ref.get_info().pcost))


def test_f32_factor_on_card_launches_f32_leaf(cuda):
    """``factor_dtype="float32"`` under "reduced": the f32 leaf kernel and
    no f64 dense kernel; one refined solve agrees with the CPU plain path
    at 1e-9 (the raw f32 directions differ at f32 rounding)."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, kkt
    from eicos_tpu_torch.equilibrate import equilibrate
    from eicos_tpu_torch.ops import kernels

    st, probs, _ = _lp_batch(pt, corpus, lanes=1)
    p0 = probs[0]
    settings = pt.Settings(kkt_strategy="reduced", factor_dtype="float32")
    out = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,  # noqa
                                      device=dev)
        eq = equilibrate(st, t(p0.G), t(p0.A), t(p0.c)[None], t(p0.h)[None],
                         t(p0.b)[None])
        ctx = kkt.make_context(st, eq.G, eq.A, settings)
        kernels.reset_counts()
        solve = kkt.factor(st, ctx, None, settings, 1)
        rhs = torch.cat([torch.zeros(1, st.n, dtype=torch.float64,
                                     device=dev), eq.b, eq.h], -1)[:, None]
        out[dev] = kkt.solve_refined(st, ctx, solve, None, rhs, settings)
        if dev == "cuda":
            assert kernels.COUNTS["leaf_ldl_f32"] > 0
            for name in ("leaf_ldl", "dgemm", "linv_fwd", "dense_fwd"):
                assert kernels.COUNTS[name] == 0, name
    for f in ("dx", "dy", "dz"):
        assert rel(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f)) \
            < 1e-9, f


def leaf_cases(lanes, dtype, seed):
    """(lanes, 128, 128) symmetric blocks for the blocked leaf: quasidefinite
    (negative pivots after row 70), every third lane with a zero row and
    column (a pivot of 0, clamped: 1e-150 in f64, 1e-20 in f32), lanes
    scaled by 1e100 / 1e-100 (f64) or 1e10 / 1e-10 (f32) in turn."""
    M = quasidefinite(lanes, B, 70, seed)
    M[::3, 37, :] = 0.0
    M[::3, :, 37] = 0.0
    big = 1e100 if dtype == torch.float64 else 1e10
    M[1::4] *= big
    M[3::4] /= big
    return M


def lane_rel(a, b):
    """Largest over lanes of each lane's max-norm relative error."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("lanes", [1, 3, 128, 130])
def test_blocked_leaf_matches_plain(cuda, lanes, dtype):
    """The blocked leaf (K9/K10 in f64, K11 in f32) against its plain
    version, lane by lane: d and Linv within 1e-12 relative in f64 and 2e-4
    in f32 (summation order, and the inverse by blocks against
    Newton-Schulz), with clamped pivots, negative pivots and scaled blocks;
    read from and written to strided views and in place; a repeated launch
    gives the same bits."""
    from eicos_tpu_torch.ops import kernels, leaf

    tol = 1e-12 if dtype == torch.float64 else 2e-4
    name = "leaf_ldl" if dtype == torch.float64 else "leaf_ldl_f32"
    Mb = torch.zeros(lanes, 2 * B, 2 * B, dtype=dtype, device=cuda)
    Mb[:, B:, :B] = torch.tensor(leaf_cases(lanes, dtype, lanes), device=cuda)
    blk = Mb[:, B:, :B]
    before = kernels.COUNTS[name]
    Linv = torch.zeros(lanes, 2 * B, 2 * B, dtype=dtype, device=cuda)
    d = torch.zeros(lanes, 2 * B, dtype=dtype, device=cuda)
    leaf.leaf_ldl(blk, out=(Linv[:, :B, B:], d[:, B:]))
    Lp, dp = leaf.leaf_ldl_plain(blk)
    torch.cuda.synchronize()
    assert kernels.COUNTS[name] == before + 1
    assert lane_rel(d[:, B:], dp) < tol
    assert lane_rel(Linv[:, :B, B:], Lp) < tol
    assert not Linv[:, B:].any() and not Linv[:, :B, :B].any()
    assert torch.isfinite(Linv).all() and torch.isfinite(d).all()
    # lane 0 has the zero row: its pivot is clamped
    tiny = torch.tensor(1e-150 if dtype == torch.float64 else 1e-20,
                        dtype=dtype)
    assert d[0, B + 37].cpu() == tiny
    again = leaf.leaf_ldl(blk)
    assert torch.equal(again[0], Linv[:, :B, B:])
    assert torch.equal(again[1], d[:, B:])
    # in place: Linv over the block it came from
    dd = torch.empty(lanes, B, dtype=dtype, device=cuda)
    leaf.leaf_ldl(blk, out=(blk, dd))
    assert torch.equal(blk, again[0]) and torch.equal(dd, again[1])


@pytest.mark.parametrize("bw,nb", [(bw, bw + 2) for bw in range(1, 7)]
                         + [(1, 5)],
                         ids=["1", "2", "3", "4", "5", "6", "1-nb5"])
def test_band_factor_bw_lanes_match_plain(cuda, bw, nb):
    """The DMMA band factor at 1, 3, 64 and 130 lanes against
    ``band_factor_bw_plain`` within 1e-12 relative, factor and solve (the
    wide sweeps on both factors); a repeated factor gives the same bits."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    for lanes in (1, 3, 64, 130):
        Kd, Ks = (torch.tensor(a, device=cuda)
                  for a in wide_band_case(lanes, nb, bw, 7 * bw + lanes))
        name = factor_name(lanes, bw)
        before = kernels.COUNTS[name]
        fk = band.band_factor_bw(Kd, Ks)
        fp = plain.band_factor_bw_plain(Kd, Ks)
        torch.cuda.synchronize()
        assert kernels.COUNTS[name] == before + 1
        for a, b in zip(fk, fp):
            assert rel(a, b) < 1e-12, lanes
        r = torch.tensor(np.random.default_rng(lanes).standard_normal(
            (lanes, 2, nb * B)), device=cuda)
        xk = band.band_solve(fk, r)
        xp = plain.band_bwd_bw_plain(fp, plain.band_fwd_bw_plain(fp, r))
        assert rel(xk, xp) < 1e-12, lanes
        again = band.band_factor_bw(Kd, Ks)
        assert all(torch.equal(a, b) for a, b in zip(again, fk))
        del Kd, Ks, fk, fp, again
        torch.cuda.empty_cache()


def device_wide_band(lanes, nb, bw, seed, device):
    """``wide_band_case``'s recipe made on the card from a
    ``torch.Generator`` (128 lanes at nb 23 would take seconds in
    numpy)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    Kd = 0.3 * torch.randn(lanes, nb, B, B, **f64) / B ** 0.5
    Kd = Kd + Kd.transpose(-1, -2)
    Ks = 0.3 * torch.randn(lanes, nb, bw, B, B, **f64) / B ** 0.5
    rows = Kd.abs().sum(-1)
    for j in range(1, bw + 1):
        Ks[:, :j, j - 1] = 0.0
        rows += Ks[:, :, j - 1].abs().sum(-1)
        rows[:, :-j] += Ks[:, j:, j - 1].abs().sum(-2)
    sign = torch.where(torch.rand(lanes, nb, B, generator=g, device=device)
                       < 0.6, 1.0, -1.0).to(torch.float64)
    Kd.diagonal(dim1=-2, dim2=-1).copy_(sign * (1.0 + rows))
    return Kd, Ks.contiguous()


@pytest.mark.parametrize("nb", [16, 23])
def test_cluster_factor_has_the_one_cta_bits(cuda, nb):
    """The bw-1 factor of 1, 3, 16 and 32 lanes, which takes a cluster of
    CTAs a lane on this card, gives the bits of the same lanes factored
    inside a 128-lane call, which takes one CTA a lane: L, Dinv and d equal
    (``torch.equal``); each call counts once, under the name the dispatch
    takes; Ks[:, 0] is never read."""
    from eicos_tpu_torch.ops import band, kernels

    Kd, Ks = device_wide_band(128, nb, 1, 100 + nb, cuda)
    Ks[:, 0] = 1e300
    assert factor_name(128) == "band_factor_bw"
    before = dict(kernels.COUNTS)
    whole = band.band_factor(Kd, Ks)
    torch.cuda.synchronize()
    assert kernels.COUNTS["band_factor_bw"] == before["band_factor_bw"] + 1
    assert not whole.L[:, 0].any()
    for lanes in (1, 3, 16, 32):
        name = factor_name(lanes)
        assert name == "band_factor_cluster", lanes
        before = dict(kernels.COUNTS)
        part = band.band_factor(Kd[:lanes].contiguous(),
                                Ks[:lanes].contiguous())
        torch.cuda.synchronize()
        assert kernels.COUNTS[name] == before[name] + 1
        assert kernels.COUNTS["band_factor_bw"] == before["band_factor_bw"]
        for a, b in zip(part, whole):
            assert torch.equal(a, b[:lanes]), lanes
    del Kd, Ks, whole, part
    torch.cuda.empty_cache()


def test_cluster_factor_matches_plain(cuda):
    """The cluster factor (16 lanes) against ``band_factor_bw_plain`` within
    the one-CTA kernel's 1e-12 relative, factor and solve; a repeated call
    gives the same bits."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    Kd, Ks = (torch.tensor(a, device=cuda)
              for a in wide_band_case(16, 5, 1, 29))
    assert factor_name(16) == "band_factor_cluster"
    before = kernels.COUNTS["band_factor_cluster"]
    fk = band.band_factor_bw(Kd, Ks)
    fp = plain.band_factor_bw_plain(Kd, Ks)
    torch.cuda.synchronize()
    assert kernels.COUNTS["band_factor_cluster"] == before + 1
    for a, b in zip(fk, fp):
        assert rel(a, b) < 1e-12
    r = torch.tensor(np.random.default_rng(5).standard_normal(
        (16, 2, 5 * B)), device=cuda)
    xk = band.band_solve(fk, r)
    xp = plain.band_bwd_bw_plain(fp, plain.band_fwd_bw_plain(fp, r))
    assert rel(xk, xp) < 1e-12
    again = band.band_factor_bw(Kd, Ks)
    assert all(torch.equal(a, b) for a, b in zip(again, fk))


def test_cluster_dispatch_reads_the_card(cuda):
    """``band.clusters`` on this card: bw 1 at few lanes takes a cluster
    that fits both the SM count and the clusters the card holds at once;
    bw 3 and 128 lanes take one CTA a lane."""
    from eicos_tpu_torch.ops import band

    sms, active = band._card(torch.cuda.current_device())
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    for lanes in (1, 16, 33, 66):
        c = band.clusters(lanes, 1, cuda)
        assert c in band.CLUSTERS and lanes * c <= sms
        assert active[c] >= lanes
    assert band.clusters(16, 3, cuda) == 1
    assert band.clusters(128, 1, cuda) == 1


# ------------------------------------------------ the banded scan (bw > 6)

@pytest.mark.parametrize("bw,nb,dtype", [(7, 10, torch.float64),
                                         (9, 12, torch.float64),
                                         (9, 12, torch.float32)],
                         ids=["bw7", "bw9", "bw9-f32"])
def test_scan_on_card_matches_cpu(cuda, bw, nb, dtype):
    """The scan factor and solves on CUDA tensors (batched ``torch.matmul``
    products and the leaf kernel of the blocks' type, launched once a block
    row) against the CPU plain path on the same blocks: within 1e-12
    relative in f64 (the kernel's leaf against Newton-Schulz, cuBLAS's sums
    against the CPU's), 2e-4 in f32 (the f32 leaf's tolerance); no band
    kernel is launched."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops.band_ldl import band_ldl_factor, band_ldl_solve

    Kd, Ks = (torch.tensor(a, dtype=dtype) for a in wide_band_case(3, nb, bw,
                                                                   bw))
    rhs = torch.tensor(np.random.default_rng(1).standard_normal(
        (3, 2, nb * B)), dtype=dtype)
    kernels.reset_counts()
    fk = band.band_factor(Kd.to(cuda), Ks.to(cuda))
    xk = band.band_solve(fk, rhs.to(cuda))
    torch.cuda.synchronize()
    leaf = "leaf_ldl_f32" if dtype == torch.float32 else "leaf_ldl"
    assert kernels.COUNTS[leaf] == nb
    assert not any(kernels.COUNTS[n] for n in
                   ("band_factor_bw", "band_factor_cluster", "band_fwd_bw",
                    "band_bwd_bw"))
    fp = band_ldl_factor(Kd, Ks)
    tol = 1e-12 if dtype == torch.float64 else 2e-4
    for a, b in zip(fk, fp):
        assert rel(a.cpu(), b) < tol
    assert rel(xk.cpu(), band_ldl_solve(fp, rhs)) < tol


def test_scan_solver_on_card_matches_cpu(cuda):
    """Four lanes of ``make_mpc_like(horizon=3, nx=256, nu=128)`` (block
    bandwidth 7, Dp 1920) under "banded": the scan on the card ends each
    lane with the CPU plain path's exit code and iteration count, the
    objective within 1e-8 relative, and launches the leaf kernel once a
    block row of every factor and no band kernel."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.plan import make_band_plan

    st, base = corpus.make_mpc_like(horizon=3, nx=256, nu=128, seed=3)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    assert (st.band.bwb, st.band.dim) == (7, 1920)
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(4)]
    batch = pt.BatchedSolver.stack(probs, shared=("G", "A", "h"))
    settings = pt.Settings(kkt_strategy="banded")
    kernels.reset_counts()
    gpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h")).solve(batch)
    launches = dict(kernels.COUNTS)
    assert launches["leaf_ldl"] > 0 and launches["leaf_ldl"] % 15 == 0
    assert not any(launches[n] for n in
                   ("band_factor_bw", "band_factor_cluster", "band_fwd_bw",
                    "band_bwd_bw"))
    cpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)


def spmv_case(rng, km, nm, widths, lanes, per_lane):
    """A (km, nm) operand (or one a lane) whose column j holds ``widths[j]``
    nonzeros at random rows, and its ``SparseOperand``."""
    from eicos_tpu_torch.ops import spmv

    src = np.concatenate([rng.choice(km, size=w, replace=False)
                          for w in widths]).astype(np.int64)
    out = np.repeat(np.arange(nm), widths)
    idx, W = spmv.csc_table(src, out, km, nm)
    shape = (lanes, km, nm) if per_lane else (km, nm)
    M = np.zeros(shape)
    M[..., src, out] = rng.standard_normal((lanes, len(src)) if per_lane
                                           else len(src))
    return spmv.SparseOperand(torch.tensor(M, device="cuda"), idx, W)


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lanes"])
@pytest.mark.parametrize("k", [1, 2, 16])
def test_spmv_kernel_matches_plain(cuda, per_lane, k):
    """The gather kernel against the plain gather (width groups engaged)
    on the same inputs: within 1e-14 relative; one launch a product, the
    same bits on a repeat, and a 2-d argument gives the rows of the 3-d
    product."""
    from eicos_tpu_torch.ops import kernels, spmv

    rng = np.random.default_rng(k)
    km, nm, lanes = 700, 900, 5
    op = spmv_case(rng, km, nm, rng.choice([0, 1, 1, 2, 3, 7], nm), lanes,
                   per_lane)
    assert op.groups is not None
    a = torch.tensor(rng.standard_normal((lanes, k, km)), device=cuda)
    want = op.rmatmul_plain(a)
    before = kernels.COUNTS["spmv"]
    got = op.rmatmul(a)
    assert kernels.COUNTS["spmv"] == before + 1
    assert rel(got, want) <= 1e-14
    again = spmv.spmv(a, op.colptr, op.rows, op.vals, nm)
    assert torch.equal(again, got)
    assert torch.equal(again, spmv.spmv(a, op.colptr, op.rows, op.vals, nm))
    assert torch.equal(op.rmatmul(a[:, 0]), op.rmatmul(a[:, :1])[:, 0])
    torch.cuda.synchronize()


def test_spmv_wrapper_checks_inputs(cuda):
    from eicos_tpu_torch.ops import spmv

    rng = np.random.default_rng(0)
    op = spmv_case(rng, 40, 30, np.ones(30, np.int64), 2, False)
    a = torch.zeros(2, 1, 40, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):          # f32
        spmv.spmv(a.float(), op.colptr, op.rows, op.vals, 30)
    with pytest.raises(ValueError):          # not 3-d
        spmv.spmv(a[:, 0], op.colptr, op.rows, op.vals, 30)
    with pytest.raises(ValueError):          # colptr of another length
        spmv.spmv(a, op.colptr[:-1], op.rows, op.vals, 30)
    with pytest.raises(ValueError):          # vals of another length
        spmv.spmv(a, op.colptr, op.rows, op.vals[:-1], 30)


def bits(t):
    """A tensor's bits, signed zeros included."""
    return t.view(torch.int64)


SPMV_FORMS = ("product", "rx", "elim", "elim_t", "ex", "eyz", "ryz")


def spmv_form(form, a, nm, km0, split, rnd, delta=3e-8):
    """One epilogue form of the fused call, as a product site calls it,
    on the input ``a`` (L, k, km) (two-segment forms take its two views
    split at ``km0``, as [z | y]; split forms split the output at
    ``split``, as [y | z]): the fused call's keywords (``a`` the first
    segment) and the sequence it replaces, given ``K``, the kernel with no
    epilogue on the concatenation: K, then the site's torch ops as they
    ran before the fusion.  Bases and x are strided views of one
    right-hand side, as at the sites; ``rnd(cols)`` draws (L, k, cols)."""
    a0, a1 = a[..., :km0], a[..., km0:]
    rhs = rnd(3 * nm + 7)
    base, x = rhs[..., 3:3 + nm], rhs[..., nm + 5:2 * nm + 5]
    b0, b1 = base[..., :split], base[..., split:]
    x0, x1 = x[..., :split], x[..., split:]
    w = rnd(nm - split)
    if form == "product":
        return dict(a=a), lambda K: K(a)
    if form == "rx":                    # -[G; A]'[z | y]
        return (dict(a=a0, a2=a1, op="sub"),
                lambda K: -K(torch.cat([a0, a1], -1)))
    if form == "elim":                  # bx + G' welim(bz)
        return dict(a=a, base=base), lambda K: base + K(a)
    if form == "elim_t":                # G dx - bz
        return dict(a=a, base=base, op="rsub"), lambda K: K(a) - base
    if form == "ex":                    # bx - [G; A]'[dz | dy] - d dx
        return (dict(a=a0, a2=a1, base=base, op="sub", gamma=-delta, x=x),
                lambda K: base - K(torch.cat([a0, a1], -1)) - delta * x)
    if form == "eyz":                   # [by - A dx + d dy | bz - G dx + Wdz + d dz]
        def seq(K):
            t = K(a)
            return torch.cat([b0 - t[..., :split] + delta * x0,
                              b1 - t[..., split:] + w + delta * x1], -1)
        return (dict(a=a, base=(b0, b1), op="sub", w=(None, w), gamma=delta,
                     x=(x0, x1), split=split), seq)
    assert form == "ryz"                # [A x | s + G x]

    def seq(K):
        t = K(a)
        return torch.cat([t[..., :split], b1 + t[..., split:]], -1)
    return dict(a=a, base=(None, b1), split=split), seq


def fused_forms(a, nm, km0, split, rng):
    """The product sites' forms of the fused call on ``a`` (L, k, km), as
    ``spmv_form`` writes them (the call's keywords and the sequence it
    replaces), on inputs drawn from ``rng``."""
    def rnd(cols):
        return torch.tensor(rng.standard_normal(tuple(a.shape[:-1]) + (cols,)),
                            device=a.device)

    return {form: spmv_form(form, a, nm, km0, split, rnd)
            for form in SPMV_FORMS if form != "product"}


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lanes"])
@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_spmv_fused_matches_plain_and_unfused_bits(cuda, per_lane, k):
    """The fused call in every product site's form (two-segment inputs,
    each epilogue, a split output; bases and x strided views of one
    right-hand side) from k = 1 to the refinement's widest (16), shared
    and per-lane values: within 1e-14 relative of its plain version,
    bit for bit equal to the kernel with no epilogue followed by the
    site's torch ops (zeros of acc - base included), one
    launch a call, and the same bits on a repeat."""
    from eicos_tpu_torch.ops import kernels, spmv

    rng = np.random.default_rng(10 + k)
    km, nm, lanes = 700, 900, 5
    op = spmv_case(rng, km, nm, rng.choice([0, 1, 1, 2, 3, 7], nm), lanes,
                   per_lane)
    a = torch.tensor(rng.standard_normal((lanes, k, km)), device=cuda)

    def K(v):
        return spmv.spmv(v.contiguous(), op.colptr, op.rows, op.vals, nm)

    forms = fused_forms(a, nm, 300, 350, rng)
    forms["elim_t"][0]["base"][..., ::10] = K(a)[..., ::10]
    for form, (kw, seq) in forms.items():
        first = kw.pop("a")
        tail = {n: v for n, v in kw.items() if n != "a2"}
        want = spmv.fused_tail(op.rmatmul_plain(a), **tail)
        before = kernels.COUNTS["spmv"]
        got = op.rmatmul_fused(first, **kw)
        assert kernels.COUNTS["spmv"] == before + 1, form
        assert rel(got, want) <= 1e-14, form
        assert torch.equal(bits(got), bits(seq(K))), form
        assert torch.equal(bits(got), bits(op.rmatmul_fused(first, **kw)))
    got = op.rmatmul_fused(a, **forms["elim_t"][0])
    assert (got[..., ::10] == 0).all() and not torch.signbit(
        got[..., ::10]).any()
    torch.cuda.synchronize()


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lanes"])
def test_spmv_row_groups_give_each_rows_bits(cuda, per_lane):
    """Where the kernel's rows a thread do not divide the rows (5 lanes of
    3) and, per lane, a group stops at its lane's last row, each row of a
    call, with and without an epilogue, has the bits of that row computed
    alone (a group of one row); a 2-d input gives the rows of the 3-d
    product."""
    from eicos_tpu_torch.ops import spmv

    rng = np.random.default_rng(4)
    km, nm, lanes, k = 300, 260, 5, 3
    op = spmv_case(rng, km, nm, rng.choice([0, 1, 2, 5, 9], nm), lanes,
                   per_lane)
    a = torch.tensor(rng.standard_normal((lanes, k, km)), device=cuda)
    kw = fused_forms(a, nm, 120, 100, rng)["eyz"][0]
    kw.pop("a")

    def rows(v, l, r):
        return None if v is None else v[l:l + 1, r:r + 1]

    for tail in ({}, kw):
        got = spmv.spmv(a, op.colptr, op.rows, op.vals, nm, **tail)
        for l in range(lanes):
            # a copy: a lane's slice of the values need not be 16-byte
            # aligned, as the wrapper requires
            vals = op.vals[l:l + 1].clone() if per_lane else op.vals
            for r in range(k):
                one = {n: (tuple(rows(t, l, r) for t in v)
                           if isinstance(v, tuple) else rows(v, l, r)
                           if torch.is_tensor(v) else v)
                       for n, v in tail.items()}
                alone = spmv.spmv(a[l:l + 1, r:r + 1], op.colptr, op.rows,
                                  vals, nm, **one)
                assert torch.equal(bits(got[l:l + 1, r:r + 1]),
                                   bits(alone)), (l, r, bool(tail))
    flat = op.rmatmul_fused(a[:, 0], a2=None, base=a[:, 1, :nm], op="rsub")
    assert torch.equal(bits(flat), bits(op.rmatmul_fused(
        a[:, :1], base=a[:, 1:2, :nm], op="rsub")[:, 0]))
    torch.cuda.synchronize()


def test_spmv_wrapper_checks_fused_inputs(cuda):
    from eicos_tpu_torch.ops import spmv

    rng = np.random.default_rng(1)
    op = spmv_case(rng, 40, 30, np.ones(30, np.int64), 2, False)
    a = torch.zeros(2, 1, 40, dtype=torch.float64, device=cuda)
    base = torch.zeros(2, 1, 30, dtype=torch.float64, device=cuda)
    args = (op.colptr, op.rows, op.vals, 30)
    with pytest.raises(ValueError):          # an unknown op
        spmv.spmv(a, *args, base=base, op="mul")
    with pytest.raises(ValueError):          # split outside the columns
        spmv.spmv(a, *args, base=(None, base), split=31)
    with pytest.raises(ValueError):          # base of another shape
        spmv.spmv(a, *args, base=base[..., :29])
    with pytest.raises(ValueError):          # x without unit column stride
        spmv.spmv(a, *args, x=torch.zeros(2, 1, 60, dtype=torch.float64,
                                          device=cuda)[..., ::2])
    with pytest.raises(ValueError):          # a second segment of f32
        spmv.spmv(a[..., :10], *args, a2=a[..., 10:].float())


@pytest.mark.parametrize("dims,wide", [((12, 2, 3), False),
                                       ((3, 24, 12), True)])
def test_operand_path_on_card_matches_cpu(cuda, dims, wide):
    """A banded batch of four lanes on the card takes the operands (the
    gather kernel; with A's columns too wide, dgemm on the stacks) and the
    rotated refinement loop, and ends each lane with the CPU plain path's
    exit code and iteration count, the objective within 1e-8 relative."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, kkt
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.plan import make_band_plan

    st, base = corpus.make_mpc_like(*dims, seed=1)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(4)]
    shared = ("G", "A", "h")
    batch = pt.BatchedSolver.stack(probs, shared=shared)
    settings = pt.Settings(kkt_strategy="banded")
    ctx = kkt.make_context(st, torch.tensor(base.G, device=cuda),
                           torch.tensor(base.A, device=cuda), settings)
    assert (type(ctx.sGA) is kkt.WideOperand) == wide
    kernels.reset_counts()
    gpu = pt.BatchedSolver(st, settings, shared=shared).solve(batch)
    assert kernels.COUNTS["spmv"] > 0
    assert (kernels.COUNTS["dgemm"] > 0) == wide
    cpu = pt.BatchedSolver(st, settings, shared=shared,
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)


@pytest.mark.parametrize("strategy", ["reduced", "banded"])
def test_block64_on_card_matches_cpu(cuda, strategy):
    """``Settings(block=64)`` on the card: the plain leaf (no leaf kernel),
    dgemm in the dense recursion, the inverse-solve kernels on the factor
    padded to 128; the same code and iterations as the CPU, objective
    within 1e-8."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.plan import make_band_plan

    st, d = corpus.make_mpc_like(20, 2, 3, seed=1)
    st = st.with_gsplit(d.G, d.A)
    if strategy == "banded":
        st = st.with_band_plan(make_band_plan(st, d.G, d.A, block=64))
    cfg = pt.Settings(kkt_strategy=strategy, block=64)
    kernels.reset_counts()
    gpu = pt.solve(st, d, cfg)
    launches = dict(kernels.COUNTS)
    assert launches["leaf_ldl"] == 0 and launches["spmv"] > 0
    if strategy == "reduced":
        assert launches["dgemm"] > 0 and launches["linv_fwd"] > 0
    cpu = pt.solve(st, d, cfg, device="cpu")
    assert int(gpu.exit_code) == int(cpu.exit_code) == 0
    assert int(gpu.info.iter) == int(cpu.info.iter)
    assert abs(float(gpu.info.pcost) - float(cpu.info.pcost)) <= 1e-8 * abs(
        float(cpu.info.pcost))


def test_mesh_of_visible_cards_matches_unsharded(cuda):
    """``BatchedSolver(mesh=make_mesh())`` over the visible cards equals
    the unsharded solve of each shard bit for bit (one card: the whole
    batch)."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus
    from eicos_tpu_torch.parallel import make_mesh
    from eicos_tpu_torch.plan import make_band_plan

    st, base = corpus.make_mpc_like(12, 2, 3, seed=1)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    mesh = make_mesh()
    lanes = 2 * len(mesh)
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(lanes)]
    shared = ("G", "A", "h")
    settings = pt.Settings(kkt_strategy="banded")
    sol = pt.BatchedSolver(st, settings, shared=shared, mesh=mesh).solve(
        pt.BatchedSolver.stack(probs, shared=shared))
    for i in range(len(mesh)):
        one = pt.BatchedSolver(st, settings, shared=shared).solve(
            pt.BatchedSolver.stack(probs[2 * i:2 * i + 2], shared=shared))
        assert torch.equal(sol.x[2 * i:2 * i + 2], one.x)
        assert torch.equal(sol.exit_code[2 * i:2 * i + 2], one.exit_code)


# ---------------------------------------------------------- the cone kernels

def interior_points(rng, l, q, lanes):
    """(lanes, l + sum(q)) points inside the cone."""
    v = rng.standard_normal((lanes, l + sum(q)))
    v[:, :l] = np.abs(v[:, :l]) + 0.5
    off = l
    for d in q:
        v[:, off] = (np.linalg.norm(v[:, off + 1:off + d], axis=1) + 0.5
                     + np.abs(v[:, off]))
        off += d
    return v


# (l, q, lanes, kind): the powered-descent cell's cones (N = 100: 302 LP
# rows, 101 cones of 4 entries, 201 of 3) at 128 lanes; a cone whose q is 0
# (z = s on it); lane 1 out of its cone; cones of 1, 2, 5 and 40 entries,
# past segsum's sequential sums, beside LP rows
CONE_CASES = {"pdg": (302, (4,) * 101 + (3,) * 201, 128, None),
              "q0": (5, (4, 3, 3) * 4, 4, "q0"),
              "outside": (5, (4, 3, 3) * 4, 4, "outside"),
              "mixed": (7, (1, 2, 5, 40), 6, None)}


def cone_inputs(name, seed):
    """A case's CPU inputs: the ``ConeStructure``, s, z, the rotation's two
    right-hand sides, G_soc (per lane in "mixed") and the line search's
    lam directions, tau, dtau, kap, dkap, with lane 0's first cone outside
    lam's cone and tau (lane 0) and kappa (the last lane) steps that
    bind."""
    from eicos_tpu_torch.structure import ConeStructure

    l, q, lanes, kind = CONE_CASES[name]
    st = ConeStructure(l=l, q=q)
    rng = np.random.default_rng(seed)
    s, z = (interior_points(rng, l, q, lanes) for _ in range(2))
    if kind == "q0":
        z[:, l:l + q[0]] = s[:, l:l + q[0]]
    elif kind == "outside":
        s[1, l] = -3.0
    D, w = max(q), 3
    gshape = ((lanes,) if name == "mixed" else ()) + (st.n_sc, D, w)
    valid = np.arange(D)[None, :] < np.asarray(q)[:, None]
    tau, kap = (rng.random(lanes) + 0.5 for _ in range(2))
    dtau, dkap = (rng.standard_normal(lanes) for _ in range(2))
    dtau[0], dkap[-1] = -1e3, -1e3
    t = torch.tensor
    return st, dict(
        s=t(s), z=t(z), x=t(rng.standard_normal((lanes, 2, st.ms))),
        gsub=t(rng.standard_normal(gshape) * valid[:, :, None]),
        ds=t(rng.standard_normal((lanes, st.m))),
        dz=t(rng.standard_normal((lanes, st.m))),
        tau=t(tau), dtau=t(dtau), kap=t(kap), dkap=t(dkap))


def soc_context(st, gsub):
    """A ``KKTContext`` holding what the cone functions of ``kkt`` read:
    the ``SocMaps`` of ``st`` and G_soc, on gsub's device."""
    from eicos_tpu_torch import kkt

    dev = gsub.device
    qidx, valid = kkt._soc_pad_maps(st.q, st.ms)
    D = qidx.shape[1]
    sm = kkt.SocMaps(
        qidx=torch.tensor(qidx, device=dev),
        valid=torch.tensor(valid, device=dev),
        head=torch.tensor((np.arange(D)[None, :] == 0) & valid, device=dev),
        cols=torch.zeros(st.n_sc, gsub.shape[-1], dtype=torch.int64,
                         device=dev),
        flat=torch.tensor(np.flatnonzero(valid), device=dev),
        offs=torch.tensor(np.append(st.head_offsets, st.ms),
                          dtype=torch.int32, device=dev))
    G = torch.zeros(1, 1, dtype=torch.float64, device=dev)
    return kkt.KKTContext(G=G, A=G, Gf=G, split=None, spr_outer=None,
                          sing_sq=None, soc=sm, soc_gsub=gsub)


def held(got, want, bits):
    """NaN in the same entries of the card's ``got`` and ``want``, and
    elsewhere the same bits (``bits``) or within 1e-15 in 2-norm,
    relative."""
    got, want = got.cpu().contiguous(), want.cpu().contiguous()
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    if bits:
        assert torch.equal(g.view(torch.int64), w.view(torch.int64))
    else:
        assert float((g - w).norm()) <= 1e-15 * float(w.norm())


def plain_on_card(monkeypatch, fn, *args):
    """``fn`` on the card's tensors through the torch code, the plain twin
    that runs on CPU tensors (the parent's launches on the card)."""
    from eicos_tpu_torch.ops import kernels

    with monkeypatch.context() as mp:
        mp.setattr(kernels, "on_cpu", lambda t: True)
        return fn(*args)


def launches(name, fn, *args):
    """``fn(*args)`` and the number of ``name`` launches it counted."""
    from eicos_tpu_torch.ops import kernels

    before = kernels.COUNTS[name]
    out = fn(*args)
    torch.cuda.synchronize()
    return out, kernels.COUNTS[name] - before


def sequential(q):
    from eicos_tpu_torch.segsum import SEQUENTIAL_MAX

    return max(q) <= SEQUENTIAL_MAX


@pytest.mark.parametrize("name", list(CONE_CASES))
def test_cone_scalings_kernel_matches_plain(cuda, monkeypatch, name):
    """``cone_scalings`` (one launch) on strided s and z against
    ``cones.update_scalings``' torch code on the card: the same bits while
    its sums run in segsum's fixed order, within 1e-15 past it; against the
    torch code on CPU copies (whose f64 square roots may round the other
    way) within 1e-15.  NaN in the same entries."""
    from eicos_tpu_torch import cones

    st, c = cone_inputs(name, 1)
    lanes, m = c["s"].shape
    wide = torch.zeros(2, lanes, m + 3, dtype=torch.float64, device=cuda)
    wide[:, :, 2:m + 2] = torch.stack([c["s"], c["z"]]).to(cuda)
    s, z = wide[0, :, 2:m + 2], wide[1, :, 2:m + 2]
    (scal, lam), n = launches("cone_scalings", cones.update_scalings, st, s,
                              z)
    assert n == 1
    card = plain_on_card(monkeypatch, cones.update_scalings, st, s, z)
    cpu = cones.update_scalings(st, c["s"], c["z"])
    for got, want, ref in zip((*scal, lam), (*card[0], card[1]),
                              (*cpu[0], cpu[1])):
        held(got, want, sequential(st.q))
        held(got, ref, False)


@pytest.mark.parametrize("name", list(CONE_CASES))
def test_cone_eig_and_rotate_kernels_match_plain(cuda, monkeypatch, name):
    """``cone_eig`` (one launch: rot, lam, the kept blocks and the
    coupling) against ``kkt._soc_eig``, ``_soc_kept_vals`` and
    ``_soc_coupling_vals``, and ``cone_rotate`` (one launch, both
    orientations, two right-hand sides of a strided view) against
    ``_soc_rotate``: within 1e-15 of the torch code on the card and on CPU
    copies (the plain path sums through a library there), NaN in the same
    entries."""
    from eicos_tpu_torch import cones, kkt

    st, c = cone_inputs(name, 2)
    delta = 7e-8
    lanes = c["s"].shape[0]
    scal, _ = cones.update_scalings(st, c["s"].to(cuda), c["z"].to(cuda))
    ctx = soc_context(st, c["gsub"].to(cuda))
    eig, n = launches("cone_eig", kkt._soc_eig, ctx, scal, delta)
    assert n == 1 and len(eig) == 4

    def plain(ctx, scal):
        e = kkt._soc_eig(ctx, scal)
        return (*e, kkt._soc_kept_vals(st, ctx, scal, delta, lanes, e),
                kkt._soc_coupling_vals(ctx, e, lanes))

    card = plain_on_card(monkeypatch, plain, ctx, scal)
    cpu_scal = cones.Scaling(*[f.cpu() for f in scal])
    cpu_ctx = soc_context(st, c["gsub"])
    cpu = plain(cpu_ctx, cpu_scal)
    assert kkt._soc_kept_vals(st, ctx, scal, delta, lanes, eig) is eig[2]
    assert kkt._soc_coupling_vals(ctx, eig, lanes) is eig[3]
    for got, want, ref in zip(eig, card, cpu):
        held(got, want, False)
        held(got, ref, False)
    ms = st.ms
    wide = torch.zeros(lanes, 2, ms + 5, dtype=torch.float64, device=cuda)
    wide[:, :, 1:ms + 1] = c["x"].to(cuda)
    x = wide[:, :, 1:ms + 1]
    for transpose in (False, True):
        y, n = launches("cone_rotate", kkt._soc_rotate, eig[0], x, ctx,
                        transpose)
        assert n == 1
        held(y, plain_on_card(monkeypatch, kkt._soc_rotate, eig[0], x, ctx,
                              transpose), False)
        held(y, kkt._soc_rotate(eig[0].cpu(), c["x"], cpu_ctx, transpose),
             False)


@pytest.mark.parametrize("name", list(CONE_CASES))
def test_cone_line_search_kernel_matches_plain(cuda, monkeypatch, name):
    """``cone_line_search`` (one launch, one CTA a lane) with a cone
    outside lam's cone (skipped), binding tau and kappa steps and strided
    tau and kap, against ``cones.line_search``' torch code on the card: the
    same bits while its sums run in segsum's fixed order, within 1e-15 past
    it; within 1e-15 of the torch code on CPU copies."""
    from eicos_tpu_torch import cones

    st, c = cone_inputs(name, 3)
    lanes = c["s"].shape[0]
    _, lam = cones.update_scalings(st, c["s"].to(cuda), c["z"].to(cuda))
    lam[0, st.l] = -5.0
    tk = torch.stack([c["tau"], c["kap"]], 1).to(cuda)
    args = (lam, c["ds"].to(cuda), c["dz"].to(cuda), tk[:, 0],
            c["dtau"].to(cuda), tk[:, 1], c["dkap"].to(cuda), 1e-6, 0.999)
    got, n = launches("cone_line_search", cones.line_search, st, *args)
    assert n == 1
    assert float(got[0]) == float(c["tau"][0]) / 1e3       # tau binds
    assert float(got[-1]) == float(c["kap"][-1]) / 1e3     # kappa binds
    held(got, plain_on_card(monkeypatch, cones.line_search, st, *args),
         sequential(st.q))
    held(got, cones.line_search(st, *[a.cpu() if torch.is_tensor(a) else a
                                      for a in args]), False)


def test_cone_wrappers_check_inputs(cuda):
    """The cone kernels' wrappers refuse what their kernels cannot read:
    f32, a column stride, a wrong table of offsets."""
    from eicos_tpu_torch import cones
    from eicos_tpu_torch.ops import soc

    st, c = cone_inputs("q0", 4)
    s, z = c["s"].to(cuda), c["z"].to(cuda)
    offs = cones._k(st, s).offs
    with pytest.raises(ValueError):
        soc.scalings(st, offs, s.float(), z.float())
    with pytest.raises(ValueError):
        soc.scalings(st, offs, s.t().contiguous().t(), z)
    with pytest.raises(ValueError):
        soc.scalings(st, offs[:-1], s, z)
    scal, lam = cones.update_scalings(st, s, z)
    with pytest.raises(ValueError):
        soc.line_search(st, offs, lam, lam, lam, 1.0, -1.0, 1.0, -1.0, 1e-6,
                        0.999)


BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")


def bench_module(rel):
    """A module of the benchmark (``benchmark/<rel>``), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "card_" + rel.replace("/", "_")[:-3], os.path.join(BENCH, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_json(rel):
    with open(os.path.join(BENCH, rel)) as fh:
        return json.load(fh)


def pdg_batch(pt, N, lanes, seed):
    """The powered-descent family (``benchmark/families/pdg.py``) at N steps
    on a ``keep_soc`` band plan, and ``lanes`` ignition states dispersed as
    the benchmark's traffic disperses them: (structure, batch, the
    family's (G, A, C, h, B, l, q))."""
    from eicos_tpu_torch.plan import make_band_plan

    cfg = bench_json("configs/pdg_mars_n100.json")
    traffic = bench_json("traffic/pdg_mc128.json")
    G, A, c, h, b, l, q = bench_module("families/pdg.py").make(
        dict(cfg, horizon=N), 0)
    rng = np.random.default_rng([seed, 1])
    B = np.broadcast_to(b, (lanes, b.size)).copy()
    B[:, :cfg["nx"]] += traffic["b_sigma"] * rng.standard_normal(
        (lanes, cfg["nx"]))
    C = np.broadcast_to(c, (lanes, c.size)).copy()
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0], l,
                                    q).with_gsplit(G, A)
    st = st.with_band_plan(make_band_plan(st, G, A, keep_soc=True))
    return st, pt.ProblemData(G=G, A=A, c=C, h=h, b=B), (G, A, C, h, B, l, q)


def test_pdg_solve_takes_one_cone_kernel_a_region_call(cuda, monkeypatch):
    """The powered-descent SOCP at N = 20, four lanes, on a kept solver:
    its first (captured) and second (composed) solves end every lane
    OPTIMAL, as the CPU plain path does, their answers meet the
    optimality conditions at the benchmark cell's limits
    (``benchmark/reference/certificate.py``), and the second repeats the
    first's iterations.  (Their iterations and objectives are not the
    CPU's: this problem's endgame turns on the last bits, and the card's
    torch code, the cone kernels' parent, ended these lanes in 36, 39, 41,
    35 iterations against the CPU's 34, 39, 41, 36.)
    The same solve with its segments called eagerly gives the first's
    codes and iterations and launches, in each call of a cone region, one
    cone kernel: ``cone_scalings`` in "cones.scalings",
    ``cone_line_search`` in "cones.line_search", ``cone_eig`` or
    ``cone_rotate`` (or nothing, where the kept values come from the
    factor's ``cone_eig``) in "cones.kept_blocks"; none in the band
    regions ("band.factor", "band.sweeps") or outside the cone regions,
    and as many as the graphed solve counted."""
    import contextlib

    import eicos_tpu_torch as pt
    from eicos_tpu_torch import graphs
    from eicos_tpu_torch.ops import kernels

    lanes = 4
    st, batch, data = pdg_batch(pt, 20, lanes, 2 ** 31 + 11)
    certificate = bench_module("reference/certificate.py")
    limits = bench_json("limits/pdg.mc128.json")
    kw = dict(settings=pt.Settings(kkt_strategy="banded"),
              shared=("G", "A", "h"))
    cpu = pt.BatchedSolver(st, device="cpu", **kw).solve(batch)
    assert cpu.exit_code.tolist() == [0] * lanes
    bs = pt.BatchedSolver(st, **kw)
    kernels.reset_counts()
    first = bs.solve(batch)
    torch.cuda.synchronize()
    graphed = {n: kernels.COUNTS[n] for n in CONE_KERNELS}
    second = bs.solve(batch)
    for sol in (first, second):
        assert torch.equal(sol.exit_code.cpu(), cpu.exit_code)
        r = certificate.readings(*data, *[getattr(sol, f).cpu().numpy()
                                          for f in ("x", "y", "z", "s")])
        for name in certificate.READINGS:
            assert r[name].max() <= limits[name], name
    assert torch.equal(second.info.iter, first.info.iter)
    real, seen = graphs.region, []

    @contextlib.contextmanager
    def counted(name):
        torch.cuda.synchronize()
        before = {n: kernels.COUNTS[n] for n in CONE_KERNELS}
        with real(name):
            yield
        seen.append((name, {n: kernels.COUNTS[n] - before[n]
                            for n in CONE_KERNELS
                            if kernels.COUNTS[n] != before[n]}))

    with monkeypatch.context() as mp:
        mp.setattr(graphs.Segment, "__call__",
                   lambda self, *args: self._run(*args))
        mp.setattr(graphs.Program, "compose", lambda self, steps: None)
        mp.setattr(graphs, "region", counted)
        kernels.reset_counts()
        eager = pt.BatchedSolver(st, **kw).solve(batch)
        torch.cuda.synchronize()
    assert torch.equal(eager.exit_code, first.exit_code)
    assert torch.equal(eager.info.iter, first.info.iter)
    allowed = {"cones.scalings": [{"cone_scalings": 1}],
               "cones.line_search": [{"cone_line_search": 1}],
               "cones.kept_blocks": [{"cone_eig": 1}, {"cone_rotate": 1},
                                     {}],
               "band.factor": [{}], "band.sweeps": [{}]}
    for name, delta in seen:
        assert delta in allowed[name], (name, delta)
    total = {n: sum(d.get(n, 0) for _, d in seen) for n in CONE_KERNELS}
    assert total == {n: kernels.COUNTS[n] for n in CONE_KERNELS} == graphed
    assert all(total[n] > 0 for n in CONE_KERNELS)


DISTFLOW_MAX_ALLOCATED = 30 * 2 ** 30   # bytes; PERF.md section 4


def test_distflow_day_on_the_direct_scatter(cuda):
    """The day-ahead feeder SOCP at full size (``benchmark/families/
    distflow.py``, 24 hours: n 3432, 768 SOC(4), a keep_soc band of nb 71
    at block bandwidth 2) on 128 lanes dispersed as the cell's traffic
    disperses them, through a kept solver with the "reduced" rescue:
    every lane OPTIMAL on the banded path (the rescue idle), its answers
    within the cell's limits, the composed repeat the same bits; the
    bw-2 band factor (``band_factor_bw``, not the bw-1 cluster) and its
    sweeps launched, the traced program's band (71, 2) and its sweeps'
    panel ring (``band.sweep_ring``); and at most
    ``DISTFLOW_MAX_ALLOCATED`` bytes allocated: one lane-batch of the
    dense (Dp, Dp) K that the gathered path forms is 78.8 GiB."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import graphs, kkt
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.plan import make_band_plan
    from eicos_tpu_torch.utils import timing

    cfg = bench_json("configs/distflow_33bus_24h.json")
    traffic = bench_json("traffic/dist_mc128.json")
    limits = bench_json("limits/dist33.mc128.json")
    certificate = bench_module("reference/certificate.py")
    G, A, c, h, b, l, q = bench_module("families/distflow.py").make(cfg, 0)
    lanes = traffic["lanes"]
    rng = np.random.default_rng([2 ** 32 + 9, 1])
    Bv = np.broadcast_to(b, (lanes, b.size)).copy()
    Bv[:, :cfg["nx"]] += traffic["b_sigma"] * rng.standard_normal(
        (lanes, cfg["nx"]))
    C = np.broadcast_to(c, (lanes, c.size)).copy()
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0], l,
                                    q).with_gsplit(G, A)
    st = st.with_band_plan(make_band_plan(st, G, A, keep_soc=True))
    settings = pt.Settings(**cfg["settings"])
    assert (st.band.dim // B, st.band.bwb) == (71, 2)
    assert kkt._direct_band(st, settings)
    batch = pt.ProblemData(G=G, A=A, c=C, h=h, b=Bv)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    graphs.reset_stats()
    bs = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                          rescue=pt.Settings(**cfg["rescue"]))
    try:
        first = bs.solve(batch)
        assert list(bs.last_rescued) == []
        second = bs.solve(batch)
        torch.cuda.synchronize()
        graphs.settle()
        peak = torch.cuda.max_memory_allocated()
        counts, stats = dict(kernels.COUNTS), dict(graphs.STATS)
    finally:
        bs.close()
    optimal(first, lanes)
    assert same_bits(first, second)
    launched(counts, ("band_factor_bw", "band_fwd_bw", "band_bwd_bw"))
    not_launched(counts, ("band_factor_cluster",))
    if timing.tracing():
        from eicos_tpu_torch.ops import band

        assert tuple(stats["band_shape"]) == (71, 2)
        # the sweeps of a solve carry 1 or 2 right-hand sides: width 2
        assert stats["sweep_ring"] == {(2, 2): band.sweep_ring(2, 2, cuda)}
    assert peak <= DISTFLOW_MAX_ALLOCATED, peak
    r = certificate.readings(G, A, C, h, Bv, l, q,
                             *[getattr(second, f).cpu().numpy()
                               for f in ("x", "y", "z", "s")])
    for name in certificate.READINGS:
        assert r[name].max() <= limits[name], name
    assert int(second.info.iter.max()) <= limits["iter_max"]


# ------------------------------------------- the loop as captured graphs

def _graph_case(pt, corpus, case):
    """(structure, batch, BatchedSolver kwargs) of a small card case of
    each path that reaches ``solve_batch``."""
    from eicos_tpu_torch.plan import make_band_plan

    shared = ("G", "A", "h")
    lanes, rescue = 2, None
    if case in ("banded-socp",):
        st, base = corpus.make_mpc_soc(horizon=30, nx=2, nu=4, seed=5)
        st = st.with_gsplit(base.G, base.A)
        st = st.with_band_plan(make_band_plan(st, base.G, base.A,
                                              keep_soc=True))
        settings, lanes = pt.Settings(kkt_strategy="banded"), 4
    elif case == "wide":
        st, base = corpus.make_mpc_like(horizon=6, nx=40, nu=20, seed=3)
        st = st.with_gsplit(base.G, base.A)
        st = st.with_band_plan(make_band_plan(st, base.G, base.A))
        settings = pt.Settings(kkt_strategy="banded")
    elif case == "scan":
        st, base = corpus.make_mpc_like(horizon=3, nx=256, nu=128, seed=3)
        st = st.with_gsplit(base.G, base.A)
        st = st.with_band_plan(make_band_plan(st, base.G, base.A))
        settings = pt.Settings(kkt_strategy="banded")
    elif case == "block64":
        st, base = corpus.make_mpc_like(20, 2, 3, seed=1)
        st = st.with_gsplit(base.G, base.A)
        st = st.with_band_plan(make_band_plan(st, base.G, base.A, block=64))
        settings = pt.Settings(kkt_strategy="banded", block=64)
    else:
        st, base = corpus.make_mpc_like(horizon=30, nx=2, nu=4, seed=3)
        st = st.with_gsplit(base.G, base.A)
        st = st.with_band_plan(make_band_plan(st, base.G, base.A))
        if case == "banded-lp16":     # a tick: a cluster of CTAs a lane
            lanes = 16
        settings = {
            "banded-lp": pt.Settings(kkt_strategy="banded"),
            "banded-lp16": pt.Settings(kkt_strategy="banded"),
            "reduced": pt.Settings(kkt_strategy="reduced"),
            "full": pt.Settings(),
            "rescue": pt.Settings(kkt_strategy="banded", iter_max=3),
        }[case]
        if case == "rescue":
            rescue = pt.Settings(kkt_strategy="reduced")
    rng = np.random.default_rng(7)
    probs = [pt.ProblemData(G=base.G, A=base.A,
                            c=base.c + 0.02 * rng.standard_normal(st.n),
                            h=base.h, b=base.b) for _ in range(lanes)]
    return st, pt.BatchedSolver.stack(probs, shared=shared), dict(
        settings=settings, shared=shared, rescue=rescue)


def _counted(torch_, st, batch, kw):
    """One solve with the launch counts, host syncs and runner stats read
    around it."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import graphs, kkt
    from eicos_tpu_torch.ops import kernels

    graphs.reset_stats()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    bs = pt.BatchedSolver(st, **kw)
    sol = bs.solve(batch)
    torch_.cuda.synchronize()
    return (sol, dict(kernels.COUNTS), kkt.host_syncs - syncs0,
            dict(graphs.STATS), bs.last_rescued)


GRAPH_CASES = ["banded-lp", "banded-socp", "wide", "scan", "block64",
               "reduced", "full", "rescue"]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graphed_solve_equals_eager(cuda, monkeypatch, case):
    """A solve whose loop runs as captured graphs against the same solve
    with every segment called eagerly (with its program's probes, as an
    eager segment runs): exit codes, iterations, x, y, z, s and the
    refinement counts bit for bit, the same kernel launch counts (a
    structure with cones: its region stamps too) and host syncs; the
    graphed one captured and replayed."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, graphs

    st, batch, kw = _graph_case(pt, corpus, case)
    got, counts, syncs, stats, rescued = _counted(torch, st, batch, kw)
    assert stats["captures"] >= 3 and stats["replays"] > stats["captures"]
    with monkeypatch.context() as mp:
        mp.setattr(graphs.Segment, "__call__",
                   lambda self, *args: self._run(*args))
        mp.setattr(graphs.Program, "compose", lambda self, steps: None)
        want, wcounts, wsyncs, wstats, wrescued = _counted(torch, st, batch,
                                                           kw)
    assert wstats["captures"] == 0
    for f in ("exit_code", "x", "y", "z", "s"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("iter", "nitref1", "nitref2", "nitref3", "pcost"):
        assert torch.equal(getattr(got.info, f), getattr(want.info, f)), f
    assert counts == wcounts and syncs == wsyncs and rescued == wrescued
    if case == "rescue":
        assert len(rescued) > 0


@pytest.mark.parametrize("case", ["banded-lp", "banded-socp", "reduced",
                                  "full", "rescue"])
def test_failed_capture_raises(cuda, monkeypatch, case):
    """A segment whose function fails while it is being captured raises
    ``RuntimeError`` naming the segment; the solve does not finish
    eagerly."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import cones, corpus

    real = cones.update_scalings

    def failing(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("refused inside a capture")
        return real(*args, **kw)

    monkeypatch.setattr(cones, "update_scalings", failing)
    st, batch, kw = _graph_case(pt, corpus, case)
    with pytest.raises(RuntimeError, match="capturing segment 'iteration A' "
                       "failed: refused inside a capture"):
        pt.BatchedSolver(st, **kw).solve(batch)


def test_host_read_inside_a_capture_raises(cuda, monkeypatch):
    """A host read (``.item()``) inside a segment: its warm-up runs, its
    capture fails on the card and raises ``RuntimeError`` naming the
    segment."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import cones, corpus

    real = cones.update_scalings

    def reading(*args, **kw):
        out = real(*args, **kw)
        out[1].sum().item()
        return out

    monkeypatch.setattr(cones, "update_scalings", reading)
    st, batch, kw = _graph_case(pt, corpus, "banded-lp")
    with pytest.raises(RuntimeError, match="capturing segment 'iteration A' "
                       "failed"):
        pt.BatchedSolver(st, **kw).solve(batch)
    torch.cuda.synchronize()


def test_a_collected_solver_closes_outside_a_capture(cuda, monkeypatch):
    """A kept solver, its program composed, becomes cyclic garbage inside
    another solver's capture: the cyclic collector is off there (a
    collected solver's finalizer closes its program, and destroying a
    graph inside a capture invalidates the capture), on again after it,
    the solve ends OPTIMAL, and the old program closes at the next
    collection."""
    import gc

    import eicos_tpu_torch as pt
    from eicos_tpu_torch import cones, corpus

    st, batch, kw = _graph_case(pt, corpus, "banded-lp")
    old = pt.BatchedSolver(st, **kw)
    old.solve(batch)
    old.solve(batch)
    program = old._programs[0]
    assert program.loop is not None
    old.cycle = old
    holder = [old]
    del old
    real = cones.update_scalings
    seen = []

    def dropping(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            holder.clear()              # the old solver is garbage now
            seen.append(gc.isenabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(cones, "update_scalings", dropping)
    assert gc.isenabled()
    sol = pt.BatchedSolver(st, **kw).solve(batch)
    assert seen and not any(seen) and gc.isenabled()
    assert sol.exit_code.tolist() == [0] * sol.exit_code.shape[0]
    gc.collect()
    assert program.loop is None


def test_graphed_solves_release_their_pools(cuda):
    """Repeated graphed solves of the dense path (cuBLAS inside the
    captured factor) leave no graph pool behind: after the cache is
    emptied, the reserved memory does not grow from one solve to the
    next."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus

    st, batch, kw = _graph_case(pt, corpus, "reduced")
    bs = pt.BatchedSolver(st, **kw)
    reserved = []
    for _ in range(4):
        bs.solve(batch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[3] <= reserved[1], reserved


# ------------------------------------- programs kept across solves

def _stats_solve(torch_, bs, batch=None):
    """One solve of a kept solver with the counts, syncs and graph
    stats read around it."""
    from eicos_tpu_torch import graphs, kkt
    from eicos_tpu_torch.ops import kernels

    graphs.reset_stats()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    sol = bs.solve(batch)
    torch_.cuda.synchronize()
    graphs.settle()
    return (sol, dict(kernels.COUNTS), kkt.host_syncs - syncs0,
            dict(graphs.STATS))


@pytest.mark.parametrize("case", ["banded-lp", "banded-socp"])
def test_repeated_solves_replay_a_kept_program(cuda, case):
    """A ``BatchedSolver`` solves X, then Y (every value of G, A, c, h, b
    new: rows rescaled), then X: the later solves capture nothing, call
    no segment eagerly and are one composed launch with 0 host syncs, and
    each gives a fresh solver's bits and, settled, its launch counts (its
    loop tests as S2 launches, and the launch's two stamps beside the
    region stamps that a structure with cones has in both); the first
    result is unchanged at the end."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, graphs
    from test_torch_program import rescaled

    st, X, kw = _graph_case(pt, corpus, case)
    Y = rescaled(st, X, seed=11)
    bs = pt.BatchedSolver(st, **kw)
    first = _stats_solve(torch, bs, X)[0]
    kept = graphs.clone(first)
    for batch in (Y, X):
        got, counts, syncs, stats = _stats_solve(torch, bs, batch)
        assert stats["captures"] == 0 and stats["eager"] == 0, stats
        assert stats["loops"] == 1 and syncs == 0, stats
        want, wcounts, wsyncs, _ = _stats_solve(torch, pt.BatchedSolver(
            st, **kw), batch)
        for f in ("exit_code", "x", "y", "z", "s"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(got.info.iter, want.info.iter)
        assert counts == dict(wcounts, loop_cond=wsyncs,
                              loop_stamp=wcounts.get("loop_stamp", 0) + 2)
        assert got.exit_code.tolist() == [0] * got.exit_code.shape[0]
    for a, b in zip(graphs.tensors(first), graphs.tensors(kept)):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


def test_solver_update_data_replays_on_card(cuda):
    """``Solver.update_data`` with every value new: the re-solve captures
    nothing and gives a fresh ``Solver``'s bits."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, graphs
    from test_torch_program import rescaled

    st, X, kw = _graph_case(pt, corpus, "banded-lp")
    y = rescaled(st, X, seed=5)
    new = dict(G=y.G, A=y.A, c=y.c[0], h=y.h, b=y.b[0])
    s = pt.Solver(X.G, X.A, X.c[0], X.h, X.b[0], settings=kw["settings"])
    assert s.solve() == pt.ExitCode.OPTIMAL
    s.update_data(**new)
    graphs.reset_stats()
    assert s.solve() == pt.ExitCode.OPTIMAL
    assert graphs.STATS["captures"] == 0 and graphs.STATS["eager"] == 0
    other = pt.Solver(new["G"], new["A"], new["c"], new["h"], new["b"],
                      settings=kw["settings"])
    other.solve()
    for f in ("exit_code", "x", "y", "z"):
        assert torch.equal(getattr(s.last_solution, f),
                           getattr(other.last_solution, f)), f


def test_update_data_places_only_the_fields_given_on_card(cuda):
    """``BatchedSolver.update_data(c=, b=)`` and ``Solver.update_data(c=)``
    on the card: only the fields given are placed ("upload_bytes" is
    their bytes alone), the re-solve captures nothing, and it gives a
    fresh solver's bits."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, graphs

    st, X, kw = _graph_case(pt, corpus, "banded-lp")
    rng = np.random.default_rng(9)
    c = X.c + 0.01 * rng.standard_normal(X.c.shape)
    b = np.array(X.b)
    b[:, :2] += 0.05 * rng.standard_normal((b.shape[0], 2))
    bs = pt.BatchedSolver(st, **kw)
    bs.solve(X)
    graphs.reset_stats()
    bs.update_data(c=c, b=b)
    assert graphs.STATS["upload_bytes"] == c.nbytes + b.nbytes
    got, _, _, stats = _stats_solve(torch, bs)
    assert stats["captures"] == 0 and stats["eager"] == 0, stats
    want = pt.BatchedSolver(st, **kw).solve(pt.ProblemData(
        G=X.G, A=X.A, c=c, h=X.h, b=b))
    for f in ("exit_code", "x", "y", "z"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.exit_code.tolist() == [0] * c.shape[0]

    s = pt.Solver(X.G, X.A, X.c[0], X.h, X.b[0], settings=kw["settings"])
    assert s.solve() == pt.ExitCode.OPTIMAL
    graphs.reset_stats()
    s.update_data(c=c[0])
    assert graphs.STATS["upload_bytes"] == c[0].nbytes
    assert s.solve() == pt.ExitCode.OPTIMAL
    assert graphs.STATS["captures"] == 0 and graphs.STATS["eager"] == 0
    other = pt.Solver(X.G, X.A, c[0], X.h, X.b[0], settings=kw["settings"])
    other.solve()
    for f in ("exit_code", "x", "y", "z"):
        assert torch.equal(getattr(s.last_solution, f),
                           getattr(other.last_solution, f)), f


def test_reserved_memory_flat_over_repeated_solves(cuda):
    """Five repeated solves of a kept program: the reserved device memory,
    and its peak within each solve, do not move after the first solve."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus

    st, batch, kw = _graph_case(pt, corpus, "reduced")
    bs = pt.BatchedSolver(st, **kw)
    bs.solve(batch)
    torch.cuda.synchronize()
    held, peaks = [], []
    for _ in range(5):
        torch.cuda.reset_peak_memory_stats()
        bs.solve(batch)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_reserved())
        held.append(torch.cuda.memory_reserved())
    assert len(set(held)) == 1 and len(set(peaks)) == 1, (held, peaks)
    bs.close()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held[0]


# ------------------------------------- the solve as one composed graph

def _flag_body(cuda, N):
    """A captured graph (kept for composing) that adds one to a counter
    and sets one entry of a (4, 2) flag to "counter >= N", the others
    true; and its tensors."""
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    flags = torch.ones(4, 2, dtype=torch.bool, device=cuda)
    flags[2, 1] = N <= 0

    def body():
        count.add_(1)
        flags[2, 1:].copy_(count >= N)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        body()
    torch.cuda.current_stream().wait_stream(s)
    count.zero_()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        body()
    return g, count, flags


@pytest.mark.parametrize("N", [0, 1, 7])
def test_loop_cond_runs_a_while_body_n_times(cuda, N):
    """S2 alone: a graph of S2, then WHILE { a body that counts and flips
    one lane's flag after N trips; S2 }: the body runs N times, the first
    S2 node counts one launch and the body's N, as ``loop_cond_plain``
    counts on the same flags."""
    from eicos_tpu_torch.ops.graph_loop import LoopGraph, loop_cond_plain

    g, count, flags = _flag_body(cuda, N)
    trips = torch.zeros(2, dtype=torch.int64, device=cuda)
    lg = LoopGraph(cuda)
    try:
        h = lg.handle(lg.root)
        dep = lg.cond(lg.root, None, h, flags, trips, 0)
        _, body = lg.while_(lg.root, dep, h)
        last = lg.child(body, None, g.raw_cuda_graph())
        lg.cond(body, last, h, flags, trips, 1)
        lg.instantiate()
        for launch in (1, 2):
            count.zero_()
            flags[2, 1] = N <= 0
            lg.launch()
            torch.cuda.synchronize()
            assert int(count) == N
            assert trips.tolist() == [launch, launch * N]
    finally:
        lg.close()
    plain = torch.zeros(2, dtype=torch.int64)
    f = torch.ones(4, 2, dtype=torch.bool)
    f[2, 1] = N <= 0
    n = 0
    go = loop_cond_plain(f, plain, 0)
    while go:
        n += 1
        f[2, 1] = n >= N
        go = loop_cond_plain(f, plain, 1)
    assert n == N and plain.tolist() == [1, N]


@pytest.mark.parametrize("case", ["banded-lp", "banded-socp", "banded-lp16"])
def test_composed_solve_equals_host_replay(cuda, monkeypatch, case):
    """A kept solver's second solve is one composed launch: the bits of
    the same program's host-driven replay (exit codes, iterations, x, y,
    z, s, the refinement counts), 0 host syncs against the replay's one a
    loop test, and, settled, the replay's launch counts with each loop
    test an S2 launch (and the two stamps of a traced launch beside the
    region stamps that a structure with cones has in both); the replay is
    ``graphs.host_driven()``'s."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, graphs

    st, batch, kw = _graph_case(pt, corpus, case)
    bs = pt.BatchedSolver(st, **kw)
    bs.solve(batch)
    program = bs._programs[0]
    assert program.loop is not None
    print(f"{case}: composed in {program.loop.instantiate_s:.3f} s, "
          f"{program.loop.held_bytes} bytes on the card")
    got, counts, syncs, stats = _stats_solve(torch, bs, batch)
    assert stats["loops"] == 1 and syncs == 0 and stats["replays"] > 0
    with graphs.host_driven():
        want, wcounts, wsyncs, wstats = _stats_solve(torch, bs, batch)
    assert wstats["loops"] == 0 and wsyncs > 0
    assert wstats["replays"] == stats["replays"]
    for f in ("exit_code", "x", "y", "z", "s"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("iter", "nitref1", "nitref2", "nitref3", "pcost"):
        assert torch.equal(getattr(got.info, f), getattr(want.info, f)), f
    assert counts == dict(wcounts, loop_cond=wsyncs,
                          loop_stamp=wcounts.get("loop_stamp", 0) + 2)
    assert (wcounts.get("loop_stamp", 0) > 0) == (case == "banded-socp")
    lanes = batch.c.shape[0]
    assert counts[factor_name(lanes, st.band.bwb)] > 0


def test_disallowed_node_in_a_loop_raises(cuda):
    """A segment whose graph copies from pinned host memory (a memcpy node
    from the host, or an event node, which a conditional body may not
    hold) inside a composed loop: composing raises ``RuntimeError`` naming
    the segment and the node."""
    from eicos_tpu_torch import graphs

    class Owner:
        pass

    owner = Owner()
    host = torch.ones(4, dtype=torch.float64).pin_memory()
    with graphs.Program(cuda, owner=owner) as program:
        x = program.buffers(torch.zeros(4, dtype=torch.float64, device=cuda))
        done = program.buffers(torch.ones(1, dtype=torch.bool, device=cuda))
        seg = program.segment("host copy", lambda v: v.copy_(
            host, non_blocking=True), writes=(0,))
        seg(x)
        with pytest.raises(RuntimeError, match="composing segment 'host "
                           "copy' failed: "):
            program.compose(lambda call, loop: loop(
                done, lambda: call(seg, x)))


# ------------------------------------- spans and device stamps (tracing)

def test_host_driven_warm_solve_replays_its_segments(cuda):
    """Inside ``graphs.host_driven()`` a kept solver's warm solve is
    driven from the host: no composed launch, one host sync a loop test,
    the composed solve's bits; after the block the next solve is composed
    again."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, graphs

    st, batch, kw = _graph_case(pt, corpus, "banded-lp")
    bs = pt.BatchedSolver(st, **kw)
    bs.solve(batch)
    got, _, syncs, stats = _stats_solve(torch, bs, batch)
    assert stats["loops"] == 1 and syncs == 0
    with graphs.host_driven():
        assert graphs.is_host_driven()
        want, _, wsyncs, wstats = _stats_solve(torch, bs, batch)
    assert not graphs.is_host_driven()
    assert wstats["loops"] == 0 and wsyncs > 0 and wstats["captures"] == 0
    for f in ("exit_code", "x", "y", "z", "s"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert _stats_solve(torch, bs, batch)[3]["loops"] == 1


def test_stamps_time_each_segment_of_composed_solves(cuda):
    """Three composed solves of a kept solver, settled once: the nine
    segments' sums on the card's clock equal the three launches' spans,
    each launch's counts are one composed solve's (two of them the stamp
    kernel's), no host sync, each launch joined to its solve's request
    and lying, on the host's clock, between the solve's call and the
    synchronize after it (within the calibration's error), no ring entry
    overwritten."""
    import time

    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, graphs, kkt
    from eicos_tpu_torch.ops import kernels

    st, batch, kw = _graph_case(pt, corpus, "banded-lp")
    bs = pt.BatchedSolver(st, **kw)
    bs.solve(batch)
    want = _stats_solve(torch, bs, batch)[1]
    assert want["loop_stamp"] == 2
    graphs.reset_stats()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    marks = []
    for _ in range(3):
        t0 = time.perf_counter_ns()
        bs.solve(batch)
        torch.cuda.synchronize()
        marks.append((t0, time.perf_counter_ns()))
    graphs.settle()
    stats, counts = dict(graphs.STATS), dict(kernels.COUNTS)
    assert kkt.host_syncs == syncs0
    assert counts == {k: 3 * v for k, v in want.items()}
    launches, segs = stats["launches"], stats["segments_ns"]
    assert len(launches) == 3 and len(segs) == 9
    assert sum(segs.values()) == sum(e["device_ns"] for e in launches)
    for name in ("prologue", "iteration A", "iteration B", "iteration C",
                 "finish"):
        assert segs[name] > 0, name
    assert stats["stamps_overwritten"] == 0
    err = stats["clock_err_ns"]
    assert 0 < err < 1_000_000
    solves = [s for s in stats["spans"] if s["name"] == "api.solve"]
    assert [e["request"] for e in launches] == [s["request"] for s in solves]
    for e, (t0, t1) in zip(launches, marks):
        assert t0 - err <= e["start_ns"] < e["end_ns"] <= t1 + err
        assert e["end_ns"] - e["start_ns"] == pytest.approx(
            e["device_ns"], rel=1e-3)


def test_trace_off_gives_the_same_bits(cuda, monkeypatch):
    """The same composed solve with tracing on and off
    (``EICOS_TORCH_TRACE=0`` as the program composes): the same answer
    bits, and launch counts that differ by the stamp kernel alone: the
    launch's two and two a run of each region, the cones' and the band's
    (``graphs.Probes``; the structure has cones)."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus

    st, batch, kw = _graph_case(pt, corpus, "banded-socp")
    out = {}
    for trace in ("0", "1"):
        monkeypatch.setenv("EICOS_TORCH_TRACE", trace)
        bs = pt.BatchedSolver(st, **kw)
        bs.solve(batch)
        out[trace] = _stats_solve(torch, bs, batch)
        assert (bs._programs[0].stamps is None) == (trace == "0")
        bs.close()
    (off, coff, _, soff), (on, con, _, son) = out["0"], out["1"]
    for f in ("exit_code", "x", "y", "z", "s"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert torch.equal(on.info.iter, off.info.iter)
    regions = 2 * sum(son["regions_runs"].values())
    assert regions > 0 and "regions_runs" not in soff
    assert con == dict(coff, loop_stamp=2 + regions)
    assert coff["loop_stamp"] == 0
    assert soff["spans"] == [] and soff["launches"] == []
    assert len(son["launches"]) == 1


def test_stamp_ring_overflow_is_reported_on_card(cuda):
    """1,030 launches of a one-segment program with one settle: the card
    counts the 6 ring entries it overwrote, and the ring keeps the last
    1,024 launches; the stamp nodes counted two launches each."""
    from eicos_tpu_torch import graphs
    from eicos_tpu_torch.ops import kernels
    from eicos_tpu_torch.ops.graph_loop import LAUNCHES, STAMP_RING

    class Owner:
        pass

    owner = Owner()
    graphs.reset_stats()
    kernels.reset_counts()
    with graphs.Program(cuda, owner=owner) as program:
        x = program.buffers(torch.zeros(4, dtype=torch.float64, device=cuda))
        done = program.buffers(torch.ones(1, dtype=torch.bool, device=cuda))
        seg = program.segment("double", lambda v: v * 2.0)
        seg(x)
        program.compose(lambda call, loop: (loop(done, lambda: None),
                                            call(seg, x))[1])
        for _ in range(STAMP_RING + 6):
            program.launch()
        torch.cuda.synchronize()
        assert int(program.trips[program.stamps.block + LAUNCHES]) == \
            STAMP_RING + 6
        graphs.settle()
    stats = graphs.STATS
    assert stats["stamps_overwritten"] == 6
    assert [e["index"] for e in stats["launches"]] == list(
        range(6, STAMP_RING + 6))
    assert kernels.COUNTS["loop_stamp"] == 2 * (STAMP_RING + 6)


# ------------------------------------------- the card's build and settings

def test_tf32_is_off(cuda):
    """The f32 products of ``factor_dtype="float32"`` and ``band_gemm``
    run in full f32: TF32 is off once the package is imported."""
    import eicos_tpu_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32


def test_dgemm_machine_code_holds_dmma(cuda):
    """dgemm's machine code runs its products on the f64 tensor cores:
    ``cuobjdump -sass`` of the built library shows DMMA instructions."""
    import shutil
    import subprocess

    from eicos_tpu_torch.ops import kernels

    kernels.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", kernels.lib_path("dgemm")],
                          capture_output=True, text=True, check=True).stdout
    assert any("DMMA" in line for line in sass.splitlines())


# ------------------------------------------- the kernels at the paths' shapes
#
# The sizes of the paths below: the 128-lane horizon-249 LP of the
# mpc_lp cells (band nb 16, "reduced" Dp 2048, "full" Dp 7040), the wide
# band of make_mpc_like(30, 64, 32) (bwb 3, Dp 4864) and the scan's LP
# make_mpc_like(12, 256, 128) (bwb 9, Dp 7680).

HORIZON, NX, NU = 249, 2, 4
LANES = 128
RESCUE_LANES = 16
SOC_LANES = 8
WIDE = dict(horizon=30, nx=64, nu=32, seed=3)
WIDE_LANES, WIDE_BWB, WIDE_DP = 64, 3, 4864
SCAN = dict(horizon=12, nx=256, nu=128, seed=3)
SCAN_LANES, SCAN_BWB, SCAN_DP = 32, 9, 7680
FULL_LANES, FULL_DP = 8, 7040    # "full": 8 lanes, cut from 128 for memory
DENSE_DP = 2048                  # "reduced" on the LP
CPU_LANES = 4                    # lanes solved again on the CPU
BLOCK64_LANES = 4
KP = 16
KERNEL_TOL = 1e-10               # kernel vs plain twin, max relative error
RESID_TOL = 1e-9                 # ||K x - b||_inf / ||b||_inf
WIDE_TOL = 1e-12                 # wide band kernels vs plain twins
SUBST_TOL = 1e-12                # substitution sweeps vs plain
F32_LEAF_TOL = 2e-4              # f32 leaf and solve vs plain and vs f64
SPMV_TOL = 1e-14                 # gather kernel vs plain
LANE_TOL = 1e-8                  # lane 0: card vs CPU objective, relative
STRATEGY_TOL = 1e-7              # one strategy's objective vs another's
INACC_TOL = 1e-4                 # objective of a reduced-accuracy exit
F32_TOL = 1e-6                   # an f32 factor's definitive objective
F32_SCAN_TOL = 1e-4              # f32 scan (or f32 products): card vs CPU


def wide_matvec(Kd, Ks, x):
    """K x for the block-banded K of (Kd, Ks) in the band layout; x (L, k,
    Dp)."""
    lanes, k, Dp = x.shape
    nb, bw = Ks.shape[1], Ks.shape[2]
    xb = x.reshape(lanes, k, nb, B).permute(0, 2, 3, 1)    # (L, nb, B, k)
    y = Kd @ xb
    for j in range(1, min(bw, nb - 1) + 1):
        y[:, j:] += Ks[:, j:, j - 1] @ xb[:, :-j]
        y[:, :-j] += Ks[:, j:, j - 1].transpose(-1, -2) @ xb[:, j:]
    return y.permute(0, 3, 1, 2).reshape(lanes, k, Dp)


@pytest.mark.parametrize("bw,lanes,nb,tol", [
    (1, LANES, 16, KERNEL_TOL),              # the LP's band
    (2, 8, 7, WIDE_TOL), (6, 8, 9, WIDE_TOL),
    (WIDE_BWB, WIDE_LANES, WIDE_DP // B, WIDE_TOL)],
    ids=["bw1-lp", "bw2", "bw6", "bw3-wide"])
def test_band_kernels_at_path_shapes(cuda, bw, lanes, nb, tol):
    """The band factor and sweeps at the paths' shapes against their
    plain twins (``tol`` relative), the solve's residual ||K x - b|| /
    ||b|| within 1e-9, at k = 16, 2, 1; garbage left of block column 0 is
    never read and L is zero there."""
    from eicos_tpu_torch.ops import band
    from eicos_tpu_torch.ops import band_ldl as plain

    Kd, Ks = device_wide_band(lanes, nb, bw, 30 + bw, cuda)
    for j in range(1, bw + 1):
        Ks[:, :j, j - 1] = 1e300
    fk = band.band_factor(Kd, Ks)
    fp = plain.band_factor_bw_plain(Kd, Ks)
    for j in range(1, bw + 1):
        Ks[:, :j, j - 1] = 0.0
        assert not fk.L[:, :j, j - 1].any()
    for a, b in zip(fk, fp):
        assert rel(a, b) <= tol
    del fp
    g = torch.Generator(device=cuda).manual_seed(40 + bw)
    rhs = torch.randn(lanes, KP, nb * B, generator=g, dtype=torch.float64,
                      device=cuda)
    for k in (KP, 2, 1):
        r = rhs[:, :k].contiguous()
        w = band.band_fwd(fk, r)
        z = band.band_bwd(fk, w)
        assert rel(w, plain.band_fwd_bw_plain(fk, r)) <= tol, k
        assert rel(z, plain.band_bwd_bw_plain(fk, w)) <= tol, k
        assert rel(wide_matvec(Kd, Ks, z), r) <= RESID_TOL, k
    del Kd, Ks, fk, rhs
    torch.cuda.empty_cache()


def device_quasidefinite(lanes, D, pos, seed, device):
    """``quasidefinite``'s recipe made on the card."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    M = torch.randn(lanes, D, D, generator=g, dtype=torch.float64,
                    device=device) / D ** 0.5
    M = 0.5 * (M + M.transpose(-1, -2))
    sign = torch.where(torch.arange(D, device=device) < pos, 1.0, -1.0)
    M.diagonal(dim1=-2, dim2=-1).copy_(
        sign.to(M.dtype) * (1.0 + M.abs().sum(-1)))
    return M


@pytest.mark.parametrize("case", ["inverse", "subst", "subst-full", "f32"])
def test_dense_kernels_at_path_shapes(cuda, case):
    """The dense path's kernels at the paths' shapes.  "inverse": the
    inverse-solve passes on a factor of 128 lanes at Dp 2048 (the
    "reduced" LP) against their plain versions within 1e-10, at k = 16
    and 2, the solve's residual within 1e-9.  "subst": the substitution
    factor of the same matrices packs bit for bit as ``pack_dense_plain``
    and has the inverse factor's pivots and leaf inverses bit for bit, in
    60 (inverse) and 52 (substitution) dgemm launches a factor; its sweeps
    within 1e-12 of their plain versions, the residual within 1e-9.
    "subst-full": the sweeps at 4 lanes of "full"'s Dp 7040.  "f32": the
    f32 factor and solve (f32 leaf, ``torch.matmul`` products) within
    2e-4 of the f64 ones at 8 lanes of Dp 512."""
    from eicos_tpu_torch.ops import dense, gemm, kernels, ldl

    g = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           device=cuda)

    if case == "f32":
        K = device_quasidefinite(8, 4 * B, 300, 17, cuda)
        r = rnd(8, 2, 4 * B)
        x64 = ldl.ldl_solve(ldl.ldl_factor(K.clone()), r)
        x32 = ldl.ldl_solve(ldl.ldl_factor(K.to(torch.float32)),
                            r.to(torch.float32))
        assert x32.dtype == torch.float32
        assert rel(x32.double(), x64) <= F32_LEAF_TOL
        return
    lanes, D = (4, FULL_DP) if case == "subst-full" else (LANES, DENSE_DP)
    K = device_quasidefinite(lanes, D, 1500 if D == DENSE_DP else 5000,
                             3 if D == DENSE_DP else 16, cuda)
    if case == "inverse":
        fac = ldl.ldl_factor(K.clone())
        for k in (KP, 2):
            r = rnd(lanes, k, D)
            t = gemm.linv_fwd(fac.Linv, fac.d, r)
            x = gemm.linv_bwd(fac.Linv, t)
            assert rel(t, gemm.linv_fwd_plain(fac.Linv, fac.d, r)) \
                <= KERNEL_TOL, k
            assert rel(x, gemm.linv_bwd_plain(fac.Linv, t)) <= KERNEL_TOL, k
            assert rel(torch.matmul(x, K), r) <= RESID_TOL, k
        del K, fac
        torch.cuda.empty_cache()
        return
    K2 = K.clone()
    if case == "subst":
        kernels.reset_counts()
        inv = ldl.ldl_factor(K.clone())
        n_inv = kernels.COUNTS["dgemm"]
        kernels.reset_counts()
        fs = ldl.ldl_factor_subst(K2)     # K2 now holds L below its diagonal
        torch.cuda.synchronize()
        assert (n_inv, kernels.COUNTS["dgemm"]) == (60, 52)
        assert torch.equal(fs.pre.Lp, dense.pack_dense_plain(K2))
        assert torch.equal(fs.d, inv.d)
        for i in range(D // B):
            assert torch.equal(
                fs.pre.Xinv[:, i],
                inv.Linv[:, i * B:(i + 1) * B, i * B:(i + 1) * B]), i
        del inv
    else:
        fs = ldl.ldl_factor_subst(K2)
    del K2
    for k in ((KP, 2) if case == "subst" else (2,)):
        r = rnd(lanes, k, D)
        w = dense.dense_fwd(fs.pre, r)
        z = dense.dense_bwd(fs.pre, w)
        assert rel(w, dense.dense_fwd_plain(fs.pre, r)) <= SUBST_TOL, k
        assert rel(z, dense.dense_bwd_plain(fs.pre, w)) <= SUBST_TOL, k
        assert rel(torch.matmul(z, K), r) <= RESID_TOL, k
    del K, fs
    torch.cuda.empty_cache()


def _path_operands(label):
    """(structure, G, A on the card, the operands ``kkt.make_sliced``
    builds) of the LP of the mpc_lp cells ("lp") or of the wide band
    ("wide") or the scan ("scan") below."""
    from eicos_tpu_torch import corpus, kkt

    kw = {"lp": dict(horizon=HORIZON, nx=NX, nu=NU, seed=3), "wide": WIDE,
          "scan": SCAN}[label]
    st, base = corpus.make_mpc_like(**kw)
    st = st.with_gsplit(base.G, base.A)
    G = torch.tensor(base.G, device="cuda")
    A = torch.tensor(base.A, device="cuda")
    return st, G, A, kkt.make_sliced(st, G, A, st.m)


@pytest.mark.parametrize("label,keys", [
    ("lp", ("sG", "sGT", "sA", "sAT", "sGA", "sAGT")),
    ("scan", ("sG", "sGT"))])
def test_spmv_on_path_operands(cuda, label, keys):
    """The gather kernel on the operands the paths give it at 128 lanes,
    k = 1, 2, in every product site's form (``SPMV_FORMS``): within 1e-14
    of its plain version, bit for bit the sequence it replaces and its
    repeat; ``elim_t``'s zeros of acc - base come back."""
    from eicos_tpu_torch.ops import spmv

    st, G, A, ops = _path_operands(label)
    gen = torch.Generator(device=cuda).manual_seed(11)
    for key in keys:
        op = ops[key]
        assert isinstance(op, spmv.SparseOperand), key
        km0 = st.m if key == "sGA" else op.km // 3
        split = st.p if key == "sAGT" else op.nm // 3

        def K(a):
            return spmv.spmv(a.contiguous(), op.colptr, op.rows, op.vals,
                             op.nm)

        for k in (1, 2):
            def rnd(cols):
                return torch.randn(LANES, k, cols, generator=gen,
                                   device=cuda, dtype=torch.float64)

            a = rnd(op.km)
            for form in SPMV_FORMS:
                kw, seq = spmv_form(form, a, op.nm, km0, split, rnd)
                if form == "elim_t":
                    kw["base"][..., ::10] = K(a)[..., ::10]
                first = kw.pop("a")
                tail = {n: v for n, v in kw.items() if n != "a2"}
                want = spmv.fused_tail(op.rmatmul_plain(a), **tail)
                got = op.rmatmul_fused(first, **kw)
                assert rel(got, want) <= SPMV_TOL, (key, k, form)
                assert torch.equal(bits(got), bits(seq(K))), (key, k, form)
                assert torch.equal(bits(got),
                                   bits(op.rmatmul_fused(first, **kw)))
                if form == "elim_t":
                    assert (got[..., ::10] == 0).all(), (key, k)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("label,lanes", [("wide", WIDE_LANES),
                                         ("scan", SCAN_LANES)])
def test_dgemm_on_wide_path_operands(cuda, label, lanes):
    """dgemm as ``kkt.WideOperand`` runs it on the operands of the wide
    band's and the scan's paths (sA, sAT a strided transpose, the stacks
    sGA and sAGT), at the path's lanes and at 128, k = 1, 2: one launch a
    product, within 1e-10 of ``gemm.matmul_plain``."""
    from eicos_tpu_torch import kkt
    from eicos_tpu_torch.ops import gemm, kernels

    _, G, A, ops = _path_operands(label)
    gen = torch.Generator(device=cuda).manual_seed(12)
    for key in ("sA", "sAT", "sGA", "sAGT"):
        op = ops[key]
        assert isinstance(op, kkt.WideOperand), key
        km = op.bmat.shape[0]
        for ln, k in ((lanes, 1), (lanes, 2), (LANES, 1), (LANES, 2)):
            a = torch.randn(ln, k, km, generator=gen, device=cuda,
                            dtype=torch.float64)
            before = kernels.COUNTS["dgemm"]
            got = op.rmatmul(a)
            assert kernels.COUNTS["dgemm"] == before + 1, (key, ln, k)
            assert rel(got, gemm.matmul_plain(a, op.bmat)) <= KERNEL_TOL
    torch.cuda.empty_cache()


def flag_cases(seed):
    """The loop flags of the LP's path, (128,) the lanes' done and (128,
    2), (128, 1) the refinement columns', each all true, with one entry
    false and with random entries."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((LANES,), (LANES, 2), (LANES, 1)):
        for pattern in ("all", "one", "random"):
            f = np.ones(shape, bool)
            if pattern == "one":
                f.flat[int(rng.integers(f.size))] = False
            elif pattern == "random":
                f = rng.random(shape) < 0.9
            out.append(f)
    return out


def fill_graph(flags):
    """A captured graph, kept for composing, that sets every flag true."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        flags.fill_(True)
    return g


def test_loop_cond_counts_trips_on_path_flags(cuda):
    """S2 on the path's flag shapes: a graph of S2, then WHILE { set every
    flag true; S2 } counts the trips ``loop_cond_plain`` counts."""
    from eicos_tpu_torch.ops.graph_loop import LoopGraph, loop_cond_plain

    for f in flag_cases(17):
        flags = torch.tensor(f, device=cuda)
        trips = torch.zeros(2, dtype=torch.int64, device=cuda)
        body = fill_graph(flags)
        lg = LoopGraph(cuda)
        try:
            h = lg.handle(lg.root)
            dep = lg.cond(lg.root, None, h, flags, trips, 0)
            _, loop = lg.while_(lg.root, dep, h)
            last = lg.child(loop, None, body.raw_cuda_graph())
            lg.cond(loop, last, h, flags, trips, 1)
            lg.instantiate()
            lg.launch()
            torch.cuda.synchronize()
        finally:
            lg.close()
        plain = torch.zeros(2, dtype=torch.int64)
        pf = torch.tensor(f)
        if loop_cond_plain(pf, plain, 0):
            pf.fill_(True)
            loop_cond_plain(pf, plain, 1)
        assert torch.equal(trips.cpu(), plain), f.shape


def stamp_graph(flags, trips, body_graph):
    """A traced program graph's shape on the stamp block at ``trips[2]``:
    a start stamp, S2 on ``flags`` (counted at ``trips[0]``, closing the
    first accumulator), a WHILE node whose body is ``body_graph`` and S2
    again (``trips[1]``, closing the second), an end stamp closing the
    third.  Instantiated; returns it and the accumulators' cells."""
    from eicos_tpu_torch.ops.graph_loop import (END, STAMP_CELLS, START,
                                                LoopGraph)

    block = 2
    acc = tuple(block + STAMP_CELLS + k for k in range(3))
    lg = LoopGraph(flags.device)
    try:
        h = lg.handle(lg.root)
        dep = lg.stamp(lg.root, None, trips, block, START)
        dep = lg.cond(lg.root, dep, h, flags, trips, 0, block, acc[0])
        node, body = lg.while_(lg.root, dep, h)
        last = lg.child(body, None, body_graph.raw_cuda_graph())
        lg.cond(body, last, h, flags, trips, 1, block, acc[1])
        lg.stamp(lg.root, node, trips, block, END, acc[2])
        lg.instantiate()
    except BaseException:
        lg.close()
        raise
    return lg, acc


def stamp_replay(f, reads, acc):
    """The block that ``loop_stamp_plain`` and the stamped
    ``loop_cond_plain`` make of the launches of ``stamp_graph`` on flags
    ``f``, fed the card's own clock readings: ``reads`` holds ``trips``
    before the first launch and after each.  A launch's start and end are
    its ring entry; its S2 stamps are the start plus the first
    accumulator's growth, and that plus the second's."""
    from eicos_tpu_torch.ops.graph_loop import (LAUNCHES, RING, STAMP_RING,
                                                START, END, loop_cond_plain,
                                                loop_stamp_plain)

    block = 2
    plain = torch.tensor(reads[0])
    pf = torch.tensor(f)
    for before, after in zip(reads, reads[1:]):
        i = before[block + LAUNCHES]
        e = block + RING + 2 * (i % STAMP_RING)
        t0, t_end = after[e], after[e + 1]
        t1 = t0 + after[acc[0]] - before[acc[0]]
        loop_stamp_plain(plain, block, START, t0)
        if loop_cond_plain(pf, plain, 0, block, acc[0], t1):
            pf.fill_(True)
            loop_cond_plain(pf, plain, 1, block, acc[1],
                            t1 + after[acc[1]] - before[acc[1]])
        loop_stamp_plain(plain, block, END, t_end, acc[2])
    return plain


def test_loop_stamp_against_plain_replay(cuda):
    """The stamp kernel and S2's stamps on the path's flag shapes, each in
    ``stamp_graph`` launched once, then the lanes' flags all true launched
    ``STAMP_RING`` + 3 times: after every launch the card's block equals,
    cell for cell, what the plain versions make of the clock readings the
    card wrote (trip counters, last stamp, launch counter, the 3
    overwritten ring entries, two stamp nodes a launch, ring and
    accumulators), and the accumulators sum to the launches' spans."""
    from eicos_tpu_torch.ops.graph_loop import (LAUNCHES, OVERWRITTEN, RING,
                                                STAMP_CELLS, STAMP_RING,
                                                STAMPS)

    block = 2
    cases = [(f, 1) for f in flag_cases(19)]
    cases.append((np.ones(LANES, bool), STAMP_RING + 3))
    for f, n in cases:
        flags = torch.tensor(f, device=cuda)
        trips = torch.zeros(block + STAMP_CELLS + 3, dtype=torch.int64,
                            device=cuda)
        lg, acc = stamp_graph(flags, trips, fill_graph(flags))
        reads = [trips.tolist()]
        try:
            for _ in range(n):
                lg.launch()
                reads.append(trips.tolist())
        finally:
            lg.close()
        got = reads[-1]
        assert got == stamp_replay(f, reads, acc).tolist(), (f.shape, n)
        ends = [block + RING + 2 * ((r[block + LAUNCHES] - 1) % STAMP_RING)
                for r in reads[1:]]
        spans = sum(r[e + 1] - r[e] for r, e in zip(reads[1:], ends))
        assert (got[block + LAUNCHES], got[block + OVERWRITTEN],
                got[block + STAMPS], sum(got[a] for a in acc)) == (
            n, max(0, n - STAMP_RING), 2 * n, spans)


def test_stamp_on_regions_against_plain(cuda):
    """``graph_loop.stamp_on``, the region stamps of a traced program with
    cones: a captured segment on a ``graphs.Probes``-shaped tensor holds
    three regions, the first entered twice (as the factor enters
    "cones.kept_blocks"), and a copy of the first region's (start, end)
    after its first run.  Over 5 replays each cell the card writes equals
    what ``loop_stamp_plain(..., ring=1, acc=...)`` makes of its clock
    readings, and the regions count 10, 5 and 5 runs."""
    from eicos_tpu_torch.graphs import REGION_CELLS
    from eicos_tpu_torch.ops.graph_loop import (END, RING, START,
                                                loop_stamp_plain, stamp_on)

    nreg = 3
    spare = 1 + REGION_CELLS * nreg
    cells = torch.zeros(spare + 2, dtype=torch.int64, device=cuda)
    x = torch.ones(1 << 16, dtype=torch.float64, device=cuda)
    blocks = [1 + REGION_CELLS * r for r in range(nreg)]
    order = [0, 1, 0, 2]            # region 0 entered twice
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        x.mul_(1.0)                 # warm the elementwise kernel
        torch.cuda.synchronize(cuda)
        with torch.cuda.graph(graph, stream=stream):
            for k, r in enumerate(order):
                b = blocks[r]
                stamp_on(cells, b, START)
                x.mul_(1.0 + 1e-9 * (k + 1))
                stamp_on(cells, b, END, acc=b + REGION_CELLS - 1)
                if k == 0:
                    cells[spare:spare + 2].copy_(cells[b + RING:b + RING + 2])
    torch.cuda.current_stream(cuda).wait_stream(stream)
    cells.zero_()
    torch.cuda.synchronize(cuda)
    host = torch.zeros_like(cells, device="cpu")
    for _ in range(5):
        graph.replay()
        got = cells.cpu()
        for k, r in enumerate(order):
            b = blocks[r]
            at = spare if (r == 0 and k == 0) else b + RING
            t0, t1 = int(got[at]), int(got[at + 1])
            loop_stamp_plain(host, b, START, t0, ring=1)
            loop_stamp_plain(host, b, END, t1, acc=b + REGION_CELLS - 1,
                             ring=1)
        host[spare:spare + 2] = got[spare:spare + 2]
        assert torch.equal(got, host)
    assert [int(got[b + 1]) for b in blocks] == [10, 5, 5]


# ------------------------------------------- the paths at full size

def perturbed_lanes(pt, st, base, lanes, nx, seed):
    """bench.py's lanes of one base problem: shared G/A/h, per-lane c and
    x0 (the first ``nx`` entries of b): (structure, problems, batch,
    shared)."""
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(lanes):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(st.n)
        b = np.asarray(base.b).copy()
        b[:nx] += 0.05 * rng.standard_normal(nx)
        probs.append(pt.ProblemData(G=base.G, A=base.A, c=c, h=base.h, b=b))
    shared = ("G", "A", "h")
    return st, probs, pt.BatchedSolver.stack(probs, shared=shared), shared


class FullSize:
    """The batches of the full-size paths, each made once a module, and
    the objectives one path holds another's to: a path stores its own,
    and a case run alone solves the one it needs."""

    def __init__(self):
        self.made = {}
        self.refs = {}

    def batch(self, kind):
        """(structure, problems, batch, shared) of ``kind``: "lp" the
        horizon-249 LP with its band plan (128 lanes), "socp" the
        horizon-249 SOC-constrained MPC without a plan (128 lanes; "socp8"
        its first 8), "socp-band" with the keep_soc plan, "wide" the wide
        band (64 lanes), "scan" the scan's LP (32 lanes)."""
        if kind not in self.made:
            import eicos_tpu_torch as pt
            from eicos_tpu_torch import corpus
            from eicos_tpu_torch.plan import make_band_plan

            if kind.startswith("socp"):
                st, base = corpus.make_mpc_soc(horizon=HORIZON, nx=NX, nu=NU,
                                               seed=5)
                lanes, nx, seed = (SOC_LANES if kind == "socp8" else LANES,
                                   NX, 11)
            else:
                kw = {"lp": dict(horizon=HORIZON, nx=NX, nu=NU, seed=3),
                      "wide": WIDE, "scan": SCAN}[kind]
                st, base = corpus.make_mpc_like(**kw)
                lanes, nx, seed = {"lp": LANES, "wide": WIDE_LANES,
                                   "scan": SCAN_LANES}[kind], kw["nx"], 7
            st = st.with_gsplit(base.G, base.A)
            if kind in ("lp", "wide", "scan", "socp-band"):
                st = st.with_band_plan(make_band_plan(
                    st, base.G, base.A, keep_soc=kind == "socp-band"))
            self.made[kind] = perturbed_lanes(pt, st, base, lanes, nx, seed)
        return self.made[kind]

    def ref(self, key):
        """The objectives (and lane 0's exit) another path is held to:
        "banded" the LP's under "banded" with the "reduced" rescue,
        "reduced" its (exit code, iterations, objective) of lane 0 under
        "reduced" (inverse), "soc-reduced" the 8 SOCP lanes' under
        "reduced" (inverse), "soc-banded" the SOCP lanes' under "banded"
        with the keep_soc plan and the rescue."""
        if key not in self.refs:
            import eicos_tpu_torch as pt

            kind, cfg, rescue = {
                "banded": ("lp", dict(kkt_strategy="banded"), True),
                "reduced": ("lp", dict(kkt_strategy="reduced",
                                       dense_solve="inverse"), False),
                "soc-reduced": ("socp8", dict(kkt_strategy="reduced",
                                              dense_solve="inverse"), False),
                "soc-banded": ("socp-band", dict(kkt_strategy="banded"),
                               True)}[key]
            st, _, batch, shared = self.batch(kind)
            bs = pt.BatchedSolver(
                st, pt.Settings(**cfg), shared=shared,
                rescue=pt.Settings(kkt_strategy="reduced") if rescue
                else None)
            self.keep(key, bs.solve(batch))
            bs.close()
        return self.refs[key]

    def keep(self, key, sol):
        """Store ``sol``'s objectives (lane 0's exit too, for
        "reduced")."""
        pc = sol.info.pcost.cpu().numpy()
        self.refs[key] = pc if key != "reduced" else (
            int(sol.exit_code[0]), int(sol.info.iter[0]), float(pc[0]))


@pytest.fixture(scope="module")
def full_size():
    return FullSize()


@pytest.fixture
def counted_factors(monkeypatch):
    """``kkt.factor`` counts its calls under "factors" in
    ``kernels.COUNTS`` (through ``kernels.count``, so that a captured
    factor counts at every replay)."""
    from eicos_tpu_torch import kkt
    from eicos_tpu_torch.ops import kernels

    real = kkt.factor

    def counted(*args, **kw):
        kernels.count("factors")
        return real(*args, **kw)

    monkeypatch.setitem(kernels.COUNTS, "factors", 0)
    monkeypatch.setattr(kkt, "factor", counted)


def same_bits(a, b):
    """Exit codes, iterations, x, y and z bit for bit."""
    return all(torch.equal(u, v) for u, v in (
        (a.exit_code, b.exit_code), (a.info.iter, b.info.iter), (a.x, b.x),
        (a.y, b.y), (a.z, b.z)))


def launched(counts, names):
    """Every kernel of ``names`` launched."""
    missing = [n for n in names if not counts[n] > 0]
    assert not missing, (missing, counts)


def not_launched(counts, names):
    """No kernel of ``names`` launched."""
    assert not any(counts[n] for n in names), (names, counts)


def as_composed(counts, syncs, loops):
    """A host-driven solve's counts as a composed solve of the same data
    in ``loops`` composed launches shows them, settled: each of its loop
    tests an S2 launch, and two stamp launches a traced launch beside the
    region stamps that a structure with cones has in both."""
    from eicos_tpu_torch.utils import timing

    return dict(counts, loop_cond=counts.get("loop_cond", 0) + syncs,
                loop_stamp=counts.get("loop_stamp", 0)
                + 2 * loops * timing.tracing())


def composed_only(syncs, stats):
    """The solve was one composed launch a program solve: no capture, no
    eager call, no host sync; the stamp nodes counted two launches a
    traced composed launch, beside two a run of each region.  Returns
    the composed launches."""
    from eicos_tpu_torch.utils import timing

    loops = stats["loops"]
    assert loops and loops == stats["solves"], stats
    assert syncs == 0 and not stats["captures"] and not stats["eager"], (
        syncs, stats)
    regions = 2 * sum(stats.get("regions_runs", {}).values())
    assert stats["graph_counts"].get("loop_stamp", 0) == (
        2 * loops * timing.tracing() + regions)
    return loops


def same_solve(got, want, counts=None, syncs=None, loops=None):
    """``got`` has ``want``'s bits and, given the (got, want) counts and
    syncs of a composed ``got`` in ``loops`` launches and a fresh
    host-driven ``want``, 0 host syncs and ``want``'s counts as
    composed."""
    assert same_bits(got, want)
    if counts is not None:
        assert syncs[0] == 0
        assert counts[0] == as_composed(counts[1], syncs[1], loops)


def eager_then_composed(monkeypatch, bs, batch, first, counts, syncs, stats):
    """The graphed first solve ``first`` (its counts, syncs and stats
    from ``_stats_solve``) against the same solve with every segment called
    eagerly: the same bits, counts and syncs, and a solve past iteration
    1 captured; then the solver's next solve, one composed launch a
    program with no host sync: the same bits and the first's counts once
    settled.  Returns the composed solve's counts."""
    from eicos_tpu_torch import graphs

    with monkeypatch.context() as mp:
        mp.setattr(graphs.Segment, "__call__",
                   lambda self, *args: self._run(*args))
        mp.setattr(graphs.Program, "compose", lambda self, steps: None)
        with graphs.host_driven():
            sol, e_counts, e_syncs, _ = _stats_solve(torch, bs, batch)
    assert same_bits(first, sol)
    assert counts == e_counts and syncs == e_syncs, (counts, e_counts)
    if int(first.info.iter.max()) > 1:
        assert stats["captures"]
    sol, c_counts, c_syncs, c_stats = _stats_solve(torch, bs, batch)
    loops = composed_only(c_syncs, c_stats)
    same_solve(sol, first, (c_counts, counts), (c_syncs, syncs), loops)
    return c_counts


def same_bits_unfused(monkeypatch, bs, batch, first):
    """A solve with every fused gather call run as the sequence it
    replaces (the kernel with no epilogue on the concatenated input, then
    ``spmv.fused_tail``'s torch ops) gives the bits of ``first``.  The
    kept programs are released before and after: the solve captures the
    patched calls."""
    from eicos_tpu_torch.ops import spmv

    real = spmv.SparseOperand.rmatmul_fused

    def unfused(self, a, a2=None, base=None, op="add", w=None, gamma=0.0,
                x=None, split=None):
        ab = a if a2 is None else torch.cat([a, a2], -1)
        return spmv.fused_tail(real(self, ab), base, op, w, gamma, x, split)

    bs.close()
    with monkeypatch.context() as mp:
        mp.setattr(spmv.SparseOperand, "rmatmul_fused", unfused)
        sol = bs.solve(batch)
        torch.cuda.synchronize()
    bs.close()
    assert same_bits(first, sol)


def optimal(sol, lanes):
    assert sol.exit_code.tolist() == [0] * lanes, sol.exit_code.tolist()


def all_optimal_or_as_cpu(pt, st, probs, shared, settings, rescue, sol):
    """Every lane ends OPTIMAL, or, solved again on the CPU plain path,
    with the CPU's code there."""
    codes = sol.exit_code.cpu().numpy()
    bad = [int(i) for i in np.flatnonzero(codes != 0)]
    if bad:
        cpu = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue,
                               device="cpu").solve(pt.BatchedSolver.stack(
                                   [probs[i] for i in bad], shared=shared))
        assert cpu.exit_code.tolist() == codes[bad].tolist(), bad


def same_as_cpu(pt, st, prob, settings, sol):
    """Lane 0 on the CPU plain path: the same exit code and iterations,
    the objective within 1e-8."""
    cpu = pt.solve(st, prob, settings, device="cpu")
    assert int(cpu.exit_code) == int(sol.exit_code[0])
    assert int(cpu.info.iter) == int(sol.info.iter[0])
    c_pc = float(cpu.info.pcost)
    assert abs(float(sol.info.pcost[0]) - c_pc) <= LANE_TOL * abs(c_pc)


def tiers_as_cpu(pt, st, probs, shared, settings, sol, lanes):
    """Paths whose endgame turns on the last bits ("normal" on a SOCP, an
    f32 factor): on the CPU plain path the lanes ``lanes`` end with an
    answer (definitive or reduced-accuracy) exactly where the card's do,
    the objective within 1e-4."""
    from eicos_tpu_torch.api import _code_rank

    cpu = pt.BatchedSolver(st, settings, shared=shared, device="cpu").solve(
        pt.BatchedSolver.stack([probs[i] for i in lanes], shared=shared))
    codes = sol.exit_code.cpu().numpy()[lanes].tolist()
    pc = sol.info.pcost.cpu().numpy()[lanes]
    cpc = cpu.info.pcost.numpy()
    for j, c in enumerate(cpu.exit_code.tolist()):
        assert bool(_code_rank(codes[j])) == bool(_code_rank(c)), (
            lanes[j], codes[j], c)
        if _code_rank(codes[j]):
            assert abs(pc[j] - cpc[j]) <= INACC_TOL * abs(cpc[j]), lanes[j]


def objectives_close(sol, want, tol_by_tier):
    """The first ``len(want)`` lanes that exit with an answer have the
    objective ``want``, within ``tol_by_tier[tier]`` relative (tier 2
    definitive, 1 reduced accuracy)."""
    from eicos_tpu_torch.api import _code_rank

    codes = sol.exit_code.cpu().numpy()[:len(want)]
    pc = sol.info.pcost.cpu().numpy()[:len(want)]
    for tier, tol in tol_by_tier.items():
        sel = np.array([_code_rank(int(c)) == tier for c in codes])
        if sel.any():
            assert (np.abs(pc[sel] - want[sel]) / np.abs(want[sel])).max() \
                <= tol, tier


def tiers_of_short_lanes(pt, st, probs, shared, settings, rescue, sol):
    """``tiers_as_cpu`` on the lanes short of OPTIMAL, for a path whose
    endgame turns on the last bits."""
    bad = [int(i) for i in np.flatnonzero(sol.exit_code.cpu().numpy() != 0)]
    if bad:
        tiers_as_cpu(pt, st, probs, shared, settings, sol, bad)


def run_path(monkeypatch, pt, st, probs, batch, shared, settings, rescue,
             names, short=all_optimal_or_as_cpu):
    """One path at full width: a first solve that launches ``names``, held
    to its eager segments and its composed next solve, a repeat with its
    bits, a solve through the unfused gather sequence where the path
    launches the gather kernel, every lane OPTIMAL (or as on the CPU,
    ``short``), lane 0 as on the CPU.  Returns the first solve's counts,
    the composed solve's counts, the repeat and the rescued lanes."""
    bs = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue)
    first, counts, syncs, stats = _stats_solve(torch, bs, batch)
    launched(counts, names)
    composed = eager_then_composed(monkeypatch, bs, batch, first, counts,
                                   syncs, stats)
    again = bs.solve(batch)
    rescued = bs.last_rescued
    assert same_bits(first, again)
    if "spmv" in names:
        same_bits_unfused(monkeypatch, bs, batch, first)
    short(pt, st, probs, shared, settings, rescue, again)
    same_as_cpu(pt, st, probs[0], settings, again)
    bs.close()
    return counts, composed, again, rescued


BAND = ("band_factor_bw", "band_fwd_bw", "band_bwd_bw")
INVERSE = ("leaf_ldl", "dgemm", "linv_fwd", "linv_bwd")
SUBST = ("leaf_ldl", "dgemm", "dense_pack", "dense_fwd", "dense_bwd")
LINV = ("linv_fwd", "linv_bwd")


def _p02_banded_lp(pt, fs, mp):
    """The LP of the mpc_lp cells: 128 lanes under "banded" with the
    "reduced" rescue, every lane OPTIMAL and none rescued; the composed
    solve launches S2."""
    st, probs, batch, shared = fs.batch("lp")
    settings = pt.Settings(kkt_strategy="banded")
    _, composed, sol, rescued = run_path(
        mp, pt, st, probs, batch, shared, settings,
        pt.Settings(kkt_strategy="reduced"), BAND + ("spmv",))
    launched(composed, ["loop_cond"])
    optimal(sol, LANES)
    assert not rescued, rescued
    fs.keep("banded", sol)


def _p03_forced_rescue(pt, fs, mp):
    """16 lanes with the primary cut at 3 iterations: every lane rescued
    by "reduced" to OPTIMAL; the primary's factor is the cluster kernel's
    at 16 lanes."""
    st, probs, _, shared = fs.batch("lp")
    sub = pt.BatchedSolver.stack(probs[:RESCUE_LANES], shared=shared)
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded", iter_max=3),
                          shared=shared,
                          rescue=pt.Settings(kkt_strategy="reduced"))
    sol, counts, syncs, stats = _stats_solve(torch, bs, sub)
    eager_then_composed(mp, bs, sub, sol, counts, syncs, stats)
    assert bs.last_rescued == tuple(range(RESCUE_LANES))
    optimal(sol, RESCUE_LANES)
    launched(counts, (factor_name(RESCUE_LANES),) + BAND[1:] + INVERSE)
    bs.close()


def _p04_reduced_inverse(pt, fs, mp):
    """"reduced" on the inverse path on the 128 LP lanes: every lane
    OPTIMAL, the objectives those of "banded" within 1e-7, lane 0 as on
    the CPU."""
    st, probs, batch, shared = fs.batch("lp")
    red = pt.Settings(kkt_strategy="reduced", dense_solve="inverse")
    bs = pt.BatchedSolver(st, red, shared=shared)
    first, counts, syncs, stats = _stats_solve(torch, bs, batch)
    launched(counts, INVERSE)
    eager_then_composed(mp, bs, batch, first, counts, syncs, stats)
    sol = bs.solve(batch)
    assert same_bits(first, sol)
    optimal(sol, LANES)
    want = fs.ref("banded")
    assert (np.abs(sol.info.pcost.cpu().numpy() - want)
            / np.abs(want)).max() <= STRATEGY_TOL
    same_as_cpu(pt, st, probs[0], red, sol)
    fs.keep("reduced", sol)
    bs.close()


def _p05_socp_reduced(pt, fs, mp):
    """The SOCP under "reduced" (its SOC rows kept) on 8 lanes: lane 0 as
    on the CPU (lane 5 ends at CLOSE_TO_OPTIMAL there too)."""
    st, probs, batch, shared = fs.batch("socp8")
    red = pt.Settings(kkt_strategy="reduced", dense_solve="inverse")
    bs = pt.BatchedSolver(st, red, shared=shared)
    sol, counts, syncs, stats = _stats_solve(torch, bs, batch)
    launched(counts, INVERSE)
    eager_then_composed(mp, bs, batch, sol, counts, syncs, stats)
    assert same_bits(sol, bs.solve(batch))
    same_as_cpu(pt, st, probs[0], red, sol)
    fs.keep("soc-reduced", sol)
    bs.close()


def _p06_socp_keep_soc(pt, fs, mp):
    """The SOCP of the main path: 128 lanes under "banded" with the
    keep_soc plan (bwb 1, NT-scaled kept cones) and the rescue."""
    st, probs, batch, shared = fs.batch("socp-band")
    assert st.band.bwb == 1 and st.band.keep_soc
    _, _, sol, _ = run_path(mp, pt, st, probs, batch, shared,
                            pt.Settings(kkt_strategy="banded"),
                            pt.Settings(kkt_strategy="reduced"),
                            BAND + ("spmv",))
    fs.keep("soc-banded", sol)


def _p07_wide_bw3(pt, fs, mp):
    """The wide band at a real size: 64 lanes of bwb 3, Dp 4864, through
    the gathered band blocks, the wide kernels and dgemm's operands.  The
    direct scatter, which this LP takes since it reaches bwb 6, is
    switched off here; ``p07-wide-direct`` runs it."""
    from eicos_tpu_torch import kkt

    st, probs, batch, shared = fs.batch("wide")
    assert (st.band.bwb, st.band.dim) == (WIDE_BWB, WIDE_DP)
    mp.setattr(kkt, "_direct_band", lambda st, settings: False)
    run_path(mp, pt, st, probs, batch, shared,
             pt.Settings(kkt_strategy="banded"), None,
             BAND + ("spmv", "dgemm"))


def _p07_wide_direct(pt, fs, mp):
    """The wide band of ``p07-wide-bw3`` on its own path, the direct
    scatter at bwb 3: at an interior scaling its band blocks are the
    gathered path's within 1e-15 of their scale; then ``run_path`` with
    the lanes short of OPTIMAL held to the CPU's tiers and objectives
    (``tiers_as_cpu``), since this batch's endgame turns on the last bits.
    Lane 52 ends CLOSE_TO_OPTIMAL here (its pres jumps from 2e-13 to
    6e-10 on the last step), and with noise of an ulp on the factor's
    input it does so on the gathered path too."""
    from eicos_tpu_torch import cones, kkt
    from eicos_tpu_torch.equilibrate import equilibrate

    st, probs, batch, shared = fs.batch("wide")
    settings = pt.Settings(kkt_strategy="banded")
    assert kkt._direct_band(st, settings)
    p0 = probs[0]
    dev = [torch.tensor(np.asarray(v), device="cuda")[None]
           for v in (p0.c, p0.h, p0.b)]
    eq = equilibrate(st, torch.tensor(p0.G, device="cuda"),
                     torch.tensor(p0.A, device="cuda"), *dev)
    rng = np.random.default_rng(5)
    s, z = [torch.tensor(rng.random(st.m) * 3 + 0.01, device="cuda")[None]
            for _ in range(2)]
    scal, _ = cones.update_scalings(st.cone, s, z)
    delta = settings.deltastat
    winv = 1.0 / (scal.v_lp + delta)
    Kd, Ks = kkt.band_blocks(st, kkt.make_context(st, eq.G, eq.A, settings),
                             winv, delta, scal)
    with mp.context() as m:
        m.setattr(kkt, "_direct_band", lambda st, settings: False)
        ctx = kkt.make_context(st, eq.G, eq.A, settings)
    H = torch.zeros(1, st.n, st.n, dtype=torch.float64, device="cuda")
    kkt._assemble_h(st, ctx, ctx.dense, H, scal, winv, delta)
    gd, gs = kkt._gathered_blocks(ctx, H.view(1, -1))
    scale = gd.abs().max()
    assert (Kd - gd).abs().max() <= 1e-15 * scale
    for j in range(WIDE_BWB):
        assert (Ks[:, j + 1:, j] - gs[:, j + 1:, j]).abs().max() \
            <= 1e-15 * scale, j
    del H, ctx
    run_path(mp, pt, st, probs, batch, shared, settings, None,
             BAND + ("spmv", "dgemm"), short=tiers_of_short_lanes)


def _p08_reduced_subst(pt, fs, mp):
    """"reduced" at ``dense_solve="auto"``: the substitution kernels on
    the card and no inverse solve; every lane OPTIMAL, the objectives
    those of "banded", lane 0 as on the CPU under "subst"."""
    st, probs, batch, shared = fs.batch("lp")
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="reduced"),
                          shared=shared)
    first, counts, syncs, stats = _stats_solve(torch, bs, batch)
    launched(counts, SUBST)
    not_launched(counts, LINV)
    eager_then_composed(mp, bs, batch, first, counts, syncs, stats)
    sol = bs.solve(batch)
    assert same_bits(first, sol)
    optimal(sol, LANES)
    objectives_close(sol, fs.ref("banded"), {2: STRATEGY_TOL})
    same_as_cpu(pt, st, probs[0],
                pt.Settings(kkt_strategy="reduced", dense_solve="subst"), sol)
    bs.close()


def _p09_normal_socp(pt, fs, mp):
    """"normal" on 128 SOCP lanes (every cone eliminated, Dp 2048): lanes
    0-7 with the objectives of "reduced", the lanes short of OPTIMAL (at
    most 4) with an answer where the CPU has one."""
    st, probs, batch, shared = fs.batch("socp")
    normal = pt.Settings(kkt_strategy="normal")
    bs = pt.BatchedSolver(st, normal, shared=shared)
    first, counts, syncs, stats = _stats_solve(torch, bs, batch)
    launched(counts, SUBST)
    eager_then_composed(mp, bs, batch, first, counts, syncs, stats)
    sol = bs.solve(batch)
    assert same_bits(first, sol)
    objectives_close(sol, fs.ref("soc-reduced"),
                     {2: STRATEGY_TOL, 1: INACC_TOL})
    codes = sol.exit_code.cpu().numpy()
    short = [int(i) for i in np.flatnonzero(codes != 0)][:CPU_LANES]
    tiers_as_cpu(pt, st, probs, shared, normal, sol, short or [0])
    bs.close()


def _p10_full(pt, fs, mp):
    """"full", the default ``Settings()``: ``Solver(G, A, c, h, b)`` on
    lane 0 (Dp 7040) on the inverse path, OPTIMAL with "reduced"'s
    objective (a CPU solve at that size takes minutes); then 8 lanes on
    the inverse path and on the substitution sweeps, every lane OPTIMAL
    with the objectives of "banded"."""
    from eicos_tpu_torch.ops import kernels

    st, probs, _, shared = fs.batch("lp")
    assert -(-(st.n + st.p + st.m) // B) * B == FULL_DP
    p0 = probs[0]
    kernels.reset_counts()
    one = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b)
    code = one.solve()
    torch.cuda.synchronize()
    counts = dict(kernels.COUNTS)
    launched(counts, INVERSE)
    not_launched(counts, ("dense_fwd", "dense_pack"))
    red_code, _, red_pc = fs.ref("reduced")
    assert int(code) == 0 and red_code == 0
    assert abs(float(one.get_info().pcost) - red_pc) <= STRATEGY_TOL * abs(
        red_pc)
    one.close()
    batch = pt.BatchedSolver.stack(probs[:FULL_LANES], shared=shared)
    for cfg, must, never in (
            (pt.Settings(), LINV, ("dense_pack", "dense_fwd", "dense_bwd")),
            (pt.Settings(dense_solve="subst"),
             ("dense_pack", "dense_fwd", "dense_bwd"), LINV)):
        bs = pt.BatchedSolver(st, cfg, shared=shared)
        first, counts, syncs, stats = _stats_solve(torch, bs, batch)
        launched(counts, ("leaf_ldl", "dgemm") + must)
        not_launched(counts, never)
        eager_then_composed(mp, bs, batch, first, counts, syncs, stats)
        sol = bs.solve(batch)
        assert same_bits(first, sol)
        optimal(sol, FULL_LANES)
        objectives_close(sol, fs.ref("banded")[:FULL_LANES],
                         {2: STRATEGY_TOL})
        bs.close()
        torch.cuda.empty_cache()


def _p11_reduced_f32(pt, fs, mp):
    """"reduced" with ``factor_dtype="float32"``: the f32 leaf and no f64
    dense kernel; a lane that claims an answer has "banded"'s objective;
    lanes 0-3 answer where the CPU does (every lane ends at NUMERICS at
    iteration 0 on both: the f32 factor fails on this LP family)."""
    st, probs, batch, shared = fs.batch("lp")
    f32 = pt.Settings(kkt_strategy="reduced", factor_dtype="float32")
    bs = pt.BatchedSolver(st, f32, shared=shared)
    sol, counts, syncs, stats = _stats_solve(torch, bs, batch)
    launched(counts, ["leaf_ldl_f32"])
    not_launched(counts, ("leaf_ldl", "dgemm", "dense_fwd") + LINV)
    eager_then_composed(mp, bs, batch, sol, counts, syncs, stats)
    objectives_close(sol, fs.ref("banded"), {2: F32_TOL, 1: INACC_TOL})
    tiers_as_cpu(pt, st, probs, shared, f32, sol, list(range(CPU_LANES)))
    bs.close()


def leaf_at_scan_shape(lanes, dtype, tol):
    """The leaf kernel at the scan's shape, ``lanes`` Schur blocks a
    launch, within ``tol`` of its plain version."""
    from eicos_tpu_torch.ops import leaf

    M = device_quasidefinite(lanes, B, 80, 5, torch.device("cuda")).to(dtype)
    Lk, dk = leaf.leaf_ldl(M)
    Lp, dp = leaf.leaf_ldl_plain(M)
    assert max(rel(Lk, Lp), rel(dk, dp)) <= tol


def scan_launches(counts, name, nb):
    """The scan launches the leaf kernel ``name`` once a block row of
    every factor, and no band kernel."""
    assert counts[name] == nb * counts["factors"], (name, counts)
    not_launched(counts, ("band_factor_bw", "band_factor_cluster",
                          "band_fwd_bw", "band_bwd_bw"))


def scan_as_cpu(Kd, Ks, gdt):
    """The scan factor of (Kd, Ks) on the card against the CPU plain path:
    the largest relative error of L, Dinv and the solve of two random
    right-hand sides."""
    from eicos_tpu_torch.ops.band_ldl import band_ldl_factor, band_ldl_solve

    fk = band_ldl_factor(Kd, Ks, gemm_dtype=gdt)
    fc = band_ldl_factor(Kd.cpu(), Ks.cpu(), gemm_dtype=gdt)
    r = torch.randn(Kd.shape[0], 2, Kd.shape[1] * B,
                    generator=torch.Generator().manual_seed(3),
                    dtype=Kd.dtype)
    xk = band_ldl_solve(fk, r.to(Kd.device), gdt).cpu()
    return max(rel(fk.L.cpu(), fc.L), rel(fk.Dinv.cpu(), fc.Dinv),
               rel(xk, band_ldl_solve(fc, r, gdt)))


def _p12_scan_bw9(pt, fs, mp):
    """The scan at a real size: 32 lanes of bwb 9, Dp 7680, nb 60 under
    "banded": the leaf kernel once a block row of every factor and no
    band kernel, every lane OPTIMAL, lane 0 as on the CPU; the scan with
    f32 products held to the CPU at 1e-4 on a random band of the path's
    shape (this LP's own blocks carry the 1/delta growth of its equality
    pivots, which f32 products cannot), and the path under
    ``band_gemm="float32"`` answering where the CPU does."""
    from eicos_tpu_torch.ops.band_ldl import band_ldl_factor

    st, probs, batch, shared = fs.batch("scan")
    nb = st.band.dim // B
    assert (st.band.bwb, st.band.dim) == (SCAN_BWB, SCAN_DP)
    leaf_at_scan_shape(SCAN_LANES, torch.float64, KERNEL_TOL)
    counts, _, _, _ = run_path(mp, pt, st, probs, batch, shared,
                               pt.Settings(kkt_strategy="banded"), None,
                               ("leaf_ldl", "spmv", "dgemm"))
    scan_launches(counts, "leaf_ldl", nb)
    torch.cuda.empty_cache()
    Kd, Ks = device_wide_band(CPU_LANES, nb, SCAN_BWB, 17,
                              torch.device("cuda"))
    assert scan_as_cpu(Kd, Ks, torch.float32) <= F32_SCAN_TOL
    assert rel(band_ldl_factor(Kd, Ks, gemm_dtype=torch.float32).L,
               band_ldl_factor(Kd, Ks).L) > KERNEL_TOL
    del Kd, Ks
    g32 = pt.Settings(kkt_strategy="banded", band_gemm="float32")
    bs = pt.BatchedSolver(st, g32, shared=shared)
    sol, counts, syncs, stats = _stats_solve(torch, bs, batch)
    eager_then_composed(mp, bs, batch, sol, counts, syncs, stats)
    scan_launches(counts, "leaf_ldl", nb)
    short = [int(i) for i in np.flatnonzero(sol.exit_code.cpu().numpy())]
    tiers_as_cpu(pt, st, probs, shared, g32, sol, short[:1] or [0])
    bs.close()


def _p13_banded_f32(pt, fs, mp):
    """"banded" with an f32 factor on the 128 SOCP lanes of the keep_soc
    plan: the scan with the f32 leaf kernel and no f64 leaf or dgemm, the
    f32 scan of the path's own first two factors held to the CPU at 1e-4,
    a lane that claims an answer with the f64 path's objective, lanes 0-3
    answering where the CPU does."""
    from eicos_tpu_torch import kkt

    st, probs, batch, shared = fs.batch("socp-band")
    nb = st.band.dim // B
    leaf_at_scan_shape(LANES, torch.float32, F32_LEAF_TOL)
    f32 = pt.Settings(kkt_strategy="banded", factor_dtype="float32")
    bs = pt.BatchedSolver(st, f32, shared=shared)
    real = kkt.band_factor
    own = []

    def capture(Kd, Ks, gemm_dtype=None):
        # a capture computes nothing: the first factors that compute are
        # the prologue's warm-up (the init factor) and iteration 0's
        if len(own) < 2 and not torch.cuda.is_current_stream_capturing():
            own.append((Kd[:CPU_LANES].clone(), Ks[:CPU_LANES].clone()))
        return real(Kd, Ks, gemm_dtype)

    with mp.context() as m:
        m.setattr(kkt, "band_factor", capture)
        sol, counts, syncs, stats = _stats_solve(torch, bs, batch)
    launched(counts, ["leaf_ldl_f32"])
    eager_then_composed(mp, bs, batch, sol, counts, syncs, stats)
    not_launched(counts, ("leaf_ldl", "dgemm"))
    scan_launches(counts, "leaf_ldl_f32", nb)
    assert len(own) == 2
    for Kd, Ks in own:
        assert scan_as_cpu(Kd, Ks, None) <= F32_SCAN_TOL
    objectives_close(sol, fs.ref("soc-banded"), {2: F32_TOL, 1: INACC_TOL})
    tiers_as_cpu(pt, st, probs, shared, f32, sol, list(range(CPU_LANES)))
    bs.close()


def _p15_block64(pt, fs, mp):
    """``Settings(block=64)`` on 4 of the LP's lanes under "reduced"
    (dgemm and the inverse solves on the factor padded to 128) and
    "banded" (a plan of 64-blocks, the scan): the plain leaf by design, no
    leaf or band kernel, every lane OPTIMAL, lane 0 as on the CPU."""
    from eicos_tpu_torch.plan import make_band_plan

    st, probs, _, shared = fs.batch("lp")
    st64 = st.with_band_plan(make_band_plan(st, probs[0].G, probs[0].A,
                                            block=64))
    batch = pt.BatchedSolver.stack(probs[:BLOCK64_LANES], shared=shared)
    for cfg, pst, must in (
            (pt.Settings(kkt_strategy="reduced", block=64), st,
             ("spmv", "dgemm") + LINV),
            (pt.Settings(kkt_strategy="banded", block=64), st64, ("spmv",))):
        bs = pt.BatchedSolver(pst, cfg, shared=shared)
        sol, counts, syncs, stats = _stats_solve(torch, bs, batch)
        launched(counts, must)
        eager_then_composed(mp, bs, batch, sol, counts, syncs, stats)
        not_launched(counts, ("leaf_ldl", "band_factor_bw",
                              "band_factor_cluster"))
        optimal(sol, BLOCK64_LANES)
        same_as_cpu(pt, pst, probs[0], cfg, sol)
        bs.close()


def _p16_mesh(pt, fs, mp):
    """``BatchedSolver(mesh=make_mesh())`` on the LP's batch over the
    visible cards: the bits of the unsharded solve."""
    from eicos_tpu_torch.parallel import make_mesh

    st, _, batch, shared = fs.batch("lp")
    settings = pt.Settings(kkt_strategy="banded")
    rescue = pt.Settings(kkt_strategy="reduced")
    ms = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue,
                          mesh=make_mesh())
    sol, counts, syncs, stats = _stats_solve(torch, ms, batch)
    launched(counts, ("band_factor_bw", "spmv"))
    eager_then_composed(mp, ms, batch, sol, counts, syncs, stats)
    ref = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue)
    assert same_bits(ref.solve(batch), sol)
    ref.close()
    ms.close()


def repeat_batched(pt, st, batch, shared, settings, rescue):
    """One kept ``BatchedSolver``: X, then Y after ``update_data`` with
    every value new (``test_torch_program.rescaled``), then X five times;
    every solve after the first is one composed launch with no host sync
    and gives a fresh solver's bits and, settled, its counts; the first
    result is unchanged at the end."""
    from test_torch_program import rescaled

    from eicos_tpu_torch import graphs

    def make():
        return pt.BatchedSolver(st, settings, shared=shared, rescue=rescue)

    bs = make()
    first, f_counts, f_syncs, _ = _stats_solve(torch, bs, batch)
    kept = graphs.clone(first)
    y = rescaled(st, batch, seed=23)
    bs.update_data(**{f: getattr(y, f) for f in ("G", "A", "c", "h", "b")})
    ysol, y_counts, y_syncs, y_stats = _stats_solve(torch, bs, None)
    loops = composed_only(y_syncs, y_stats)
    fresh = make()
    want, w_counts, w_syncs, _ = _stats_solve(torch, fresh, y)
    fresh.close()
    same_solve(ysol, want, (y_counts, w_counts), (y_syncs, w_syncs), loops)
    del ysol, want
    for _ in range(5):
        sol, counts, syncs, stats = _stats_solve(torch, bs, batch)
        loops = composed_only(syncs, stats)
        same_solve(sol, first, (counts, f_counts), (syncs, f_syncs), loops)
    same_solve(first, kept)
    bs.close()


def _p17_repeat_lp(pt, fs, mp):
    st, _, batch, shared = fs.batch("lp")
    repeat_batched(pt, st, batch, shared, pt.Settings(kkt_strategy="banded"),
                   pt.Settings(kkt_strategy="reduced"))


def _p17_repeat_socp(pt, fs, mp):
    st, _, batch, shared = fs.batch("socp-band")
    repeat_batched(pt, st, batch, shared, pt.Settings(kkt_strategy="banded"),
                   pt.Settings(kkt_strategy="reduced"))


def _p17_repeat_rescue(pt, fs, mp):
    """The forced rescue of 5, then 7 failing lanes: both pad to 8, so the
    second replays the first's rescue program (no new capture) and
    launches its composed graph; 7 lanes OPTIMAL; again, one composed
    launch a program with a fresh solver's bits and counts."""
    st, probs, _, shared = fs.batch("lp")
    forced = pt.Settings(kkt_strategy="banded", iter_max=3)
    rescue = pt.Settings(kkt_strategy="reduced")
    bs = pt.BatchedSolver(st, forced, shared=shared, rescue=rescue)
    five = pt.BatchedSolver.stack(probs[:5], shared=shared)
    seven = pt.BatchedSolver.stack(probs[5:12], shared=shared)
    _stats_solve(torch, bs, five)
    rprog = bs._rescue_program
    caps = rprog.captures
    sol, _, _, stats = _stats_solve(torch, bs, seven)
    assert bs.last_rescued == tuple(range(7))
    assert bs._rescue_program is rprog and rprog.captures == caps
    optimal(sol, 7)
    # the primary's program is new at 7 lanes; the rescue's is composed
    assert stats["loops"] == 1, stats
    sol, counts, syncs, stats = _stats_solve(torch, bs, seven)
    loops = composed_only(syncs, stats)
    fresh = pt.BatchedSolver(st, forced, shared=shared, rescue=rescue)
    want, w_counts, w_syncs, _ = _stats_solve(torch, fresh, seven)
    same_solve(sol, want, (counts, w_counts), (syncs, w_syncs), loops)
    fresh.close()
    bs.close()


def _p17_repeat_full(pt, fs, mp):
    """``Solver`` at the default settings ("full") on lane 0, then
    ``update_data`` with every value new: one composed launch with a new
    ``Solver``'s bits and counts."""
    from test_torch_program import rescaled

    st, probs, _, _ = fs.batch("lp")
    p0 = probs[0]
    one = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b)
    _stats_solve(torch, one, False)
    y = rescaled(st, pt.ProblemData(G=p0.G, A=p0.A, c=p0.c[None], h=p0.h,
                                    b=p0.b[None]), seed=29)
    new = dict(G=y.G, A=y.A, c=y.c[0], h=y.h, b=y.b[0])
    one.update_data(**new)
    _, counts, syncs, stats = _stats_solve(torch, one, False)
    loops = composed_only(syncs, stats)
    other = pt.Solver(**new)
    _, w_counts, w_syncs, _ = _stats_solve(torch, other, False)
    same_solve(one.last_solution, other.last_solution, (counts, w_counts),
               (syncs, w_syncs), loops)
    one.close()
    other.close()


def _p17_repeat_scan(pt, fs, mp):
    """The scan's solver solved twice: the second is one composed launch
    with the first's bits and counts."""
    st, _, batch, shared = fs.batch("scan")
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          shared=shared)
    first, f_counts, f_syncs, _ = _stats_solve(torch, bs, batch)
    sol, counts, syncs, stats = _stats_solve(torch, bs, batch)
    loops = composed_only(syncs, stats)
    same_solve(sol, first, (counts, f_counts), (syncs, f_syncs), loops)
    bs.close()


def _p17_repeat_mesh(pt, fs, mp):
    """The mesh's solver solved twice: the second is one composed launch
    a card with the first's bits and counts."""
    from eicos_tpu_torch.parallel import make_mesh

    st, _, batch, shared = fs.batch("lp")
    ms = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          shared=shared,
                          rescue=pt.Settings(kkt_strategy="reduced"),
                          mesh=make_mesh())
    first, f_counts, f_syncs, _ = _stats_solve(torch, ms, batch)
    sol, counts, syncs, stats = _stats_solve(torch, ms, batch)
    loops = composed_only(syncs, stats)
    same_solve(sol, first, (counts, f_counts), (syncs, f_syncs), loops)
    ms.close()


PATHS = {
    "p02-banded-lp": _p02_banded_lp, "p03-forced-rescue": _p03_forced_rescue,
    "p04-reduced-inverse": _p04_reduced_inverse,
    "p05-socp-reduced": _p05_socp_reduced,
    "p06-socp-keep-soc": _p06_socp_keep_soc, "p07-wide-bw3": _p07_wide_bw3,
    "p07-wide-direct": _p07_wide_direct,
    "p08-reduced-subst": _p08_reduced_subst,
    "p09-normal-socp": _p09_normal_socp, "p10-full": _p10_full,
    "p11-reduced-f32": _p11_reduced_f32, "p12-scan-bw9": _p12_scan_bw9,
    "p13-banded-f32": _p13_banded_f32, "p15-block64": _p15_block64,
    "p16-mesh": _p16_mesh, "p17-repeat-lp": _p17_repeat_lp,
    "p17-repeat-socp": _p17_repeat_socp,
    "p17-repeat-rescue": _p17_repeat_rescue,
    "p17-repeat-full": _p17_repeat_full, "p17-repeat-scan": _p17_repeat_scan,
    "p17-repeat-mesh": _p17_repeat_mesh,
}


@pytest.mark.parametrize("path", list(PATHS))
def test_path_at_full_size(cuda, full_size, counted_factors, monkeypatch,
                           path):
    """Each path of the port at the size the benchmark runs it (its
    docstring says which): the kernels it must and must not launch, its
    exit codes and tiers, lane 0 against the CPU plain path, the bits of
    a repeat, of the same solve with its segments called eagerly and of
    its next solve, composed, with no host sync.  Each case releases its
    solvers' programs."""
    import eicos_tpu_torch as pt

    try:
        PATHS[path](pt, full_size, monkeypatch)
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ------------------------------------------- the entry points on the card

def table_rows(text):
    """The iteration rows of a printed table, without the IR column (it
    turns on the last bits)."""
    return [r[:-12] for r in text.splitlines() if r[:3].strip().isdigit()]


def small_socp():
    """A small feasible SOCP: a box, two equalities and one cone
    ||(x0, x1)|| <= 1.5 (G, A, c, h, b, q)."""
    rng = np.random.default_rng(5)
    n, p = 6, 2
    G = np.vstack([np.eye(n), -np.eye(n), np.zeros((3, n))])
    G[-2, 0] = G[-1, 1] = -1.0
    h = np.concatenate([np.ones(2 * n), [1.5, 0.0, 0.0]])
    A = rng.standard_normal((p, n))
    b = A @ (0.3 * rng.uniform(-1, 1, n))
    return G, A, rng.standard_normal(n), h, b, (3,)


@pytest.mark.parametrize("entry", ["live", "solve_ecos", "cli", "timed"])
def test_entry_point_on_card(cuda, full_size, tmp_path, entry):
    """The entry points on the card, on lane 0 of the LP of the mpc_lp
    cells under "banded".  "live": ``Solver.solve_live(seg=3)`` prints a
    row an iteration and gives ``solve()``'s bits, and
    ``Settings(verbose_live=True)`` on 4 lanes streams lane 0's rows.
    "solve_ecos": ``ecos_compat.solve_ecos`` agrees with ``Solver`` on a
    small SOCP.  "cli": ``python -m eicos_tpu_torch solve <npz> --live``
    and ``demo`` exit 0.  "timed": ``utils.timing.timed`` is no shorter
    than CUDA events around a solve, and waits for four queued f64
    products (at least 10 times their launches' host time)."""
    import contextlib
    import io
    import os
    import subprocess
    import sys
    import time

    import eicos_tpu_torch as pt
    from eicos_tpu_torch import ecos_compat
    from eicos_tpu_torch.utils import timing

    st, probs, _, shared = full_size.batch("lp")
    banded = pt.Settings(kkt_strategy="banded")
    p0 = probs[0]
    lanes = pt.BatchedSolver.stack(probs[:4], shared=shared)
    if entry == "live":
        one = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b, settings=banded)
        buf = io.StringIO()
        code = one.solve_live(seg=3, file=buf)
        live = one.last_solution
        rows = table_rows(buf.getvalue())
        assert one.solve() == code == 0
        for f in ("x", "y", "z", "s"):
            assert torch.equal(getattr(live, f),
                               getattr(one.last_solution, f)), f
        assert len(rows) == int(one.last_solution.info.iter) + 1
        one.close()
        out = io.StringIO()
        bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded",
                                              verbose_live=True),
                              shared=shared)
        with contextlib.redirect_stdout(out):
            bs.solve(lanes)
        bs.close()
        assert out.getvalue().startswith("It ")
        assert table_rows(out.getvalue()) == rows
    elif entry == "solve_ecos":
        import scipy.sparse as sp

        G, A, c, h, b, q = small_socp()
        r = ecos_compat.solve_ecos(c, sp.csc_matrix(G), h,
                                   {"l": G.shape[0] - 3, "q": list(q)},
                                   sp.csc_matrix(A), b)
        s = pt.Solver(G, A, c, h, b, soc_dims=q)
        assert r["exitFlag"] == int(s.solve())
        assert np.abs(r["x"] - s.solution()).max() <= LANE_TOL
        s.close()
    elif entry == "cli":
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        npz = str(tmp_path / "lane0.npz")
        pt.save_problem(npz, st, p0)
        for args in (["solve", npz, "--live"],
                     ["demo", "--horizon", "40", "--batch", "8"]):
            proc = subprocess.run([sys.executable, "-m", "eicos_tpu_torch",
                                   *args], cwd=root, capture_output=True,
                                  text=True, timeout=300)
            assert proc.returncode == 0, (args[0], proc.stderr[-2000:])
    else:
        bs = pt.BatchedSolver(st, banded, shared=shared)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def solve_between_events():
            e0.record()
            out = bs.solve(lanes)
            e1.record()
            return out

        bs.solve(lanes)
        _, ms = timing.timed(solve_between_events)
        assert ms >= e0.elapsed_time(e1)
        bs.close()
        a = torch.randn(8192, 8192, dtype=torch.float64, device=cuda)
        a /= 8192 ** 0.5

        def queued():
            e0.record()
            x = a
            for _ in range(4):
                x = x @ a
            e1.record()
            return x

        queued()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        queued()
        launch_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        _, ms = timing.timed(queued)
        assert ms >= e0.elapsed_time(e1) and ms >= 10 * launch_ms
