"""The port's CUDA kernels against their plain twins, on the card.  These
tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere; run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import torch_threads  # noqa: F401  (one torch thread a worker)

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
    """The 4-d (block bandwidth 1) layout on the card runs the wide kernels
    and matches the bandwidth-1 plain twins within 1e-10 relative (the two
    differ in summation order and in how the leaf inverse is formed, by
    blocks against Newton-Schulz)."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    Kd, Ks = (torch.tensor(a, device=cuda) for a in band_case(3, 4, 0))
    before = dict(kernels.COUNTS)
    fk = band.band_factor(Kd, Ks)
    fp = plain.band_factor_plain(Kd, Ks)
    for a, b in zip(fk, fp):
        assert rel(a, b) < 1e-10
    rng = np.random.default_rng(1)
    for k in (1, 2, 16):
        r = torch.tensor(rng.standard_normal((3, k, 4 * B)), device=cuda)
        assert rel(band.band_fwd(fk, r), plain.band_fwd_plain(fk, r)) < 1e-10
        assert rel(band.band_bwd(fk, r), plain.band_bwd_plain(fk, r)) < 1e-10
    torch.cuda.synchronize()
    name = factor_name(3)
    assert kernels.COUNTS[name] == before[name] + 1
    assert kernels.COUNTS["band_fwd_bw"] == before["band_fwd_bw"] + 3
    assert kernels.COUNTS["band_bwd_bw"] == before["band_bwd_bw"] + 3


def test_band_wrappers_check_inputs(cuda):
    from eicos_tpu_torch.ops import band

    Kd, Ks = (torch.tensor(a, device=cuda) for a in band_case(1, 2, 2))
    with pytest.raises(ValueError):
        band.band_factor(Kd.float(), Ks.float())
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
    written to strided views; and bit for bit the band factor's first leaf,
    which runs the same device code."""
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


@pytest.mark.parametrize("nb", [2, 5, 38])
@pytest.mark.parametrize("bw", [1, 2, 3, 4, 5, 6])
def test_wide_band_sweeps_match_plain(cuda, bw, nb):
    """band_fwd_bw and band_bwd_bw against their plain twins within 1e-12
    relative at 1, 3, 64 and 130 lanes (2 to 260 CTAs in clusters of 2),
    k = 1, 2, 16, with block counts below, at and far above the bandwidth;
    a repeated sweep gives the same bits."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    rng = np.random.default_rng(bw * 100 + nb)
    for lanes in (1, 3, 64, 130):
        fac = random_band_factor(lanes, nb, bw, cuda, seed=lanes + bw + nb)
        for k in (1, 2, 16):
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
            if lanes == 3:
                assert torch.equal(w, band.band_fwd_bw(fac, r))
                assert torch.equal(z, band.band_bwd_bw(fac, w))
        del fac
        torch.cuda.empty_cache()


def test_wide_band_kernel_at_bw1_matches_band_factor(cuda):
    """At block bandwidth 1 the 4-d layout of ``ops/band.py`` (the
    ``band_factor`` the scatter path calls) is a view onto the wide
    kernels: the same launches (``COUNTS``) and the same bits as the 5-d
    layout, and both within 1e-10 of the bandwidth-1 plain twins."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    Kd, Ks = (torch.tensor(a, device=cuda) for a in wide_band_case(3, 5, 1, 3))
    r = torch.tensor(np.random.default_rng(2).standard_normal((3, 2, 5 * B)),
                     device=cuda)
    before = dict(kernels.COUNTS)
    narrow = band.band_factor(Kd, Ks[:, :, 0].contiguous())
    x4 = band.band_solve(narrow, r)
    torch.cuda.synchronize()
    for name in (factor_name(3), "band_fwd_bw", "band_bwd_bw"):
        assert kernels.COUNTS[name] == before[name] + 1, name
    assert narrow.L.shape == (3, 5, B, B)
    wide = band.band_factor_bw(Kd, Ks)
    assert torch.equal(wide.L[:, :, 0], narrow.L)
    assert torch.equal(wide.Dinv, narrow.Dinv)
    assert torch.equal(wide.d, narrow.d)
    assert torch.equal(band.band_bwd_bw(wide, band.band_fwd_bw(wide, r)), x4)
    fp = plain.band_factor_plain(Kd, Ks[:, :, 0].contiguous())
    for a, b in zip(narrow, fp):
        assert rel(a, b) < 1e-10
    assert rel(x4, plain.band_solve_plain(fp, r)) < 1e-10


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
    2e-4 relative (f32 over 128 dependent steps), into strided views."""
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


@pytest.mark.parametrize("bw", [1, 2, 3, 4, 5, 6])
def test_band_factor_bw_lanes_match_plain(cuda, bw):
    """The DMMA band factor at 1, 3, 64 and 130 lanes against
    ``band_factor_bw_plain`` within 1e-12 relative, factor and solve (the
    wide sweeps on both factors); a repeated factor gives the same bits."""
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain

    nb = bw + 2
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


def device_band(lanes, nb, seed, device):
    """``band_case``'s recipe made on the card from a ``torch.Generator``
    (128 lanes at nb 23 would take seconds in numpy)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    Kd = 0.3 * torch.randn(lanes, nb, B, B, **f64) / B ** 0.5
    Kd = Kd + Kd.transpose(-1, -2)
    Ks = 0.3 * torch.randn(lanes, nb, B, B, **f64) / B ** 0.5
    Ks[:, 0] = 0.0
    rows = Kd.abs().sum(-1) + Ks.abs().sum(-1)
    rows[:, :-1] += Ks[:, 1:].abs().sum(-2)
    sign = torch.where(torch.rand(lanes, nb, B, generator=g, device=device)
                       < 0.6, 1.0, -1.0).to(torch.float64)
    Kd.diagonal(dim1=-2, dim2=-1).copy_(sign * (1.0 + rows))
    return Kd, Ks


@pytest.mark.parametrize("nb", [16, 23])
def test_cluster_factor_has_the_one_cta_bits(cuda, nb):
    """The bw-1 factor of 1, 3, 16 and 32 lanes, which takes a cluster of
    CTAs a lane on this card, gives the bits of the same lanes factored
    inside a 128-lane call, which takes one CTA a lane: L, Dinv and d equal
    (``torch.equal``); each call counts once, under the name the dispatch
    takes; Ks[:, 0] is never read."""
    from eicos_tpu_torch.ops import band, kernels

    Kd, Ks = device_band(128, nb, 100 + nb, cuda)
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


def fused_forms(a, nm, km0, split, rng):
    """The product sites' forms of the fused call on ``a`` (L, k, km), as
    ``chip_smoke.spmv_form`` writes them (the call's keywords and the
    sequence it replaces), on inputs drawn from ``rng``."""
    import chip_smoke

    def rnd(cols):
        return torch.tensor(rng.standard_normal(tuple(a.shape[:-1]) + (cols,)),
                            device=a.device)

    return {form: chip_smoke.spmv_form(torch, form, a, nm, km0, split, rnd)
            for form in chip_smoke.SPMV_FORMS if form != "product"}


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
    launch's two and two a run of each cone region (``graphs.Probes``;
    the structure has cones)."""
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
