"""The port's CUDA kernels against their plain twins, on the card.  These
tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere; run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

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
    assert kernels.COUNTS["band_factor_bw"] == before["band_factor_bw"] + 1
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
               for n in ("band_factor_bw", "band_fwd_bw", "band_bwd_bw"))
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
    for name in ("band_factor_bw", "band_fwd_bw", "band_bwd_bw"):
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
    assert all(kernels.COUNTS[n] > 0
               for n in ("band_factor_bw", "band_fwd_bw", "band_bwd_bw"))
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
        before = kernels.COUNTS["band_factor_bw"]
        fk = band.band_factor_bw(Kd, Ks)
        fp = plain.band_factor_bw_plain(Kd, Ks)
        torch.cuda.synchronize()
        assert kernels.COUNTS["band_factor_bw"] == before + 1
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
                   ("band_factor_bw", "band_fwd_bw", "band_bwd_bw"))
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
                   ("band_factor_bw", "band_fwd_bw", "band_bwd_bw"))
    cpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)
