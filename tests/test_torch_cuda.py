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
    """Kernel vs plain twin on the same card within 1e-10 relative (the
    two differ in summation order and in how the leaf inverse is formed,
    substitution against Newton-Schulz)."""
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
    assert kernels.COUNTS["band_factor"] == before["band_factor"] + 1
    assert kernels.COUNTS["band_fwd"] == before["band_fwd"] + 3


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
    path give the same exit codes and iteration counts, and every kernel
    was launched."""
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
    assert all(v > 0 for v in kernels.COUNTS.values())
    cpu = pt.BatchedSolver(st, settings, shared=("G", "A", "h"),
                           device="cpu").solve(batch)
    assert torch.equal(gpu.exit_code.cpu(), cpu.exit_code)
    assert torch.equal(gpu.info.iter.cpu(), cpu.info.iter)
    np.testing.assert_allclose(gpu.info.pcost.cpu().numpy(),
                               cpu.info.pcost.numpy(), rtol=1e-8)
