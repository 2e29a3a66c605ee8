"""Frozen copies of the measuring pieces that the benchmark holds fixed.

The program may change; these may not, or the yardstick would move with
what it measures.  Each piece carries the place it was copied from.  A
configuration's generator is frozen in ``families/<family>.py``, held equal
to ``eicos_tpu_torch.corpus`` by ``benchmark/tests/test_bench_frozen.py``
at a small horizon.
"""

from __future__ import annotations

import numpy as np

# H100 SXM peaks, NVIDIA's data sheet (copied from chip_smoke.py:139-140)
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 67e12
B = 128                      # the band kernels' block (chip_smoke.py:137)


def perturbed_lanes(rng, c, b, batches, lanes, nx, c_sigma, b_sigma):
    """bench.py's lanes of one plant (chip_smoke.py:1438-1449, drawn for
    ``batches`` batches at once): per-lane c += c_sigma N(0, 1) and the
    initial state (the first ``nx`` entries of b) += b_sigma N(0, 1).
    Returns C (batches, lanes, n) and Bv (batches, lanes, p)."""
    C = c + c_sigma * rng.standard_normal((batches, lanes, c.shape[0]))
    Bv = np.broadcast_to(b, (batches, lanes, b.shape[0])).copy()
    Bv[:, :, :nx] += b_sigma * rng.standard_normal((batches, lanes, nx))
    return C, Bv


def cuda_ms(torch, fn, reps=20):
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA
    events), after one warm-up run (copied from chip_smoke.py:168-184)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound(nbytes, ops):
    """The least time (ms) for ``nbytes`` of HBM traffic and ``ops`` f64
    operations, and which of the two bounds it (chip_smoke.py:218-222)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F64_FLOP_PER_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def band_factor_work(lanes, nb):
    """(bytes, operations) the block-tridiagonal LDL^T of ``nb`` 128-blocks
    a lane needs (chip_smoke.py:266-273): each input block
    read once and each output written once (Kd, Ks in; L, Dinv out; d);
    per block row after the first one product with the unit-lower Dinv
    and one symmetric Schur update (B^3 each), then the leaf (B^3 / 2)
    and the unit-lower inverse (B^3 / 3)."""
    blk = B * B * 8
    nbytes = lanes * nb * (4 * blk + B * 8)
    ops = lanes * ((nb - 1) * 2 * B ** 3 + nb * (B ** 3 // 2 + B ** 3 // 3))
    return nbytes, ops


def random_band(torch, lanes, nb, seed, device):
    """Random quasidefinite block-tridiagonal blocks (Kd, Ks), Ks[:, 0] =
    0: mixed-sign diagonal, every row diagonally dominant.  The recipe of
    chip_smoke.py:187-200 (60 % positive pivots, 0.3 / sqrt(B) entries),
    made on the device from a ``torch.Generator`` in a few calls."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    f64 = torch.float64
    Kd = 0.3 * torch.randn(lanes, nb, B, B, generator=g, dtype=f64,
                           device=device) / B ** 0.5
    Kd = Kd + Kd.transpose(-1, -2)
    Ks = 0.3 * torch.randn(lanes, nb, B, B, generator=g, dtype=f64,
                           device=device) / B ** 0.5
    Ks[:, 0] = 0.0
    rows = Kd.abs().sum(-1) + Ks.abs().sum(-1)
    rows[:, :-1] += Ks[:, 1:].abs().sum(-2)
    sign = torch.where(torch.rand(lanes, nb, B, generator=g, device=device)
                       < 0.6, 1.0, -1.0).to(f64)
    Kd.diagonal(dim1=-2, dim2=-1).copy_(sign * (1.0 + rows))
    return Kd, Ks
