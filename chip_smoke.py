"""Smoke test of eicos_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version on the card, and drives the
port's paths through its entry points:

  1. kernel checks at the paths' shapes (the band factor and sweeps at
     block bandwidth 1, through the 4-d layout, and at block bandwidths 2,
     3 and 6; the blocked dense leaf LDL^T in f64 and f32, dgemm in nine forms, among
     them the recursion's products with their structure flags, its
     machine code checked for DMMA, the two inverse-solve passes, the
     substitution pack and its two sweeps);
  2. the main path as bench.py configures it: the 128-lane MPC01-scale
     banded LP batch through ``BatchedSolver`` with a "reduced" rescue
     (128/128 OPTIMAL, no lane rescued), lane 0 again on the CPU;
  3. a forced rescue: 16 lanes with the primary cut at 3 iterations, all
     16 rescued by the "reduced" path to OPTIMAL;
  4. the "reduced" strategy at full width on the same 128 lanes (128/128
     OPTIMAL, lane 0 against the CPU plain path, every objective against
     phase 2's);
  5. bench.py's SOCP problem under "reduced" (kept SOC rows), 8 lanes,
     lane 0 against the CPU plain path;
  6. the SOCP lane of the main path as bench.py configures it: 128 lanes
     of the horizon-249 SOC-constrained MPC under "banded" with a keep_soc
     plan (NT-scaled kept cones) and the "reduced" rescue;
  7. the wide band at a real size: 64 lanes of a wide-stage MPC LP whose
     plan has block bandwidth 3 (Dp = 4864) under "banded", through the
     dense H assembly, the gathered band blocks and the wide kernels;
  8. "reduced" at ``dense_solve="auto"`` on the 128 LP lanes: on the card
     that is the substitution form (pack and sweeps, no inverse-solve
     launch), 128/128 OPTIMAL, objectives as phase 2's, lane 0 against the
     CPU under ``dense_solve="subst"``;
  9. "normal" on 128 lanes of the SOCP problem (every cone eliminated, Dp
     = 2048, substitution form);
 10. "full", the default ``Settings()``: ``Solver(G, A, c, h, b)`` on lane
     0 of the LP (Dp = 7040), then 8 lanes (cut from 128 for memory and
     time) on the inverse path and on the substitution sweeps;
 11. "reduced" with ``factor_dtype="float32"`` on the 128 LP lanes (the
     f32 leaf kernel, ``torch.matmul`` products);
 12. the banded scan at a real size: 32 lanes of a 256-state, 128-input
     MPC LP whose plan has block bandwidth 9 (Dp = 7680, nb = 60), above
     the band kernels' 6, under "banded": batched ``torch.matmul`` block
     products and the f64 leaf kernel launched once a block row (nb
     launches a factor, no band kernel), lane 0 against the CPU plain
     path, bit for bit on a repeat, then the same batch under
     ``band_gemm="float32"`` (tiers held to the CPU's; the scan with f32
     products held to the CPU plain path at 1e-4 on a random band of the
     path's shape, as this LP's own blocks are rounding noise in f32);
 13. "banded" with ``factor_dtype="float32"`` on phase 6's 128 SOCP lanes
     (keep_soc plan): the scan in f32 with the f32 leaf kernel and no f64
     band or leaf kernel, the f32 scan of the path's own first two factors
     held to the CPU plain path at 1e-4, tiers held to the CPU's,
     objectives to phase 6's;
 14. the entry points on the card: ``Solver.solve_live``,
     ``Settings(verbose_live=True)`` on a ``BatchedSolver``,
     ``ecos_compat.solve_ecos``, ``python -m eicos_tpu_torch solve --live``
     and ``demo`` in subprocesses, and ``utils.timing.timed`` against
     CUDA events around a solve and around queued f64 products.

Phases 6, 7 and 12 must launch their band (12: leaf) kernels, match the
CPU plain path on lane 0, repeat bit for bit, and end every lane OPTIMAL;
lanes that do not must end with the same code on the CPU plain path.

    python3 chip_smoke.py

Needs one CUDA device and nvcc.  Prints the card (``nvidia-smi`` name and
power limit), the build time, each kernel's error and timing, each phase's
outcome, a JSON line of per-kernel numbers, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HORIZON, NX, NU = 249, 2, 4       # bench.py's MPC01-family scale
LANES = 128
RESCUE_LANES = 16                 # phase 3
SOC_LANES = 8                     # phase 5
WIDE = dict(horizon=30, nx=64, nu=32, seed=3)   # phase 7: bwb 3, Dp 4864
WIDE_LANES, WIDE_BWB, WIDE_DP = 64, 3, 4864
WIDE_TOL = 1e-12                  # wide kernels vs plain twins, relative
B = 128
KP = 16
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOP_PER_S = 67e12            # H100 SXM f64 tensor-core peak (same)
KERNEL_TOL = 1e-10                # kernel vs plain twin, max relative error
RESID_TOL = 1e-9                  # ||K x - b||_inf / ||b||_inf
LANE_TOL = 1e-8                   # lane 0: GPU vs CPU objective, relative
STRATEGY_TOL = 1e-7               # reduced vs banded objective, relative
SUBST_TOL = 1e-12                 # substitution sweeps vs plain, relative
F32_LEAF_TOL = 2e-4               # f32 leaf vs plain and vs the f64 leaf
FULL_LANES = 8                    # phase 10 (cut from 128: Dp = 7040)
FULL_DP = 7040
CPU_LANES = 4                     # phases 9, 11, 13: lanes again on the CPU
INACC_TOL = 1e-4                  # objective of a reduced-accuracy exit
SCAN = dict(horizon=12, nx=256, nu=128, seed=3)   # phase 12: bwb 9, Dp 7680
SCAN_LANES, SCAN_BWB, SCAN_DP = 32, 9, 7680
SCAN_CPU_LANES = 1                # phase 12 under band_gemm f32, on the CPU
F32_TOL = 1e-6                    # an f32 factor's definitive objective
F32_SCAN_TOL = 1e-4               # f32 scan (or f32 products): card vs CPU


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps=20):
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA
    events), after one warm-up run."""
    import torch

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


def random_band(lanes, nb, seed):
    """Random quasidefinite block-tridiagonal blocks (Kd, Ks), Ks[:, 0] = 0:
    mixed-sign diagonal with every row diagonally dominant."""
    rng = np.random.default_rng(seed)
    Kd = 0.3 * rng.standard_normal((lanes, nb, B, B)) / np.sqrt(B)
    Kd = Kd + Kd.transpose(0, 1, 3, 2)
    Ks = 0.3 * rng.standard_normal((lanes, nb, B, B)) / np.sqrt(B)
    Ks[:, 0] = 0.0
    rows = np.abs(Kd).sum(-1) + np.abs(Ks).sum(-1)
    rows[:, :-1] += np.abs(Ks[:, 1:]).sum(-2)
    sign = np.where(rng.random((lanes, nb, B)) < 0.6, 1.0, -1.0)
    idx = np.arange(B)
    Kd[:, :, idx, idx] = sign * (1.0 + rows)
    return Kd, Ks


def band_matvec(Kd, Ks, x):
    """K x for the block-tridiagonal K of (Kd, Ks); x (L, k, Dp)."""
    lanes, k, Dp = x.shape
    nb = Dp // B
    xb = x.reshape(lanes, k, nb, B).permute(0, 2, 3, 1)    # (L, nb, B, k)
    y = Kd @ xb
    y[:, 1:] += Ks[:, 1:] @ xb[:, :-1]
    y[:, :-1] += Ks[:, 1:].transpose(-1, -2) @ xb[:, 1:]
    return y.permute(0, 3, 1, 2).reshape(lanes, k, Dp)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def bound(nbytes, ops):
    """The least time (ms) for ``nbytes`` of HBM traffic and ``ops`` f64
    operations, and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F64_FLOP_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def check_kernels(torch, band, plain):
    """The band kernels at block bandwidth 1 (the wide kernels, through the
    4-d layout of ``ops/band.py``) against the bandwidth-1 plain twins at
    the main path's shape, with times and bounds.  Returns the per-kernel
    records (launches filled in later from the main path)."""
    nb = (HORIZON * (NX + NU) + HORIZON * NX + B - 1) // B   # 16
    Kd_np, Ks_np = random_band(LANES, nb, seed=0)
    Kd = torch.tensor(Kd_np, device="cuda")
    Ks = torch.tensor(Ks_np, device="cuda")
    del Kd_np, Ks_np
    rhs16 = torch.tensor(np.random.default_rng(1).standard_normal(
        (LANES, KP, nb * B)), device="cuda")

    fk = band.band_factor(Kd, Ks)
    fp = plain.band_factor_plain(Kd, Ks)
    torch.cuda.synchronize()
    fac_err = max(rel_err(a, b) for a, b in zip(fk, fp))
    fac_abs = max(float((a - b).abs().max()) for a, b in zip(fk, fp))
    print(f"band_factor_bw at bw 1 vs plain: max rel err L/Dinv/d "
          f"{[rel_err(a, b) for a, b in zip(fk, fp)]}")
    if not fac_err <= KERNEL_TOL:
        fail(f"band_factor_bw at bw 1 disagrees with its plain twin: "
             f"{fac_err}")

    errs = {}
    for k in (KP, 2, 1):
        r = rhs16[:, :k].contiguous()
        wk = band.band_fwd(fk, r)
        wp = plain.band_fwd_plain(fk, r)
        zk = band.band_bwd(fk, wk)
        zp = plain.band_bwd_plain(fk, wk)
        xk = band.band_solve(fk, r)
        xp = plain.band_solve_plain(fp, r)
        resid = float((band_matvec(Kd, Ks, xk) - r).abs().max()
                      / r.abs().max())
        errs[k] = (rel_err(wk, wp), rel_err(zk, zp), rel_err(xk, xp), resid,
                   float((wk - wp).abs().max()), float((zk - zp).abs().max()))
        print(f"k={k}: band_fwd_bw at bw 1 rel err {errs[k][0]:.3e}, "
              f"band_bwd_bw {errs[k][1]:.3e}, band_solve vs plain "
              f"{errs[k][2]:.3e}, residual {resid:.3e}")
        if not max(errs[k][:3]) <= KERNEL_TOL:
            fail(f"band solve kernels disagree with the plain twins (k={k})")
        if not resid <= RESID_TOL:
            fail(f"band solve residual {resid} (k={k})")

    lanes = LANES
    blk = B * B * 8
    # bytes: each input read once, each output written once
    fac_bytes = lanes * nb * (4 * blk + B * 8)
    # ops: per block row after the first, one product with the unit-lower
    # Dinv and one symmetric Schur update of which the leaf reads the lower
    # triangle (B^3 flops each), then the leaf (~B^3/6 rank-1 updates of 3
    # flops) and the unit-lower inverse (~B^3/6 FMAs)
    fac_ops = lanes * ((nb - 1) * 2 * B ** 3 + nb * (B ** 3 // 2 + B ** 3 // 3))
    records = []
    b_ms, b_by = bound(fac_bytes, fac_ops)
    ms = cuda_ms(lambda: band.band_factor(Kd, Ks))
    pms = cuda_ms(lambda: plain.band_factor_plain(Kd, Ks), reps=5)
    print(f"band_factor_bw at bw 1 ({lanes} lanes, nb {nb}): {ms:.4f} ms "
          f"(plain {pms:.3f} ms), bound {b_ms:.4f} ms by {b_by} "
          f"({fac_bytes / 1e9:.3f} GB, {fac_ops / 1e9:.2f} GFLOP)")
    records.append(dict(
        name="band_factor_bw", route="cuda",
        source="eicos_tpu_torch/csrc/band_factor_bw.cu",
        replaces="eicos_tpu/ops/pallas_band_ds.py:1689",
        max_abs_err=fac_abs, ms=ms, plain_ms=pms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))

    # library yardstick for the sweeps: one dense batched triangular solve
    # of the same unit-lower factor (built once, not timed)
    Lfull = torch.zeros(lanes, nb * B, nb * B, dtype=torch.float64,
                        device="cuda")
    Lkk = torch.linalg.inv(fk.Dinv)
    for b in range(nb):
        Lfull[:, b * B:(b + 1) * B, b * B:(b + 1) * B] = Lkk[:, b]
        if b:
            Lfull[:, b * B:(b + 1) * B, (b - 1) * B:b * B] = fk.L[:, b]
    LfullT = Lfull.transpose(-1, -2).contiguous()
    del Lkk
    k = 2                       # the main path's band solves take k <= 2
    r = rhs16[:, :k].contiguous()
    rT = r.transpose(-1, -2).contiguous()
    w = band.band_fwd(fk, r)
    # bytes of the factor a sweep reads: L and the lower triangle of each
    # unit-lower Dinv
    tri = B * (B + 1) // 2 * 8
    fac_in = lanes * nb * (blk + tri)
    io = 2 * lanes * k * nb * B * 8
    sweep_ops = lanes * k * nb * (2 * B * B + B * (B + 1))
    for name, fn, pfn, lfn, nbytes in (
            ("band_fwd", lambda: band.band_fwd(fk, r),
             lambda: plain.band_fwd_plain(fk, r),
             lambda: torch.linalg.solve_triangular(
                 Lfull, rT, upper=False, unitriangular=True),
             fac_in + lanes * nb * B * 8 + io),
            ("band_bwd", lambda: band.band_bwd(fk, w),
             lambda: plain.band_bwd_plain(fk, w),
             lambda: torch.linalg.solve_triangular(
                 LfullT, rT, upper=True, unitriangular=True),
             fac_in + io)):
        b_ms, b_by = bound(nbytes, sweep_ops)
        ms = cuda_ms(fn)
        pms = cuda_ms(pfn)
        lms = cuda_ms(lfn)
        ms16 = cuda_ms(lambda: (band.band_fwd(fk, rhs16) if name == "band_fwd"
                                else band.band_bwd(fk, rhs16)))
        print(f"{name}_bw at bw 1: {ms:.4f} ms at k={k} ({ms16:.4f} ms at "
              f"k={KP}); plain {pms:.4f} ms; solve_triangular {lms:.4f} ms; "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.3f} GB)")
        ei = 4 if name == "band_fwd" else 5
        records.append(dict(
            name=f"{name}_bw", route="cuda",
            source="eicos_tpu_torch/csrc/band_solve_bw.cu",
            replaces=("eicos_tpu/ops/pallas_band_ds.py:1457"
                      if name == "band_fwd"
                      else "eicos_tpu/ops/pallas_band_ds.py:1497"),
            max_abs_err=max(errs[kk][ei] for kk in errs), ms=ms,
            plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms))
    del Lfull, LfullT
    torch.cuda.empty_cache()
    return records


def random_wide_band(torch, lanes, nb, bw, seed):
    """Random quasidefinite block-banded blocks made on the card: Kd
    (lanes, nb, B, B) and Ksubs (lanes, nb, bw, B, B) with Ksubs[:, k, j-1]
    = K[k, k-j] (zero for k < j), mixed-sign diagonal, every row
    diagonally dominant."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           device="cuda")

    Kd = 0.3 * rnd(lanes, nb, B, B) / B ** 0.5
    Kd = Kd + Kd.transpose(-1, -2)
    Ks = 0.3 * rnd(lanes, nb, bw, B, B) / B ** 0.5
    rows = Kd.abs().sum(-1)
    for j in range(1, bw + 1):
        Ks[:, :j, j - 1] = 0.0
        rows += Ks[:, :, j - 1].abs().sum(-1)
        rows[:, :-j] += Ks[:, j:, j - 1].abs().sum(-2)
    sign = torch.where(torch.rand(lanes, nb, B, generator=g, device="cuda")
                       < 0.6, 1.0, -1.0).to(torch.float64)
    Kd.diagonal(dim1=-2, dim2=-1).copy_(sign * (1.0 + rows))
    return Kd, Ks.contiguous()


def wide_matvec(Kd, Ks, x):
    """K x for the block-banded K of (Kd, Ksubs); x (L, k, Dp)."""
    lanes, k, Dp = x.shape
    nb, bw = Ks.shape[1], Ks.shape[2]
    xb = x.reshape(lanes, k, nb, B).permute(0, 2, 3, 1)    # (L, nb, B, k)
    y = Kd @ xb
    for j in range(1, min(bw, nb - 1) + 1):
        y[:, j:] += Ks[:, j:, j - 1] @ xb[:, :-j]
        y[:, :-j] += Ks[:, j:, j - 1].transpose(-1, -2) @ xb[:, j:]
    return y.permute(0, 3, 1, 2).reshape(lanes, k, Dp)


def check_wide_kernels(torch, band, plain, kernels):
    """band_factor_bw, band_fwd_bw and band_bwd_bw against their plain
    twins at block bandwidths 2, 3 and 6 (the 4-d layout at 1 onto the same
    kernels), the sweeps also at 1 and 3 lanes, with times, bounds and a
    library yardstick at phase 7's shape.
    Returns the per-kernel records at that shape (launches filled in from
    phase 7), which ride along the main path's records as "bw3"."""
    # bw = 1: the 4-d layout of ops/band.py is a view onto the wide kernels
    Kd, Ks = random_wide_band(torch, 8, 5, 1, seed=21)
    before = dict(kernels.COUNTS)
    narrow = band.band_factor(Kd, Ks[:, :, 0].contiguous())
    wide = band.band_factor_bw(Kd, Ks)
    r = torch.randn(8, 2, 5 * B, dtype=torch.float64, device="cuda")
    x4 = band.band_solve(narrow, r)
    x5 = band.band_solve(wide, r)
    torch.cuda.synchronize()
    counted = {n: kernels.COUNTS[n] - before[n] for n in
               ("band_factor_bw", "band_fwd_bw", "band_bwd_bw")}
    same = (torch.equal(narrow.L, wide.L[:, :, 0])
            and torch.equal(narrow.Dinv, wide.Dinv)
            and torch.equal(narrow.d, wide.d) and torch.equal(x4, x5))
    print(f"bw = 1 in the 4-d layout: the wide kernels' bits {same}, "
          f"launches {counted}")
    if not same or counted != {"band_factor_bw": 2, "band_fwd_bw": 2,
                               "band_bwd_bw": 2}:
        fail("the 4-d layout does not run the wide kernels")
    del narrow, wide, x4, x5

    errs = {"band_factor_bw": 0.0, "band_fwd_bw": 0.0, "band_bwd_bw": 0.0}
    # the sweeps at 1 and 3 lanes of phase 7's block count: 2 and 6 CTAs on
    # the card
    for lanes in (1, 3):
        nb = WIDE_DP // B
        Kd, Ks = random_wide_band(torch, lanes, nb, WIDE_BWB, seed=50 + lanes)
        fk = band.band_factor(Kd, Ks)
        r16 = torch.randn(lanes, KP, nb * B, dtype=torch.float64,
                          device="cuda")
        for k in (KP, 2, 1):
            r = r16[:, :k].contiguous()
            wk = band.band_fwd(fk, r)
            zk = band.band_bwd(fk, wk)
            wp = plain.band_fwd_bw_plain(fk, r)
            zp = plain.band_bwd_bw_plain(fk, wk)
            ef, eb = rel_err(wk, wp), rel_err(zk, zp)
            errs["band_fwd_bw"] = max(errs["band_fwd_bw"],
                                      float((wk - wp).abs().max()))
            errs["band_bwd_bw"] = max(errs["band_bwd_bw"],
                                      float((zk - zp).abs().max()))
            print(f"{lanes} lane(s), nb {nb}, bw {WIDE_BWB}, k={k}: "
                  f"band_fwd_bw rel err {ef:.3e}, band_bwd_bw {eb:.3e}")
            if not max(ef, eb) <= WIDE_TOL:
                fail(f"wide band sweeps disagree with the plain twins "
                     f"({lanes} lanes, k={k})")
    del Kd, Ks, fk, r16
    shapes = {2: (8, 7), 6: (8, 9), WIDE_BWB: (WIDE_LANES, WIDE_DP // B)}
    for bw, (lanes, nb) in shapes.items():
        Kd, Ks = random_wide_band(torch, lanes, nb, bw, seed=30 + bw)
        for j in range(1, bw + 1):
            Ks[:, :j, j - 1] = 1e300        # never read
        fk = band.band_factor(Kd, Ks)
        fp = plain.band_factor_bw_plain(Kd, Ks)
        torch.cuda.synchronize()
        for j in range(1, bw + 1):
            Ks[:, :j, j - 1] = 0.0
            if bool(fk.L[:, :j, j - 1].any()):
                fail(f"band_factor_bw: L left of block column 0 is not zero "
                     f"(bw={bw})")
        fe = [rel_err(a, b) for a, b in zip(fk, fp)]
        errs["band_factor_bw"] = max(
            errs["band_factor_bw"],
            *[float((a - b).abs().max()) for a, b in zip(fk, fp)])
        print(f"bw={bw} ({lanes} lanes, nb {nb}): band_factor_bw vs plain, "
              f"max rel err L/Dinv/d {fe}")
        if not max(fe) <= WIDE_TOL:
            fail(f"band_factor_bw disagrees with its plain twin (bw={bw})")
        g = torch.Generator(device="cuda")
        g.manual_seed(40 + bw)
        rhs16 = torch.randn(lanes, KP, nb * B, generator=g,
                            dtype=torch.float64, device="cuda")
        for k in (KP, 2, 1):
            r = rhs16[:, :k].contiguous()
            wk = band.band_fwd(fk, r)
            wp = plain.band_fwd_bw_plain(fk, r)
            zk = band.band_bwd(fk, wk)
            zp = plain.band_bwd_bw_plain(fk, wk)
            resid = rel_err(wide_matvec(Kd, Ks, zk), r)
            ef, eb = rel_err(wk, wp), rel_err(zk, zp)
            errs["band_fwd_bw"] = max(errs["band_fwd_bw"],
                                      float((wk - wp).abs().max()))
            errs["band_bwd_bw"] = max(errs["band_bwd_bw"],
                                      float((zk - zp).abs().max()))
            print(f"bw={bw} k={k}: band_fwd_bw rel err {ef:.3e}, band_bwd_bw "
                  f"{eb:.3e}, residual ||K x - b|| / ||b|| {resid:.3e}")
            if not max(ef, eb) <= WIDE_TOL:
                fail(f"wide band sweeps disagree with the plain twins "
                     f"(bw={bw}, k={k})")
            if not resid <= RESID_TOL:
                fail(f"wide band solve residual {resid} (bw={bw}, k={k})")
        del fp

    # times and bounds at phase 7's shape (the last of the loop above)
    bw, (lanes, nb) = WIDE_BWB, shapes[WIDE_BWB]
    blk = B * B * 8
    reach = sum(min(bw, k) for k in range(nb))     # blocks L[k, k-j] in use
    tri = B * (B + 1) // 2 * 8         # the lower triangle of a block, bytes
    # bytes: Kd, the Ksubs blocks in use read; those L blocks, Dinv, d written
    fac_bytes = lanes * ((2 * nb + 2 * reach) * blk + nb * B * 8)
    # ops a block row with mk = min(bw, k) blocks left of the diagonal:
    # mk (mk - 1) / 2 general corrections of S (2 B^3 each), mk products
    # S Dinv^T with a unit-lower Dinv (B^3), mk symmetric Schur updates of
    # which the leaf reads the lower triangle (B^3), and the leaf with its
    # unit-lower inverse (B^3 / 2 + B^3 / 3)
    fac_ops = lanes * sum(
        (min(bw, k) * (min(bw, k) - 1) + 2 * min(bw, k)) * B ** 3
        + B ** 3 // 2 + B ** 3 // 3 for k in range(nb))
    records = []
    b_ms, b_by = bound(fac_bytes, fac_ops)
    ms = cuda_ms(lambda: band.band_factor(Kd, Ks), reps=10)
    pms = cuda_ms(lambda: plain.band_factor_bw_plain(Kd, Ks), reps=3)
    print(f"band_factor_bw ({lanes} lanes, nb {nb}, bw {bw}): {ms:.4f} ms "
          f"(plain {pms:.3f} ms), {fac_ops / ms / 1e9:.2f} TFLOP/s of the "
          f"operations the function needs, bound "
          f"{b_ms:.4f} ms by {b_by} ({fac_bytes / 1e9:.3f} GB, "
          f"{fac_ops / 1e9:.2f} GFLOP)")
    records.append(dict(
        name="band_factor_bw", route="cuda",
        source="eicos_tpu_torch/csrc/band_factor_bw.cu",
        replaces="eicos_tpu/ops/pallas_band_ds.py:1922",
        max_abs_err=errs["band_factor_bw"], ms=ms, plain_ms=pms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # library yardstick for the sweeps: one dense batched triangular solve
    # of the same unit-lower factor (built once, not timed)
    Dp = nb * B
    Lfull = torch.zeros(lanes, Dp, Dp, dtype=torch.float64, device="cuda")
    Lkk = torch.linalg.inv(fk.Dinv)
    for b in range(nb):
        Lfull[:, b * B:(b + 1) * B, b * B:(b + 1) * B] = Lkk[:, b]
        for j in range(1, min(bw, b) + 1):
            Lfull[:, b * B:(b + 1) * B, (b - j) * B:(b - j + 1) * B] = \
                fk.L[:, b, j - 1]
    del Lkk
    k = 2                       # the path's band solves take k <= 2
    r = rhs16[:, :k].contiguous()
    rT = r.transpose(-1, -2).contiguous()
    w = band.band_fwd(fk, r)
    # bytes of the factor a sweep reads: the L blocks in use and the lower
    # triangle of each unit-lower Dinv
    fac_in = lanes * (reach * blk + nb * tri)
    io = 2 * lanes * k * Dp * 8
    sweep_ops = lanes * k * (2 * reach * B * B + nb * B * (B + 1))
    lib = {}
    lib["band_fwd_bw"] = cuda_ms(lambda: torch.linalg.solve_triangular(
        Lfull, rT, upper=False, unitriangular=True), reps=5)
    Lfull = Lfull.transpose(-1, -2).contiguous()
    lib["band_bwd_bw"] = cuda_ms(lambda: torch.linalg.solve_triangular(
        Lfull, rT, upper=True, unitriangular=True), reps=5)
    del Lfull
    torch.cuda.empty_cache()
    for name, fn, fn16, pfn, nbytes, line in (
            ("band_fwd_bw", lambda: band.band_fwd(fk, r),
             lambda: band.band_fwd(fk, rhs16),
             lambda: plain.band_fwd_bw_plain(fk, r),
             fac_in + lanes * nb * B * 8 + io, 2051),
            ("band_bwd_bw", lambda: band.band_bwd(fk, w),
             lambda: band.band_bwd(fk, rhs16),
             lambda: plain.band_bwd_bw_plain(fk, w), fac_in + io, 2085)):
        b_ms, b_by = bound(nbytes, sweep_ops)
        ms, ms16, pms = cuda_ms(fn), cuda_ms(fn16), cuda_ms(pfn, reps=5)
        print(f"{name}: {ms:.4f} ms at k={k} ({ms16:.4f} ms at k={KP}); "
              f"plain {pms:.4f} ms; solve_triangular {lib[name]:.4f} ms; "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.3f} GB)")
        records.append(dict(
            name=name, route="cuda",
            source="eicos_tpu_torch/csrc/band_solve_bw.cu",
            replaces=f"eicos_tpu/ops/pallas_band_ds.py:{line}",
            max_abs_err=errs[name], ms=ms, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib[name]))
    del Kd, Ks, fk, rhs16
    torch.cuda.empty_cache()
    return records


def quasidefinite(torch, lanes, D, pos, seed):
    """Random symmetric quasidefinite (lanes, D, D) f64 blocks, made on the
    card: positive diagonal on the first ``pos`` rows, negative after,
    every row diagonally dominant."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    M = torch.randn(lanes, D, D, generator=g, dtype=torch.float64,
                    device="cuda") / D ** 0.5
    M = 0.5 * (M + M.transpose(-1, -2))
    sign = torch.where(torch.arange(D, device="cuda") < pos, 1.0, -1.0)
    M.diagonal(dim1=-2, dim2=-1).copy_(
        sign.to(M.dtype) * (1.0 + M.abs().sum(-1)))
    return M


def gemm_work(lanes, r, k, n, shared_b, c_read, kw):
    """(operations, bytes) a dgemm call needs: a triangular operand and a
    lower-only result count their nonzero triangle only."""
    ops = 2 * r * k * n
    a_el, b_el, c_el = r * k, k * n, r * n
    if kw.get("a_tri"):
        ops, a_el = n * r * (r + 1), r * (r + 1) // 2
    elif kw.get("b_tri"):
        ops, b_el = r * k * (k + 1), k * (k + 1) // 2
    elif kw.get("c_lower"):
        ops, c_el = k * r * (r + 1), r * (r + 1) // 2
    read_c = c_read and kw.get("beta", 0.0) != 0.0
    nbytes = 8 * (lanes * (a_el + (1 + read_c) * c_el)
                  + (1 if shared_b else lanes) * b_el)
    return lanes * ops, nbytes


def node_ops(D, assemble):
    """f64 operations of the dense recursion's node products at size D,
    each counted as ``gemm_work`` counts it: (a) L21 with the upper
    triangular L11inv^T, (b) the lower-only Schur update, and where the
    node assembles its inverse (``assemble``) (c) L21 L11inv and (d) with
    the lower triangular L22inv.  The substitution form assembles at a
    left child and below an assembling node only."""
    if D <= B:
        return 0
    h = (D // B // 2) * B
    h2 = D - h
    ops = h2 * h * (h + 1) + h * h2 * (h2 + 1)
    if assemble:
        ops += h2 * h * (h + 1) + h * h2 * (h2 + 1)
    return ops + node_ops(h, True) + node_ops(h2, assemble)


def dgemm_sass(kernels):
    """The DMMA instructions in dgemm's machine code (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", kernels.lib_path("dgemm")],
                          capture_output=True, text=True, check=True).stdout
    ops = [line.split("*/")[1].split(";")[0].strip()
           for line in sass.splitlines() if "DMMA" in line and "*/" in line]
    print(f"dgemm SASS: {len(ops)} DMMA instructions (f64 tensor cores), "
          f"e.g. {ops[0] if ops else None!r}")
    if not ops:
        fail("dgemm's machine code holds no DMMA instruction")


def check_dense_kernels(torch, band, leaf, gemm, ldl):
    """The dense path's kernels against their plain versions at the shapes
    of the 128-lane reduced solve (Dp = 2048), with times and bounds.
    Returns the per-kernel records (launches filled in later)."""
    records = []
    L, Dp = LANES, 2048

    # ---- leaf_ldl: 128 lanes of mixed-sign quasidefinite 128-blocks
    M = quasidefinite(torch, L, B, 80, seed=2)
    Lk, dk = leaf.leaf_ldl(M)
    Lp, dp = leaf.leaf_ldl_plain(M)
    torch.cuda.synchronize()
    errs = (rel_err(Lk, Lp), rel_err(dk, dp))
    resid = rel_err(Lk @ M @ Lk.transpose(-1, -2), torch.diag_embed(dk))
    # the band factor's first block row runs the same leaf device code
    fb = band.band_factor(M[:, None].contiguous(),
                          torch.zeros_like(M)[:, None])
    same = torch.equal(fb.Dinv[:, 0], Lk) and torch.equal(fb.d[:, 0], dk)
    print(f"leaf_ldl vs plain: max rel err Linv/d {errs[0]:.3e}/"
          f"{errs[1]:.3e}; ||Linv M Linv' - diag(d)|| rel {resid:.3e}; "
          f"bit-identical to band_factor's leaf: {same}")
    if not max(errs) <= KERNEL_TOL or not resid <= RESID_TOL or not same:
        fail("leaf_ldl disagrees with its plain version or the band leaf")
    # bytes: the lower triangle of each block read, Linv and d written
    b_ms, b_by = bound(L * (B * (B + 1) // 2 * 8 + B * B * 8 + B * 8),
                       L * (B ** 3 // 2 + B ** 3 // 3))
    ms = cuda_ms(lambda: leaf.leaf_ldl(M))
    pms = cuda_ms(lambda: leaf.leaf_ldl_plain(M), reps=5)
    print(f"leaf_ldl: {ms:.4f} ms (plain {pms:.3f} ms), bound {b_ms:.4f} ms "
          f"by {b_by}")
    records.append(dict(
        name="leaf_ldl", route="cuda", source="eicos_tpu_torch/csrc/leaf_ldl.cu",
        replaces="eicos_tpu/ops/pallas_leaf_ds.py:207",
        max_abs_err=max(float((Lk - Lp).abs().max()),
                        float((dk - dp).abs().max())),
        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del M, Lk, dk, Lp, dp, fb

    # ---- dgemm: the general forms and the recursion's flagged products
    g = torch.Generator(device="cuda")
    g.manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           device="cuda")

    h = Dp // 2
    a, bm, c0 = rnd(L, h, h), rnd(L, h, h), rnd(L, h, h)
    big = rnd(L, Dp, Dp)               # a node's K: the views below
    tri = torch.tril(rnd(L, h, h))     # L11inv, L22inv: zeros above
    sch = dict(alpha=-1.0, beta=1.0, c_lower=True)
    # label: (a, b, c, kwargs, (r, k, n) of one lane, shared b)
    forms = {
        "per-lane 128 x (1024x1024 @ 1024x1024)":
            (a, bm, None, {}, (h, h, h), False),
        "shared operand, 128 x 16 rows @ one 2048x2048 (folded into M)":
            (rnd(L, KP, Dp), rnd(Dp, Dp), None, {}, (KP, Dp, Dp), True),
        "transposed operand, c - a @ b' (unflagged)":
            (a, bm.transpose(-1, -2), c0, dict(alpha=-1.0, beta=1.0),
             (h, h, h), False),
        "ragged 128 x (37x150 @ 150x77)":
            (rnd(L, 37, 150), rnd(L, 150, 77), None, {}, (37, 150, 77),
             False),
        "(a) L21 = K[:, h:, :h] @ L11inv' (b upper)":
            (big[:, h:, :h], tri.transpose(-1, -2), None,
             dict(b_tri="upper"), (h, h, h), False),
        "(b) Schur c - (L21 d1) @ L21' (c lower)":
            (a, bm.transpose(-1, -2), c0, sch, (h, h, h), False),
        "(b) Schur into K[:, h:, h:] (c lower)":
            (a, bm.transpose(-1, -2), big[:, h:, h:], sch, (h, h, h),
             False),
        "(c) X = L21 @ L11inv (b lower)":
            (a, tri, None, dict(b_tri="lower"), (h, h, h), False),
        "(d) -L22inv @ X into a block of Linv (a lower)":
            (tri, a, big[:, :h, h:], dict(alpha=-1.0, a_tri="lower"),
             (h, h, h), False),
    }
    gemm_abs = 0.0
    for label, (x, y, c, kw, (r, k, n), shared_b) in forms.items():
        c_in = None if c is None else c.clone()
        got = gemm.matmul(x, y, c=c, **kw).clone()
        if c is not None:
            c.copy_(c_in)
        want = gemm.matmul_plain(x, y, c, **kw).clone()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        gemm_abs = max(gemm_abs, float((got - want).abs().max()))
        if c is not None and kw.get("c_lower"):
            up = torch.ones(r, n, dtype=torch.bool, device="cuda").triu(1)
            if not torch.equal(got[:, up], c_in[:, up]):
                fail(f"dgemm wrote above the diagonal ({label})")
        del want, got, c_in
        ms = cuda_ms(lambda: gemm.matmul(x, y, c=c, **kw), reps=5)
        pms = cuda_ms(lambda: gemm.matmul_plain(x, y, c, **kw), reps=5)
        lms = cuda_ms(lambda: torch.matmul(x, y), reps=5)
        ops, nbytes = gemm_work(L, r, k, n, shared_b, c is not None, kw)
        f_ms, f_by = bound(nbytes, ops)
        print(f"dgemm {label}: rel err {err:.3e}, {ms:.4f} ms "
              f"({ops / ms / 1e9:.2f} TFLOP/s of the operations it needs; "
              f"plain {pms:.4f} ms, torch.matmul {lms:.4f} ms), bound "
              f"{f_ms:.4f} ms by {f_by}")
        if not err <= KERNEL_TOL:
            fail(f"dgemm disagrees with its plain version ({label})")
    del big, tri, forms
    b_ms, b_by = bound(L * 3 * h * h * 8, L * 2 * h ** 3)
    ms = cuda_ms(lambda: gemm.matmul(a, bm), reps=10)
    pms = cuda_ms(lambda: gemm.matmul_plain(a, bm), reps=10)
    lms = cuda_ms(lambda: torch.matmul(a, bm), reps=10)
    print(f"dgemm per-lane 1024^3: {ms:.4f} ms ({L * 2 * h ** 3 / ms / 1e9:.2f}"
          f" TFLOP/s), plain {pms:.4f} ms, torch.matmul {lms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}")
    records.append(dict(
        name="dgemm", route="cuda", source="eicos_tpu_torch/csrc/dgemm.cu",
        replaces="eicos_tpu/ops/pallas_gemm_ds.py:316", max_abs_err=gemm_abs,
        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms))
    del a, bm, c0
    torch.cuda.empty_cache()

    # ---- linv_fwd / linv_bwd on a factor of the dense recursion
    K = quasidefinite(torch, L, Dp, 1500, seed=3)
    fac = ldl.ldl_factor(K.clone())
    torch.cuda.synchronize()
    fac_ms = cuda_ms(lambda: ldl.ldl_factor(K.clone()), reps=3)
    fac_ops = L * node_ops(Dp, True)
    print(f"ldl_factor, 128 x Dp 2048 (one clone of K included): "
          f"{fac_ms:.2f} ms, {fac_ops / fac_ms / 1e9:.2f} TFLOP/s of the node "
          f"products it needs ({fac_ops / 1e9:.1f} GFLOP: triangular and "
          f"lower-only products at half); strict upper triangle of Linv all "
          f"zero: {not bool(torch.triu(fac.Linv, 1).any())}")
    Linv, d = fac.Linv, fac.d
    g.manual_seed(5)
    tri = Dp * (Dp + 1) // 2 * 8         # the lower triangle, in bytes
    linv_abs = {"linv_fwd": 0.0, "linv_bwd": 0.0}
    timing = {}
    for k in (KP, 2):
        r = rnd(L, k, Dp)
        tk = gemm.linv_fwd(Linv, d, r)
        tp = gemm.linv_fwd_plain(Linv, d, r)
        xk = gemm.linv_bwd(Linv, tk)
        xp = gemm.linv_bwd_plain(Linv, tk)
        torch.cuda.synchronize()
        resid = rel_err(torch.matmul(xk, K), r)
        ef, eb = rel_err(tk, tp), rel_err(xk, xp)
        linv_abs["linv_fwd"] = max(linv_abs["linv_fwd"],
                                   float((tk - tp).abs().max()))
        linv_abs["linv_bwd"] = max(linv_abs["linv_bwd"],
                                   float((xk - xp).abs().max()))
        print(f"k={k}: linv_fwd rel err {ef:.3e}, linv_bwd {eb:.3e}, "
              f"residual ||K x - b|| / ||b|| {resid:.3e}")
        if not max(ef, eb) <= KERNEL_TOL:
            fail(f"linv kernels disagree with their plain versions (k={k})")
        if not resid <= RESID_TOL:
            fail(f"dense solve residual {resid} (k={k})")
        LinvT = Linv.transpose(-1, -2)
        io = 2 * L * k * Dp * 8
        for name, fn, pfn, lfn, nbytes in (
                ("linv_fwd", lambda: gemm.linv_fwd(Linv, d, r),
                 lambda: gemm.linv_fwd_plain(Linv, d, r),
                 lambda: torch.matmul(r, LinvT), L * (tri + Dp * 8) + io),
                ("linv_bwd", lambda: gemm.linv_bwd(Linv, tk),
                 lambda: gemm.linv_bwd_plain(Linv, tk),
                 lambda: torch.matmul(tk, Linv), L * tri + io)):
            b_ms, b_by = bound(nbytes, L * k * Dp * (Dp + 1))
            timing[name, k] = (cuda_ms(fn), cuda_ms(pfn, reps=5),
                               cuda_ms(lfn, reps=5), b_ms, b_by)
            print(f"{name} k={k}: {timing[name, k][0]:.4f} ms, plain "
                  f"{timing[name, k][1]:.4f} ms, torch.matmul "
                  f"{timing[name, k][2]:.4f} ms, bound {b_ms:.4f} ms by "
                  f"{b_by} ({nbytes / 1e9:.3f} GB)")
    for name in ("linv_fwd", "linv_bwd"):
        ms, pms, lms, b_ms, b_by = timing[name, 2]   # the path's k
        records.append(dict(
            name=name, route="cuda", source="eicos_tpu_torch/csrc/linv_solve.cu",
            replaces="eicos_tpu/ops/pallas_gemm_ds.py:519",
            max_abs_err=linv_abs[name], ms=ms, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lms))
    del K, fac, Linv, d
    torch.cuda.empty_cache()
    return records


def check_subst_kernels(torch, leaf, ldl, dense, kernels):
    """The substitution path's kernels (dense_pack, dense_fwd, dense_bwd)
    and the f32 leaf against their plain versions, with times, bounds and
    library yardsticks; the two dense factors and the two solve pairs side
    by side.  Returns the per-kernel records (launches filled in later)."""
    records = []
    L, Dp = LANES, 2048
    nb = Dp // B
    nblk = nb * (nb - 1) // 2
    blk = B * B * 8
    tri = B * (B + 1) // 2 * 8
    g = torch.Generator(device="cuda")
    g.manual_seed(15)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           device="cuda")

    K = quasidefinite(torch, L, Dp, 1500, seed=3)
    kernels.reset_counts()
    inv = ldl.ldl_factor(K.clone())
    n_inv = kernels.COUNTS["dgemm"]
    kernels.reset_counts()
    K2 = K.clone()
    fs = ldl.ldl_factor_subst(K2)       # K2 now holds L below its diagonal
    n_sub = kernels.COUNTS["dgemm"]
    torch.cuda.synchronize()
    fac = fs.pre
    same_pack = torch.equal(fac.Lp, dense.pack_dense_plain(K2))
    same_d = torch.equal(fs.d, inv.d)
    same_x = all(torch.equal(fac.Xinv[:, i],
                             inv.Linv[:, i * B:(i + 1) * B, i * B:(i + 1) * B])
                 for i in range(nb))
    print(f"dense_pack equal to its plain version bit for bit: {same_pack}; "
          f"ldl_factor_subst's d and leaf inverses bit-equal to "
          f"ldl_factor's: {same_d}, {same_x}; dgemm launches a factor: "
          f"{n_inv} (inverse) / {n_sub} (substitution)")
    if not (same_pack and same_d and same_x):
        fail("dense_pack or the substitution factor disagrees")
    if (n_inv, n_sub) != (60, 52):
        fail(f"dgemm launches a factor {n_inv} / {n_sub}, expected 60 / 52")

    errs = {"dense_fwd": 0.0, "dense_bwd": 0.0}

    def check_sweeps(fac, Kmat, inv_fac, lanes, dp, k, label):
        r = rnd(lanes, k, dp)
        wk = dense.dense_fwd(fac, r)
        wp = dense.dense_fwd_plain(fac, r)
        zk = dense.dense_bwd(fac, wk)
        zp = dense.dense_bwd_plain(fac, wk)
        torch.cuda.synchronize()
        resid = rel_err(torch.matmul(zk, Kmat), r)
        ef, eb = rel_err(wk, wp), rel_err(zk, zp)
        errs["dense_fwd"] = max(errs["dense_fwd"],
                                float((wk - wp).abs().max()))
        errs["dense_bwd"] = max(errs["dense_bwd"],
                                float((zk - zp).abs().max()))
        line = (f"{label} k={k}: dense_fwd rel err {ef:.3e}, dense_bwd "
                f"{eb:.3e}, residual ||K x - b|| / ||b|| {resid:.3e}")
        if inv_fac is not None:
            line += (f", vs the inverse solve "
                     f"{rel_err(zk, ldl.ldl_solve(inv_fac, r)):.3e}")
        print(line)
        if not max(ef, eb) <= SUBST_TOL:
            fail(f"substitution sweeps disagree with their plain versions "
                 f"({label}, k={k})")
        if not resid <= RESID_TOL:
            fail(f"substitution solve residual {resid} ({label}, k={k})")
        return r, wk

    for k in (KP, 2):
        r, wk = check_sweeps(fac, K, inv, L, Dp, k, f"{L} x Dp {Dp}")

    # ---- times at the path's shape (k = 2), bounds, library yardsticks
    def sweep_bound(lanes, nb_, k):
        nblk_ = nb_ * (nb_ - 1) // 2
        io = 2 * lanes * k * nb_ * B * 8
        nbytes = lanes * (nblk_ * blk + nb_ * tri)
        ops = lanes * k * (2 * nblk_ * B * B + nb_ * B * (B + 1))
        return nbytes, io, ops

    nbytes, io, ops = sweep_bound(L, nb, 2)
    # library yardstick: one dense triangular solve with the unit-lower L
    Lfull = torch.tril(K2, -1)
    Lkk = torch.linalg.inv(fac.Xinv)
    for i in range(nb):
        Lfull[:, i * B:(i + 1) * B, i * B:(i + 1) * B] = Lkk[:, i]
    del Lkk
    rT = r.transpose(-1, -2).contiguous()
    lib_f = cuda_ms(lambda: torch.linalg.solve_triangular(
        Lfull, rT, upper=False, unitriangular=True), reps=5)
    Lfull = Lfull.transpose(-1, -2).contiguous()
    lib_b = cuda_ms(lambda: torch.linalg.solve_triangular(
        Lfull, rT, upper=True, unitriangular=True), reps=5)
    del Lfull
    torch.cuda.empty_cache()
    r16 = rnd(L, KP, Dp)
    for name, fn, fn16, pfn, lms, extra, line in (
            ("dense_fwd", lambda: dense.dense_fwd(fac, r),
             lambda: dense.dense_fwd(fac, r16),
             lambda: dense.dense_fwd_plain(fac, r), lib_f, L * Dp * 8, 301),
            ("dense_bwd", lambda: dense.dense_bwd(fac, wk),
             lambda: dense.dense_bwd(fac, r16),
             lambda: dense.dense_bwd_plain(fac, wk), lib_b, 0, 365)):
        b_ms, b_by = bound(nbytes + extra + io, ops)
        ms, ms16, pms = cuda_ms(fn), cuda_ms(fn16), cuda_ms(pfn, reps=5)
        print(f"{name}: {ms:.4f} ms at k=2 ({ms16:.4f} ms at k={KP}); plain "
              f"{pms:.4f} ms; solve_triangular {lms:.4f} ms; bound "
              f"{b_ms:.4f} ms by {b_by} ({(nbytes + extra + io) / 1e9:.3f} "
              f"GB)")
        records.append(dict(
            name=name, route="cuda",
            source="eicos_tpu_torch/csrc/dense_solve.cu",
            replaces=f"eicos_tpu/ops/pallas_dense_ds.py:{line}",
            max_abs_err=errs[name], ms=ms, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lms))
    # the two solve pairs in turns (inverse, substitution, substitution,
    # inverse)
    pairs = []
    for which in ("inv", "sub", "sub", "inv"):
        pairs.append(cuda_ms(
            (lambda: ldl.ldl_solve(inv, r)) if which == "inv"
            else (lambda: ldl.ldl_solve(fs, r))))
    print(f"one solve, k=2, ms: inverse pair {pairs[0]:.4f} / {pairs[3]:.4f}"
          f", substitution pair {pairs[1]:.4f} / {pairs[2]:.4f}")

    # ---- dense_pack: time, bound, library (one advanced-indexing call)
    rows, cols = torch.tril_indices(nb, nb, -1, device="cuda")
    view = K2.view(L, nb, B, nb, B).permute(0, 1, 3, 2, 4)
    b_ms, b_by = bound(2 * L * nblk * blk, 0)
    ms = cuda_ms(lambda: dense.pack_dense(K2, fac.Xinv, fac.d))
    pms = cuda_ms(lambda: dense.pack_dense_plain(K2), reps=5)
    lms = cuda_ms(lambda: view[:, rows, cols], reps=5)
    print(f"dense_pack: {ms:.4f} ms (plain {pms:.4f} ms, one indexing call "
          f"{lms:.4f} ms), bound {b_ms:.4f} ms by {b_by} "
          f"({2 * L * nblk * blk / 1e9:.3f} GB)")
    records.insert(0, dict(
        name="dense_pack", route="cuda",
        source="eicos_tpu_torch/csrc/dense_pack.cu",
        replaces="eicos_tpu/ops/pallas_dense_ds.py:139", max_abs_err=0.0,
        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms))
    del view, K2, inv, fs, fac
    torch.cuda.empty_cache()

    # ---- the two factors in turns (one clone of K in each)
    t_fac = []
    for which in ("inv", "sub", "sub", "inv"):
        t_fac.append(cuda_ms(
            (lambda: ldl.ldl_factor(K.clone())) if which == "inv"
            else (lambda: ldl.ldl_factor_subst(K.clone())), reps=3))
        torch.cuda.empty_cache()
    print(f"factor, {L} x Dp {Dp}, ms: ldl_factor {t_fac[0]:.2f} / "
          f"{t_fac[3]:.2f}, ldl_factor_subst with its pack {t_fac[1]:.2f} / "
          f"{t_fac[2]:.2f}; node products they need: "
          f"{L * node_ops(Dp, True) / 1e9:.1f} / "
          f"{L * node_ops(Dp, False) / 1e9:.1f} GFLOP")
    del K
    torch.cuda.empty_cache()

    # ---- the "full" strategy's shape: 4 lanes, Dp 7040, k = 2
    Lf, nbf = 4, FULL_DP // B
    Kf = quasidefinite(torch, Lf, FULL_DP, 5000, seed=16)
    K2 = Kf.clone()
    fs = ldl.ldl_factor_subst(K2)
    del K2
    r, wk = check_sweeps(fs.pre, Kf, None, Lf, FULL_DP, 2,
                         f"{Lf} x Dp {FULL_DP}")
    nbytes, io, ops = sweep_bound(Lf, nbf, 2)
    for name, fn, extra in (
            ("dense_fwd", lambda: dense.dense_fwd(fs.pre, r),
             Lf * FULL_DP * 8),
            ("dense_bwd", lambda: dense.dense_bwd(fs.pre, wk), 0)):
        b_ms, b_by = bound(nbytes + extra + io, ops)
        print(f"{name} at {Lf} x Dp {FULL_DP}, k=2: "
              f"{cuda_ms(fn, reps=5):.4f} ms, bound {b_ms:.4f} ms by {b_by}")
    del Kf, fs, r, wk
    torch.cuda.empty_cache()

    # ---- leaf_ldl at f32
    M = quasidefinite(torch, L, B, 80, seed=2)
    M32 = M.to(torch.float32)
    Lk, dk = leaf.leaf_ldl(M32)
    Lp_, dp_ = leaf.leaf_ldl_plain(M32)
    L64, d64 = leaf.leaf_ldl(M)
    torch.cuda.synchronize()
    e_plain = max(rel_err(Lk, Lp_), rel_err(dk, dp_))
    e_64 = max(rel_err(Lk.double(), L64), rel_err(dk.double(), d64))
    resid = rel_err(Lk.double() @ M32.double() @ Lk.double().transpose(-1, -2),
                    torch.diag_embed(dk.double()))
    print(f"leaf_ldl f32 vs plain: max rel err {e_plain:.3e}; vs the f64 "
          f"leaf {e_64:.3e}; ||Linv M Linv' - diag(d)|| rel {resid:.3e} "
          f"(tolerance {F32_LEAF_TOL})")
    if (Lk.dtype != torch.float32 or not max(e_plain, e_64) <= F32_LEAF_TOL
            or not resid <= F32_LEAF_TOL):
        fail("leaf_ldl at f32 disagrees with its plain version or the f64 "
             "leaf")
    b_ms, b_by = bound(L * (B * (B + 1) // 2 * 4 + B * B * 4 + B * 4),
                       L * (B ** 3 // 2 + B ** 3 // 3))
    ms = cuda_ms(lambda: leaf.leaf_ldl(M32))
    pms = cuda_ms(lambda: leaf.leaf_ldl_plain(M32), reps=5)
    print(f"leaf_ldl f32: {ms:.4f} ms (plain {pms:.3f} ms; the f64 leaf "
          f"{cuda_ms(lambda: leaf.leaf_ldl(M)):.4f} ms), bound {b_ms:.4f} ms "
          f"by {b_by}")
    records.append(dict(
        name="leaf_ldl_f32", route="cuda",
        source="eicos_tpu_torch/csrc/leaf_ldl_f32.cu",
        replaces="eicos_tpu/ops/pallas_leaf.py:56",
        max_abs_err=max(float((Lk - Lp_).abs().max()),
                        float((dk - dp_).abs().max())),
        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # ---- the whole f32 factor and solve (f32 leaf, torch.matmul products
    # and passes) against the f64 ones
    Kq = quasidefinite(torch, 8, 4 * B, 300, seed=17)
    rq = rnd(8, 2, 4 * B)
    x64 = ldl.ldl_solve(ldl.ldl_factor(Kq.clone()), rq)
    x32 = ldl.ldl_solve(ldl.ldl_factor(Kq.to(torch.float32)),
                        rq.to(torch.float32))
    e_32 = rel_err(x32.double(), x64)
    print(f"ldl_factor + ldl_solve at f32, 8 x Dp {4 * B}: {x32.dtype}, rel "
          f"err vs the f64 solve {e_32:.3e} (tolerance {F32_LEAF_TOL})")
    if x32.dtype != torch.float32 or not e_32 <= F32_LEAF_TOL:
        fail("the f32 factor and solve disagree with the f64 ones")
    return records


def perturbed_lanes(pt, st, base, lanes, nx, seed):
    """bench.py's lanes of one base problem: shared G/A/h, per-lane c and
    x0 (the first ``nx`` entries of b)."""
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(lanes):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(st.n)
        b = np.asarray(base.b).copy()
        b[:nx] += 0.05 * rng.standard_normal(nx)
        probs.append(pt.ProblemData(G=base.G, A=base.A, c=c, h=base.h, b=b))
    shared = ("G", "A", "h")
    return st, probs, pt.BatchedSolver.stack(probs, shared=shared), shared


def build_batch(pt, corpus, make_band_plan):
    """bench.py's batch: shared G/A/h, per-lane c and x0 (in b)."""
    st, base = corpus.make_mpc_like(horizon=HORIZON, nx=NX, nu=NU, seed=3)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    return perturbed_lanes(pt, st, base, LANES, NX, 7)


def build_socp_batch(pt, corpus, lanes, make_band_plan=None):
    """The first ``lanes`` lanes of bench.py's SOCP batch (lane rng 11):
    without a band plan for the "reduced" strategy, which keeps its SOC
    rows, or with bench.py's keep_soc plan for "banded"."""
    st, base = corpus.make_mpc_soc(horizon=HORIZON, nx=NX, nu=NU, seed=5)
    st = st.with_gsplit(base.G, base.A)
    if make_band_plan is not None:
        st = st.with_band_plan(make_band_plan(st, base.G, base.A,
                                              keep_soc=True))
    return perturbed_lanes(pt, st, base, lanes, NX, 11)


def build_wide_batch(pt, corpus, make_band_plan):
    """Phase 7's batch: a wide-stage MPC LP whose RCM plan has block
    bandwidth 3, lanes made as bench.py makes them (lane rng 7)."""
    st, base = corpus.make_mpc_like(**WIDE)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    return perturbed_lanes(pt, st, base, WIDE_LANES, WIDE["nx"], 7)


def profile_solve(torch, bs, batch, cuda_only=False):
    """Device time by kernel over one solve (torch.profiler) and the
    device's idle share of the solve's wall time.  ``cuda_only`` records
    the device activity alone: a solve of ~10^6 launches (the scan) takes
    minutes of the profiler's host-side processing with the CPU's."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    if not cuda_only:
        acts.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bs.solve(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only: an operator's own row repeats the time
        # of the kernels it launched
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev:
            rows.append((dev / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print("profile: no device time in the trace (not measured)")
        return
    print(f"profile: one solve {wall * 1e3:.1f} ms wall, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / (wall * 1e3):.3f}); "
          f"{sum(r[2] for r in rows)} kernel launches; the profile took "
          f"{time.perf_counter() - t_prof:.1f} s")
    for ms, key, count in rows[:10]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {key[:90]}")


def drive(torch, kernels, kkt, bs, batch):
    """One solve with every launch count at 0 just before it: returns the
    solution, the counts just after (with the number of factors under
    "factors": ``kkt.factor`` is wrapped to count its calls for the
    solve), the host syncs and the wall time."""
    real = kkt.factor
    factors = [0]

    def counted(*args, **kw):
        factors[0] += 1
        return real(*args, **kw)

    torch.cuda.synchronize()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    kkt.factor = counted
    try:
        t0 = time.perf_counter()
        sol = bs.solve(batch)
        torch.cuda.synchronize()
    finally:
        kkt.factor = real
    return (sol, dict(kernels.COUNTS, factors=factors[0]),
            kkt.host_syncs - syncs0, time.perf_counter() - t0)


def timed(torch, bs, batch, lanes, reps=3):
    """Median wall time of ``reps`` solves after the first; prints it and
    returns the last solution and the median solves/s."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sol = bs.solve(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"timed solves {times} s; median {lanes / med:.2f} solves/s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB")
    return sol, lanes / med


def same_bits(torch, first, again, label):
    """Two solves of one batch must give the same bits: every sum on the
    path runs in a fixed order."""
    same = all(torch.equal(a, b) for a, b in (
        (first.exit_code, again.exit_code), (first.info.iter, again.info.iter),
        (first.x, again.x), (first.y, again.y), (first.z, again.z)))
    print(f"{label}: a repeated solve gives the same bits: {same}")
    if not same:
        fail(f"{label}: two solves of the same batch differ")


def outcome(sol, label):
    codes = sol.exit_code.cpu().numpy()
    iters = sol.info.iter.cpu().numpy()
    hist = {int(c): int((codes == c).sum()) for c in np.unique(codes)}
    print(f"{label}: exit codes {hist}; iterations min/median/max "
          f"{iters.min()}/{np.median(iters):g}/{iters.max()}")
    return codes, iters, hist


def need_launched(launches, names, label):
    missing = [n for n in names if not launches[n] > 0]
    if missing:
        fail(f"{label}: kernels of the path never launched: {missing} "
             f"({launches})")


def same_as_cpu(pt, st, prob, settings, sol, label):
    """Lane 0 again on the CPU plain path: same exit code and iteration
    count, objective within LANE_TOL."""
    t0 = time.perf_counter()
    cpu = pt.solve(st, prob, settings, device="cpu")
    t_cpu = time.perf_counter() - t0
    g_code, g_it = int(sol.exit_code[0]), int(sol.info.iter[0])
    g_pc, c_pc = float(sol.info.pcost[0]), float(cpu.info.pcost)
    print(f"{label} lane 0: GPU code {g_code} iter {g_it} pcost {g_pc!r}; "
          f"CPU plain code {int(cpu.exit_code)} iter {int(cpu.info.iter)} "
          f"pcost {c_pc!r} ({t_cpu:.1f} s)")
    if (int(cpu.exit_code) != g_code or int(cpu.info.iter) != g_it
            or not abs(g_pc - c_pc) <= LANE_TOL * abs(c_pc)):
        fail(f"{label}: lane 0 disagrees between the kernels and the plain "
             f"path")


def all_optimal_or_as_cpu(pt, st, probs, shared, settings, rescue, sol,
                          label):
    """Every lane must end OPTIMAL.  Lanes that do not are solved again on
    the CPU plain path, same settings and rescue: the card must then give
    each of them the CPU's code (a property of the method on that lane,
    recorded as a finding), else a kernel or an assembly is wrong."""
    codes = sol.exit_code.cpu().numpy()
    bad = [int(i) for i in np.flatnonzero(codes != 0)]
    if not bad:
        print(f"{label}: every lane OPTIMAL")
        return
    t0 = time.perf_counter()
    cpu = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue,
                           device="cpu").solve(pt.BatchedSolver.stack(
                               [probs[i] for i in bad], shared=shared))
    ccodes = cpu.exit_code.numpy()
    print(f"{label}: lanes short of OPTIMAL {bad}: card codes "
          f"{codes[bad].tolist()}, CPU plain path codes {ccodes.tolist()} "
          f"({time.perf_counter() - t0:.1f} s)")
    if ccodes.tolist() != codes[bad].tolist():
        fail(f"{label}: lanes {bad} end short of OPTIMAL on the card with "
             f"other codes than on the CPU plain path")


def code_rank(code):
    """Exit tier: 2 definitive, 1 reduced accuracy, 0 failure."""
    return 2 if code in (0, 1, 2) else (1 if code in (10, 11, 12) else 0)


def tiers_as_cpu(pt, st, probs, shared, settings, sol, lanes, label):
    """Paths whose endgame turns on the last bits ("normal" on a SOCP, an
    f32 factor): the lanes ``lanes`` are solved again on the CPU plain
    path; codes and iteration counts are printed.  Such a lane can end
    OPTIMAL on one device and CLOSE_TO_OPTIMAL on the other, so the card
    must answer (definitive or reduced-accuracy exit) exactly where the
    CPU does, with the CPU's objective within INACC_TOL."""
    t0 = time.perf_counter()
    cpu = pt.BatchedSolver(st, settings, shared=shared, device="cpu").solve(
        pt.BatchedSolver.stack([probs[i] for i in lanes], shared=shared))
    codes = sol.exit_code.cpu().numpy()[lanes].tolist()
    ccodes = cpu.exit_code.numpy().tolist()
    pc = sol.info.pcost.cpu().numpy()[lanes]
    cpc = cpu.info.pcost.numpy()
    print(f"{label}: lanes {lanes} on the card: codes {codes}, iterations "
          f"{sol.info.iter.cpu().numpy()[lanes].tolist()}; CPU plain path: "
          f"codes {ccodes}, iterations {cpu.info.iter.numpy().tolist()} "
          f"({time.perf_counter() - t0:.1f} s)")
    for j, lane in enumerate(lanes):
        if bool(code_rank(codes[j])) != bool(code_rank(ccodes[j])):
            fail(f"{label}: lane {lane} ends with code {codes[j]} on the "
                 f"card and {ccodes[j]} on the CPU plain path: one has an "
                 f"answer, the other fails")
        if code_rank(codes[j]) and not (abs(pc[j] - cpc[j])
                                        <= INACC_TOL * abs(cpc[j])):
            fail(f"{label}: lane {lane} objective {pc[j]} vs CPU {cpc[j]}")


def objectives_close(sol, want, tol_by_tier, label):
    """The first ``len(want)`` lanes, where they exit with an answer, must
    have the reference objective ``want``: within ``tol_by_tier[tier]``
    relative, tier 2 definitive, 1 reduced accuracy."""
    codes = sol.exit_code.cpu().numpy()[:len(want)]
    pc = sol.info.pcost.cpu().numpy()[:len(want)]
    for tier, tol in tol_by_tier.items():
        sel = np.array([code_rank(int(c)) == tier for c in codes])
        if not sel.any():
            continue
        worst = float((np.abs(pc[sel] - want[sel]) / np.abs(want[sel])).max())
        print(f"{label}: {int(sel.sum())} lanes of tier {tier}, objective vs "
              f"the reference path's: max relative difference {worst:.3e}")
        if not worst <= tol:
            fail(f"{label}: objectives of tier {tier} differ by {worst}")


def run_path(torch, pt, kernels, kkt, label, st, probs, batch, shared,
             settings, rescue, names, reps=3, cuda_only=False):
    """Drive one path of the port at full width: a first solve with the
    launch counts read around it, ``reps`` timed solves, the bit-repeat
    check, the exit codes before and after the rescue, every lane OPTIMAL
    (or as on the CPU), one profiled solve, lane 0 on the CPU plain path.
    Returns the launch counts and the solution of the first solve."""
    lanes = len(probs)
    bs = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue)
    torch.cuda.reset_peak_memory_stats()
    sol, launches, syncs, t_first = drive(torch, kernels, kkt, bs, batch)
    print(f"{label}: first solve {t_first:.3f} s; host syncs {syncs}; kernel "
          f"launches {launches}; rescued lanes {list(bs.last_rescued)}")
    need_launched(launches, names, label)
    first = sol
    sol, _ = timed(torch, bs, batch, lanes, reps)
    same_bits(torch, first, sol, label)
    del first
    if rescue is not None:
        outcome(pt.BatchedSolver(st, settings, shared=shared).solve(batch),
                f"{label}, before the rescue")
        print(f"{label}: last_rescued {list(bs.last_rescued)}")
    outcome(sol, label)
    all_optimal_or_as_cpu(pt, st, probs, shared, settings, rescue, sol, label)
    profile_solve(torch, bs, batch, cuda_only)
    same_as_cpu(pt, st, probs[0], settings, sol, label)
    return launches, sol


def build_scan_batch(pt, corpus, make_band_plan):
    """Phase 12's batch: a 256-state, 128-input MPC LP whose RCM plan has
    block bandwidth 9, lanes made as bench.py makes them (lane rng 7)."""
    st, base = corpus.make_mpc_like(**SCAN)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    return perturbed_lanes(pt, st, base, SCAN_LANES, SCAN["nx"], 7)


def scan_leaf_record(torch, leaf, lanes, dtype, tol):
    """The leaf kernel at the scan's shape, ``lanes`` Schur blocks a launch
    (one a block row), against its plain version: error, time and bound."""
    M = quasidefinite(torch, lanes, B, 80, seed=5).to(dtype)
    Lk, dk = leaf.leaf_ldl(M)
    Lp, dp = leaf.leaf_ldl_plain(M)
    torch.cuda.synchronize()
    err = max(rel_err(Lk, Lp), rel_err(dk, dp))
    es = M.element_size()
    b_ms, b_by = bound(lanes * (B * (B + 1) // 2 * es + B * B * es + B * es),
                       lanes * (B ** 3 // 2 + B ** 3 // 3))
    ms = cuda_ms(lambda: leaf.leaf_ldl(M))
    pms = cuda_ms(lambda: leaf.leaf_ldl_plain(M), reps=5)
    print(f"leaf at the scan's shape, {lanes} x {dtype}: {ms:.4f} ms (plain "
          f"{pms:.3f} ms), bound {b_ms:.5f} ms by {b_by}; max rel err vs "
          f"plain {err:.3e} (tolerance {tol})")
    if not err <= tol:
        fail(f"the leaf at the scan's shape ({dtype}) disagrees with its "
             f"plain version")
    return dict(max_abs_err=max(float((Lk - Lp).abs().max()),
                                float((dk - dp).abs().max())),
                ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def scan_launches(launches, name, nb, label):
    """The scan launches the leaf kernel ``name`` once a block row of every
    factor, and no band kernel."""
    want = nb * launches["factors"]
    print(f"{label}: {name} launched {launches[name]} times, nb {nb} x "
          f"{launches['factors']} factors = {want}")
    if launches[name] != want:
        fail(f"{label}: {name} launched {launches[name]} times, expected "
             f"{want}")
    if any(launches[n] for n in ("band_factor_bw", "band_fwd_bw",
                                 "band_bwd_bw")):
        fail(f"{label}: the scan launched a band kernel: {launches}")


@contextlib.contextmanager
def captured_blocks(kkt, count, lanes):
    """Inside the block, ``kkt.band_factor`` records copies of its first
    ``count`` calls' inputs, the path's own gathered blocks of the first
    ``lanes`` lanes with the product type, into the yielded list."""
    real = kkt.band_factor
    got = []

    def capture(Kd, Ks, gemm_dtype=None):
        if len(got) < count:
            got.append((Kd[:lanes].clone(), Ks[:lanes].clone(), gemm_dtype))
        return real(Kd, Ks, gemm_dtype)

    kkt.band_factor = capture
    try:
        yield got
    finally:
        kkt.band_factor = real


def scan_as_cpu(torch, plain, Kd, Ks, gdt, label):
    """The scan factor of (Kd, Ks) on the card (the leaf kernel of their
    type) against the CPU plain path: the largest relative error of L,
    Dinv and the solve of two random right-hand sides."""
    fk = plain.band_ldl_factor(Kd, Ks, gemm_dtype=gdt)
    fc = plain.band_ldl_factor(Kd.cpu(), Ks.cpu(), gemm_dtype=gdt)
    g = torch.Generator().manual_seed(3)
    r = torch.randn(Kd.shape[0], 2, Kd.shape[1] * B, generator=g,
                    dtype=Kd.dtype)
    xk = plain.band_ldl_solve(fk, r.to(Kd.device), gdt).cpu()
    xc = plain.band_ldl_solve(fc, r, gdt)
    errs = [rel_err(fk.L.cpu(), fc.L), rel_err(fk.Dinv.cpu(), fc.Dinv),
            rel_err(xk, xc)]
    print(f"{label}: {Kd.dtype} blocks, products in {gdt or Kd.dtype}, "
          f"{Kd.shape[0]} lanes x nb {Kd.shape[1]} x bw {Ks.shape[2]}; card "
          f"vs CPU plain path: L {errs[0]:.3e}, Dinv {errs[1]:.3e}, solve "
          f"{errs[2]:.3e}")
    return max(errs)


def phase_scan(torch, pt, corpus, kernels, kkt, leaf, plain,
               make_band_plan):
    """Phase 12: the banded scan at block bandwidth 9.  Returns the leaf
    record at its shape with this phase's launches."""
    st, probs, batch, shared = build_scan_batch(pt, corpus, make_band_plan)
    nb = st.band.dim // B
    print(f"scan band: n={st.n} p={st.p} m={st.m}, Dp={st.band.dim}, nb={nb}, "
          f"bwb={st.band.bwb}, {SCAN_LANES} lanes, no rescue")
    if (st.band.bwb, st.band.dim) != (SCAN_BWB, SCAN_DP):
        fail(f"scan band: plan bwb {st.band.bwb}, Dp {st.band.dim}; expected "
             f"{SCAN_BWB}, {SCAN_DP}")
    record = scan_leaf_record(torch, leaf, SCAN_LANES, torch.float64,
                              KERNEL_TOL)
    settings = pt.Settings(kkt_strategy="banded")
    launches, sol = run_path(torch, pt, kernels, kkt, "scan band", st, probs,
                             batch, shared, settings, None, ["leaf_ldl"],
                             reps=1, cuda_only=True)
    scan_launches(launches, "leaf_ldl", nb, "scan band")
    record["launches"] = launches["leaf_ldl"]
    del sol
    torch.cuda.empty_cache()

    # the f32 products on well-conditioned blocks at the path's shape:
    # this LP's own blocks carry the 1/delta growth of its equality pivots,
    # which f32 products cannot carry (printed below, not held)
    Kd, Ks = random_wide_band(torch, CPU_LANES, nb, SCAN_BWB, seed=17)
    err = scan_as_cpu(torch, plain, Kd, Ks, torch.float32,
                      "scan, f32 products, random band")
    off = rel_err(plain.band_ldl_factor(Kd, Ks, gemm_dtype=torch.float32).L,
                  plain.band_ldl_factor(Kd, Ks).L)
    print(f"scan, f32 products, random band: L against f64 products' on the "
          f"card {off:.3e}")
    if not (err <= F32_SCAN_TOL and off > KERNEL_TOL):
        fail("scan band: the scan with f32 products disagrees with the CPU "
             "or does not round its products to f32")
    del Kd, Ks
    g32 = pt.Settings(kkt_strategy="banded", band_gemm="float32")
    gs = pt.BatchedSolver(st, g32, shared=shared)
    with captured_blocks(kkt, 1, 1) as own:
        gsol, launches, syncs, t_first = drive(torch, kernels, kkt, gs, batch)
    scan_as_cpu(torch, plain, *own[0], "scan band, band_gemm f32, the "
                "path's first factor (not held)")
    del own
    print(f"scan band, band_gemm f32: first solve {t_first:.3f} s; host "
          f"syncs {syncs}; kernel launches {launches}")
    scan_launches(launches, "leaf_ldl", nb, "scan band, band_gemm f32")
    codes, _, _ = outcome(gsol, "scan band, band_gemm f32")
    short = [int(i) for i in np.flatnonzero(codes != 0)][:SCAN_CPU_LANES]
    tiers_as_cpu(pt, st, probs, shared, g32, gsol, short or [0],
                 "scan band, band_gemm f32")
    del gs, gsol, batch, probs
    torch.cuda.empty_cache()
    return record


def phase_f32_banded(torch, pt, corpus, kernels, kkt, leaf, plain,
                     make_band_plan, soc_pcost):
    """Phase 13: "banded" with an f32 factor on phase 6's SOCP lanes.
    Returns the f32 leaf record at its shape with this phase's
    launches."""
    st, probs, batch, shared = build_socp_batch(pt, corpus, LANES,
                                                make_band_plan)
    nb = st.band.dim // B
    record = scan_leaf_record(torch, leaf, LANES, torch.float32, F32_LEAF_TOL)
    f32 = pt.Settings(kkt_strategy="banded", factor_dtype="float32")
    bs = pt.BatchedSolver(st, f32, shared=shared)
    torch.cuda.reset_peak_memory_stats()
    with captured_blocks(kkt, 2, CPU_LANES) as own:
        sol, launches, syncs, t_first = drive(torch, kernels, kkt, bs, batch)
    print(f"banded, f32 factor: keep_soc plan Dp={st.band.dim} nb={nb} "
          f"bwb={st.band.bwb}, {LANES} lanes; first solve {t_first:.3f} s; "
          f"host syncs {syncs}; kernel launches {launches}")
    need_launched(launches, ["leaf_ldl_f32"], "banded, f32 factor")
    if any(launches[n] for n in ("leaf_ldl", "dgemm")):
        fail(f"banded, f32 factor: launched an f64 kernel: {launches}")
    scan_launches(launches, "leaf_ldl_f32", nb, "banded, f32 factor")
    record["launches"] = launches["leaf_ldl_f32"]
    # the f32 scan on the path's own blocks (the init factor and the first
    # iteration's), which f32 carries, whatever the lanes' outcome
    for i, blocks in enumerate(own):
        if not scan_as_cpu(torch, plain, *blocks, f"banded, f32 factor, "
                           f"factor {i} of the path") <= F32_SCAN_TOL:
            fail(f"banded, f32 factor: the f32 scan of the path's factor {i} "
                 f"disagrees with the CPU")
    del own
    again, _ = timed(torch, bs, batch, LANES, reps=2)
    same = torch.equal(sol.exit_code, again.exit_code) and torch.equal(
        sol.x, again.x)
    print(f"banded, f32 factor: a repeated solve gives the same bits: {same} "
          f"(printed, not checked: the f32 products are cuBLAS's)")
    outcome(sol, "banded, f32 factor")
    # a lane that claims an answer under the f32 factor must have it
    objectives_close(sol, soc_pcost, {2: F32_TOL, 1: INACC_TOL},
                     "banded, f32 factor, against phase 6")
    profile_solve(torch, bs, batch, cuda_only=True)
    tiers_as_cpu(pt, st, probs, shared, f32, sol, list(range(CPU_LANES)),
                 "banded, f32 factor")
    del bs, sol, again, batch
    torch.cuda.empty_cache()
    return record


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


def table_rows(text):
    """The iteration rows of a printed table, without the IR column (it
    turns on the last bits)."""
    return [r[:-12] for r in text.splitlines() if r[:3].strip().isdigit()]


def phase_entry(torch, pt, probs, shared, st):
    """Phase 14: the entry points on the card, on phase 2's lane 0."""
    from eicos_tpu_torch import ecos_compat
    from eicos_tpu_torch.utils import timing

    banded = pt.Settings(kkt_strategy="banded")
    p0 = probs[0]
    one = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b, settings=banded)
    buf = io.StringIO()
    code = one.solve_live(seg=3, file=buf)
    live = one.last_solution
    rows = table_rows(buf.getvalue())
    again = one.solve()
    sol = one.last_solution
    same = (code == again and all(torch.equal(getattr(live, f),
                                              getattr(sol, f))
                                  for f in ("x", "y", "z", "s")))
    n_it = int(sol.info.iter)
    print(f"Solver.solve_live(seg=3): code {int(code)}, {len(rows)} rows for "
          f"{n_it} iterations; the same bits as solve(): {same}")
    if len(rows) != n_it + 1 or not same or int(code) != 0:
        fail("Solver.solve_live disagrees with Solver.solve")

    lanes = pt.BatchedSolver.stack(probs[:4], shared=shared)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        vsol = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded",
                                                verbose_live=True),
                                shared=shared).solve(lanes)
    vrows = table_rows(out.getvalue())
    print(f"verbose_live, 4 lanes: {len(vrows)} rows streamed for lane 0's "
          f"{int(vsol.info.iter[0])} iterations; rows as solve_live's: "
          f"{vrows == rows}")
    if vrows != rows or not out.getvalue().startswith("It "):
        fail("verbose_live did not stream lane 0's rows")

    G, A, c, h, b, q = small_socp()
    import scipy.sparse as sp

    r = ecos_compat.solve_ecos(c, sp.csc_matrix(G), h,
                               {"l": G.shape[0] - 3, "q": list(q)},
                               sp.csc_matrix(A), b)
    s = pt.Solver(G, A, c, h, b, soc_dims=q)
    scode = s.solve()
    dx = float(np.abs(r["x"] - s.solution()).max())
    print(f"solve_ecos: exitFlag {r['exitFlag']}, Solver code {int(scode)}; "
          f"max |x - x_Solver| {dx:.3e}")
    if r["exitFlag"] != int(scode) or not dx <= LANE_TOL:
        fail("ecos_compat.solve_ecos disagrees with Solver on the card")

    # the CLI in subprocesses, on lane 0 saved inside the checkout
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        npz = os.path.join(tmp, "lane0.npz")
        pt.save_problem(npz, st, p0)
        for args in (["solve", npz, "--live"],
                     ["demo", "--horizon", "40", "--batch", "8"]):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "eicos_tpu_torch",
                                   *args], cwd=here, capture_output=True,
                                  text=True, timeout=300)
            tail = proc.stdout.strip().splitlines()[-3:]
            shown = " ".join(os.path.basename(a) for a in args)
            print(f"python -m eicos_tpu_torch {shown}: exit "
                  f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; "
                  f"{tail}")
            if proc.returncode != 0:
                fail(f"python -m eicos_tpu_torch {args[0]} exited "
                     f"{proc.returncode}: {proc.stderr[-2000:]}")

    bs = pt.BatchedSolver(st, banded, shared=shared)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def solve_between_events():
        e0.record()
        out = bs.solve(lanes)
        e1.record()
        return out

    bs.solve(lanes)
    _, ms = timing.timed(solve_between_events)
    ev = e0.elapsed_time(e1)
    print(f"utils.timing.timed: {ms:.3f} ms; CUDA events around the same "
          f"solve {ev:.3f} ms")
    if not ms >= ev:
        fail("utils.timing.timed returned less than the solve's device time")

    # a call that returns with its work still queued (the solve above reads
    # a flag back every iteration): four f64 products of 8192 x 8192
    a = torch.randn(8192, 8192, dtype=torch.float64, device="cuda")
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
    ev = e0.elapsed_time(e1)
    print(f"utils.timing.timed on four queued f64 products: {ms:.3f} ms; "
          f"CUDA events {ev:.3f} ms; host time of the launches alone "
          f"{launch_ms:.3f} ms")
    if not (ms >= ev and ms >= 10 * launch_ms):
        fail("utils.timing.timed did not wait for the queued products")
    del a


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, kkt
    from eicos_tpu_torch.ops import band, dense, gemm, kernels, ldl, leaf
    from eicos_tpu_torch.ops import band_ldl as plain
    from eicos_tpu_torch.plan import make_band_plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # the f32 products of factor_dtype="float32" must run in full f32
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on")

    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    dgemm_sass(kernels)
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    band_records = check_kernels(torch, band, plain)
    wide_records = check_wide_kernels(torch, band, plain, kernels)
    dense_records = check_dense_kernels(torch, band, leaf, gemm, ldl)
    subst_records = check_subst_kernels(torch, leaf, ldl, dense, kernels)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    band_names = [r["name"] for r in band_records]
    wide_names = [r["name"] for r in wide_records]
    dense_names = [r["name"] for r in dense_records]
    subst_names = ["leaf_ldl", "dgemm", "dense_pack", "dense_fwd",
                   "dense_bwd"]
    linv_names = ["linv_fwd", "linv_bwd"]

    # ---- phase 2: the main path as bench.py configures it
    t_phase = time.perf_counter()
    st, probs, batch, shared = build_batch(pt, corpus, make_band_plan)
    print(f"main path: n={st.n} p={st.p} m={st.m}, Dp={st.band.dim}, "
          f"bwb={st.band.bwb}, {LANES} lanes, rescue 'reduced'")
    settings = pt.Settings(kkt_strategy="banded")
    rescue = pt.Settings(kkt_strategy="reduced")
    bs = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue)
    torch.cuda.reset_peak_memory_stats()
    sol, launches, syncs, t_first = drive(torch, kernels, kkt, bs, batch)
    print(f"first solve {t_first:.3f} s; host syncs {syncs}; kernel "
          f"launches {launches}; rescued lanes {list(bs.last_rescued)}")
    need_launched(launches, band_names, "main path")
    for r in band_records:
        r["launches"] = launches[r["name"]]
    first = sol
    sol, _ = timed(torch, bs, batch, LANES)
    same_bits(torch, first, sol, "main path")
    codes, iters, hist = outcome(sol, "main path")
    if hist != {0: LANES}:
        fail(f"not every lane exited OPTIMAL: {hist}")
    if bs.last_rescued:
        fail(f"the main path rescued lanes {list(bs.last_rescued)}")
    banded_pcost = sol.info.pcost.cpu().numpy()
    # torch's own account of the synchronizing calls of one solve, beside
    # the loops' count (one per IPM iteration and refinement trip)
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        syncs0 = kkt.host_syncs
        bs.solve(batch)
        counted = kkt.host_syncs - syncs0
    torch.cuda.set_sync_debug_mode(0)
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    print(f"synchronizing calls flagged by torch in one solve: {flagged} "
          f"(loop count {counted})")
    profile_solve(torch, bs, batch)
    same_as_cpu(pt, st, probs[0], settings, sol, "main path")
    print(f"phase 2: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 3: forced rescue, the primary cut at 3 iterations
    t_phase = time.perf_counter()
    sub = pt.BatchedSolver.stack(probs[:RESCUE_LANES], shared=shared)
    fs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded", iter_max=3),
                          shared=shared, rescue=rescue)
    fsol, launches, syncs, t_f = drive(torch, kernels, kkt, fs, sub)
    _, _, hist = outcome(fsol, "forced rescue")
    print(f"forced rescue: {t_f:.3f} s; rescued lanes {list(fs.last_rescued)}"
          f"; kernel launches {launches}")
    if fs.last_rescued != tuple(range(RESCUE_LANES)):
        fail(f"forced rescue took lanes {fs.last_rescued}, expected all "
             f"{RESCUE_LANES}")
    if hist != {0: RESCUE_LANES}:
        fail(f"forced rescue: not every lane OPTIMAL: {hist}")
    need_launched(launches, band_names + dense_names, "forced rescue")
    print(f"phase 3: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 4: the reduced strategy at full width
    t_phase = time.perf_counter()
    red = pt.Settings(kkt_strategy="reduced", dense_solve="inverse")
    rs = pt.BatchedSolver(st, red, shared=shared)
    torch.cuda.reset_peak_memory_stats()
    rsol, launches, syncs, t_first = drive(torch, kernels, kkt, rs, batch)
    Dp = -(-(st.n + st.p) // B) * B
    print(f"reduced: Dp={Dp}, {LANES} lanes; first solve {t_first:.3f} s; "
          f"host syncs {syncs}; kernel launches {launches}")
    need_launched(launches, dense_names, "reduced")
    for r in dense_records:
        r["launches"] = launches[r["name"]]
    first = rsol
    rsol, inverse_rate = timed(torch, rs, batch, LANES)
    same_bits(torch, first, rsol, "reduced")
    del first
    codes, iters, hist = outcome(rsol, "reduced")
    if hist != {0: LANES}:
        fail(f"reduced: not every lane exited OPTIMAL: {hist}")
    gap = np.abs(rsol.info.pcost.cpu().numpy() - banded_pcost)
    worst = float((gap / np.abs(banded_pcost)).max())
    print(f"reduced vs banded objective: max relative difference {worst:.3e}")
    if not worst <= STRATEGY_TOL:
        fail(f"reduced and banded objectives differ by {worst}")
    profile_solve(torch, rs, batch)
    same_as_cpu(pt, st, probs[0], red, rsol, "reduced")
    red0 = (int(rsol.exit_code[0]), int(rsol.info.iter[0]),
            float(rsol.info.pcost[0]))
    del rs, rsol
    torch.cuda.empty_cache()
    print(f"phase 4: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 5: the SOCP problem under "reduced"
    t_phase = time.perf_counter()
    sst, sprobs, sbatch, sshared = build_socp_batch(pt, corpus, SOC_LANES)
    print(f"SOCP: n={sst.n} p={sst.p} m={sst.m} (ms={sst.m - sst.l} kept "
          f"SOC rows), {SOC_LANES} lanes")
    ss = pt.BatchedSolver(sst, red, shared=sshared)
    torch.cuda.reset_peak_memory_stats()
    ssol, launches, syncs, t_s = drive(torch, kernels, kkt, ss, sbatch)
    outcome(ssol, "SOCP reduced")
    print(f"SOCP reduced: {t_s:.3f} s ({SOC_LANES / t_s:.2f} solves/s, first "
          f"solve); host syncs {syncs}; kernel launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB")
    need_launched(launches, dense_names, "SOCP reduced")
    print(f"SOCP reduced: exit codes by lane {ssol.exit_code.tolist()}")
    same_bits(torch, ssol, ss.solve(sbatch), "SOCP reduced")
    same_as_cpu(pt, sst, sprobs[0], red, ssol, "SOCP reduced")
    soc_red_pcost = ssol.info.pcost.cpu().numpy()
    print(f"phase 5: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 6: the SOCP lane of the main path (NT-scaled kept cones)
    t_phase = time.perf_counter()
    del ss, ssol, sbatch
    torch.cuda.empty_cache()
    kst, kprobs, kbatch, kshared = build_socp_batch(pt, corpus, LANES,
                                                    make_band_plan)
    print(f"SOCP lane: n={kst.n} p={kst.p} m={kst.m} l={kst.l}, "
          f"{kst.n_sc} cones, keep_soc plan Dp={kst.band.dim} "
          f"bwb={kst.band.bwb}, {LANES} lanes, rescue 'reduced'")
    if kst.band.bwb != 1 or not kst.band.keep_soc:
        fail(f"SOCP lane: unexpected plan (bwb {kst.band.bwb})")
    _, ksol = run_path(torch, pt, kernels, kkt, "SOCP lane", kst, kprobs,
                       kbatch, kshared, settings, rescue, band_names)
    soc_band_pcost = ksol.info.pcost.cpu().numpy()
    del kbatch, kprobs, ksol
    torch.cuda.empty_cache()
    print(f"phase 6: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 7: the wide band (block bandwidth 3) at a real size
    t_phase = time.perf_counter()
    wst, wprobs, wbatch, wshared = build_wide_batch(pt, corpus,
                                                    make_band_plan)
    print(f"wide band: n={wst.n} p={wst.p} m={wst.m}, Dp={wst.band.dim}, "
          f"bwb={wst.band.bwb}, {WIDE_LANES} lanes, no rescue")
    if (wst.band.bwb, wst.band.dim) != (WIDE_BWB, WIDE_DP):
        fail(f"wide band: plan bwb {wst.band.bwb}, Dp {wst.band.dim}; "
             f"expected {WIDE_BWB}, {WIDE_DP}")
    launches, _ = run_path(torch, pt, kernels, kkt, "wide band", wst, wprobs,
                           wbatch, wshared, settings, None, wide_names)
    for r in wide_records:
        r["launches"] = launches[r["name"]]
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 8: "reduced" at dense_solve="auto": substitution on the card
    t_phase = time.perf_counter()
    del wbatch, wprobs
    torch.cuda.empty_cache()
    auto = pt.Settings(kkt_strategy="reduced")
    us = pt.BatchedSolver(st, auto, shared=shared)
    torch.cuda.reset_peak_memory_stats()
    usol, launches, syncs, t_first = drive(torch, kernels, kkt, us, batch)
    print(f"reduced on substitution: {LANES} lanes; first solve "
          f"{t_first:.3f} s; host syncs {syncs}; kernel launches {launches}")
    need_launched(launches, subst_names, "reduced on substitution")
    if any(launches[n] for n in linv_names):
        fail(f"reduced on substitution launched the inverse solves: "
             f"{launches}")
    for r in subst_records:
        if r["name"] != "leaf_ldl_f32":
            r["launches"] = launches[r["name"]]
    first = usol
    usol, subst_rate = timed(torch, us, batch, LANES)
    same_bits(torch, first, usol, "reduced on substitution")
    del first
    codes, iters, hist = outcome(usol, "reduced on substitution")
    if hist != {0: LANES}:
        fail(f"reduced on substitution: not every lane OPTIMAL: {hist}")
    objectives_close(usol, banded_pcost, {2: STRATEGY_TOL},
                     "reduced on substitution")
    print(f"reduced, batch solves/s: inverse path {inverse_rate:.2f} (phase "
          f"4), substitution path {subst_rate:.2f}")
    profile_solve(torch, us, batch)
    same_as_cpu(pt, st, probs[0],
                pt.Settings(kkt_strategy="reduced", dense_solve="subst"),
                usol, "reduced on substitution")
    del us, usol
    torch.cuda.empty_cache()
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 9: "normal" on the SOCP problem (every cone eliminated)
    t_phase = time.perf_counter()
    nst, nprobs, nbatch, nshared = build_socp_batch(pt, corpus, LANES)
    normal = pt.Settings(kkt_strategy="normal")
    ns = pt.BatchedSolver(nst, normal, shared=nshared)
    torch.cuda.reset_peak_memory_stats()
    nsol, launches, syncs, t_first = drive(torch, kernels, kkt, ns, nbatch)
    print(f"normal: n={nst.n} p={nst.p} m={nst.m}, Dp="
          f"{-(-(nst.n + nst.p) // B) * B}, {LANES} lanes; first solve "
          f"{t_first:.3f} s; host syncs {syncs}; kernel launches {launches}")
    need_launched(launches, subst_names, "normal")
    first = nsol
    nsol, _ = timed(torch, ns, nbatch, LANES, reps=2)
    same_bits(torch, first, nsol, "normal")
    del first
    codes, iters, hist = outcome(nsol, "normal")
    print(f"normal: exit codes of lanes 0-{SOC_LANES - 1} "
          f"{codes[:SOC_LANES].tolist()}")
    # lanes 0-7 are phase 5's: the objective of the kept-cone solve
    objectives_close(nsol, soc_red_pcost, {2: STRATEGY_TOL, 1: INACC_TOL},
                     "normal, lanes of phase 5")
    if any(code_rank(int(c)) == 0 for c in codes):
        print("normal: some lanes end without an answer")
    # the lanes short of OPTIMAL, at most CPU_LANES of them, on the CPU
    short = [int(i) for i in np.flatnonzero(codes != 0)][:CPU_LANES]
    profile_solve(torch, ns, nbatch)
    tiers_as_cpu(pt, nst, nprobs, nshared, normal, nsol, short or [0],
                 "normal")
    del ns, nsol, nbatch, nprobs
    torch.cuda.empty_cache()
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 10: "full", the default Settings()
    t_phase = time.perf_counter()
    p0 = probs[0]
    kernels.reset_counts()
    one = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b)
    t0 = time.perf_counter()
    code = one.solve()
    torch.cuda.synchronize()
    launches = dict(kernels.COUNTS)
    info = one.get_info()
    Dp_full = -(-(st.n + st.p + st.m) // B) * B
    print(f"full, Solver at default settings, lane 0: Dp={Dp_full}; code "
          f"{int(code)} iter {int(info.iter)} pcost {float(info.pcost)!r} in "
          f"{time.perf_counter() - t0:.3f} s; kernel launches {launches}; "
          f"'reduced' on the card (phase 4): code {red0[0]} iter {red0[1]} "
          f"pcost {red0[2]!r}")
    if Dp_full != FULL_DP:
        fail(f"full: Dp {Dp_full}, expected {FULL_DP}")
    need_launched(launches, ["leaf_ldl", "dgemm"] + linv_names, "full")
    if launches["dense_fwd"] or launches["dense_pack"]:
        fail("full at default settings left the inverse path")
    # lane 0 against "reduced" on the card: a CPU solve at Dp 7040 would
    # take minutes
    if (int(code) != 0 or red0[0] != 0
            or not abs(float(info.pcost) - red0[2])
            <= STRATEGY_TOL * abs(red0[2])):
        fail("full: lane 0 disagrees with the reduced strategy")
    del one
    fbatch = pt.BatchedSolver.stack(probs[:FULL_LANES], shared=shared)
    for label, cfg, must, never in (
            ("full", pt.Settings(), linv_names, ["dense_pack", "dense_fwd",
                                                 "dense_bwd"]),
            ("full on substitution", pt.Settings(dense_solve="subst"),
             ["dense_pack", "dense_fwd", "dense_bwd"], linv_names)):
        fs_ = pt.BatchedSolver(st, cfg, shared=shared)
        torch.cuda.reset_peak_memory_stats()
        fsol, launches, syncs, t_first = drive(torch, kernels, kkt, fs_,
                                               fbatch)
        print(f"{label}: {FULL_LANES} lanes (cut from {LANES}), Dp="
              f"{Dp_full}; first solve {t_first:.3f} s; host syncs {syncs}; "
              f"kernel launches {launches}")
        need_launched(launches, ["leaf_ldl", "dgemm"] + must, label)
        if any(launches[n] for n in never):
            fail(f"{label}: launched {never}: {launches}")
        again, rate = timed(torch, fs_, fbatch, FULL_LANES, reps=1)
        same_bits(torch, fsol, again, label)
        codes, iters, hist = outcome(fsol, label)
        if hist != {0: FULL_LANES}:
            fail(f"{label}: not every lane OPTIMAL: {hist}")
        objectives_close(fsol, banded_pcost[:FULL_LANES], {2: STRATEGY_TOL},
                         label)
        profile_solve(torch, fs_, fbatch)
        del fs_, fsol, again
        torch.cuda.empty_cache()
    del fbatch
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 11: "reduced" with an f32 factor
    t_phase = time.perf_counter()
    f32 = pt.Settings(kkt_strategy="reduced", factor_dtype="float32")
    hs = pt.BatchedSolver(st, f32, shared=shared)
    torch.cuda.reset_peak_memory_stats()
    hsol, launches, syncs, t_first = drive(torch, kernels, kkt, hs, batch)
    print(f"reduced, f32 factor: {LANES} lanes; first solve {t_first:.3f} s; "
          f"host syncs {syncs}; kernel launches {launches}")
    need_launched(launches, ["leaf_ldl_f32"], "reduced, f32 factor")
    if any(launches[n] for n in ["leaf_ldl", "dgemm", "dense_fwd"]
           + linv_names):
        fail(f"reduced, f32 factor: launched an f64 dense kernel: {launches}")
    for r in subst_records:
        if r["name"] == "leaf_ldl_f32":
            r["launches"] = launches[r["name"]]
    again, _ = timed(torch, hs, batch, LANES, reps=2)
    same = torch.equal(hsol.exit_code, again.exit_code) and torch.equal(
        hsol.x, again.x)
    print(f"reduced, f32 factor: a repeated solve gives the same bits: "
          f"{same} (printed, not checked: the f32 products are cuBLAS's)")
    codes, iters, hist = outcome(hsol, "reduced, f32 factor")
    # a lane that claims an answer under the f32 factor must have it
    objectives_close(hsol, banded_pcost, {2: 1e-6, 1: INACC_TOL},
                     "reduced, f32 factor")
    profile_solve(torch, hs, batch)
    tiers_as_cpu(pt, st, probs, shared, f32, hsol, list(range(CPU_LANES)),
                 "reduced, f32 factor")
    del hs, hsol, again
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 12: the banded scan (block bandwidth 9) at a real size
    t_phase = time.perf_counter()
    scan_records = {"leaf_ldl": phase_scan(torch, pt, corpus, kernels, kkt,
                                           leaf, plain, make_band_plan)}
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 13: "banded" with an f32 factor (the scan in f32)
    t_phase = time.perf_counter()
    scan_records["leaf_ldl_f32"] = phase_f32_banded(
        torch, pt, corpus, kernels, kkt, leaf, plain, make_band_plan,
        soc_band_pcost)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 14: the entry points on the card
    t_phase = time.perf_counter()
    phase_entry(torch, pt, probs, shared, st)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # one entry a kernel: the band kernels at the main path's bandwidth 1,
    # with phase 7's bandwidth-3 readings beside them under "bw3", and the
    # leaves with phases 12's and 13's readings under "scan"
    wide = {r["name"]: {k: r[k] for k in order[4:]} for r in wide_records}
    scan = {name: {k: r[k] for k in order[4:]}
            for name, r in scan_records.items()}
    print(json.dumps({"kernels": [
        {k: r[k] for k in order}
        | ({"bw3": wide[r["name"]]} if r["name"] in wide else {})
        | ({"scan": scan[r["name"]]} if r["name"] in scan else {})
        for r in band_records + dense_records + subst_records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
