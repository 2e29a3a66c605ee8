"""Smoke test of eicos_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version on the card, and drives the
port's paths through its entry points:

  1. kernel checks at the paths' shapes (the band factor and sweeps at
     block bandwidth 1, through the 4-d layout, and at block bandwidths 2,
     3 and 6; the blocked dense leaf LDL^T in f64 and f32, dgemm in nine forms, among
     them the recursion's products with their structure flags, its
     machine code checked for DMMA, the two inverse-solve passes, the
     substitution pack and its two sweeps; the gather kernel of the
     residual products, fused with each product site's concatenation and
     affine tail, on phase 2's six operands and phase 12's two at 128
     lanes in every site's form, bit for bit against the unfused sequence
     it replaces, timed over back-to-back launches beside the dense
     product and ``torch.sparse``; dgemm as
     K12 on the wide operands of phases 7 and 12, sA, sAT, sGA, sAGT, at
     their lanes and at 128; S2, the loop condition of a composed solve,
     counting a WHILE node's trips as its plain version does on the main
     path's flag shapes, timed in a graph of 65 evaluations);
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
     CUDA events around a solve and around queued f64 products;
 15. ``Settings(block=64)`` on 4 of phase 2's lanes under "reduced" and
     "banded" (the plain leaf by design), lane 0 against the CPU;
 16. ``BatchedSolver(mesh=make_mesh())`` on phase 2's batch over the
     visible cards, the same bits as the unsharded solve.
 17. repeated solves: phase 2's and phase 6's ``BatchedSolver`` (with
     rescue) solve a batch X, then, after ``update_data`` with every value
     new (each row of G and h, and of A and b, scaled by a positive
     factor, one a cone; c moved), Y, then X five times; phase 3's forced
     rescue twice, with 5 and then 7 failing lanes (both padded to 8);
     phase 10's ``Solver(G, A, c, h, b)`` through ``update_data``; phases
     12 and 16 repeated.  Every solve after a solver's first captures no
     graph, calls no segment eagerly, is one composed launch a program
     with no host sync, and gives the bits of a fresh solver's solve of
     its data and, settled, its launch counts, each of its loop tests an
     S2 launch; the first result is unchanged at the end.  First and
     repeated solves/s, host launch calls, idle share, the composition's
     cost and the memory held between solves are printed.

Every solve runs as captured CUDA graphs (``eicos_tpu_torch.graphs``):
a solver object's first solve captures its program and composes it into
one graph with the loops as conditional WHILE nodes; every later solve of
it is one launch of that graph with the new values copied in.  Every
driven first solve of phases 2-13, 15 and 16 is held to the same solve
with its segments called eagerly (``same_bits_eager``: exit codes,
iterations, x, y, z, launch counts and host syncs), with each one's
captures, replays, capture time and peak device memory printed, and the
solver's next solve, composed, to the first (``same_composed``: bits, 0
host syncs, the settled counts, the composition's time and memory);
phases 2 and 6 compare the three in one call (eager, composed,
host-driven, host-driven, composed, eager: solves/s, idle share, host
launch calls).  Each phase releases its solvers' programs before the
next one starts.

Phases 6, 7 and 12 must launch their band (12: leaf) kernels, match the
CPU plain path on lane 0, repeat bit for bit, and end every lane OPTIMAL;
lanes that do not must end with the same code on the CPU plain path.
Phases 2, 6, 7 and 12 must launch the gather kernel (their residual,
elimination and computeResiduals products), 7 and 12 also dgemm (their
wide operands), give the bits of a solve through the unfused sequence
(the gather kernel, then the product sites' torch ops), and print their
sweep pairs, host syncs and product time before the gates.

    python3 chip_smoke.py

Needs one CUDA device and nvcc.  Prints the card (``nvidia-smi`` name and
power limit), the build time, each kernel's error and timing, each phase's
outcome, a JSON line of per-kernel numbers, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.
"""

import contextlib
import gc
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
SPMV_TOL = 1e-14                  # gather kernel vs plain, max relative
SPMV_RECORD = ("sGA", 2)          # the record's headline: refinement's
#                                   fused [z | y] @ [G; A], two columns
WIDE_RECORD = ("phase 7", "sGA", WIDE_LANES, 2)   # K12's: phase 7's stack
BLOCK64_LANES = 4                 # phase 15: Settings(block=64)


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


def spmv_cases(torch, corpus, kkt):
    """The operands the gather kernel gets on the paths: phase 2's six
    (sG, sGT, sA, sAT and the stacks sGA, sAGT) and phase 12's sG, sGT,
    with the dense matrix each replaces, from the raw G and A, and where
    the sites split the contraction input (sGA: [z | y] at m) and the
    output (sAGT: [y | z] at p); the other operands split at a third."""
    out = []
    for label, kw, keys in (
            ("phase 2", dict(horizon=HORIZON, nx=NX, nu=NU, seed=3),
             ("sG", "sGT", "sA", "sAT", "sGA", "sAGT")),
            ("phase 12", SCAN, ("sG", "sGT"))):
        st, base = corpus.make_mpc_like(**kw)
        st = st.with_gsplit(base.G, base.A)
        G = torch.tensor(base.G, device="cuda")
        A = torch.tensor(base.A, device="cuda")
        dense = dict(sG=G, sGT=G.T, sA=A, sAT=A.T,
                     sGA=torch.cat([G, A]), sAGT=torch.cat([A.T, G.T], 1))
        ops = kkt.make_sliced(st, G, A, st.m)
        for key in keys:
            op = ops[key]
            km0 = st.m if key == "sGA" else op.km // 3
            split = st.p if key == "sAGT" else op.nm // 3
            out.append((label, key, op, dense[key].contiguous(), km0, split))
        del G, A, ops, dense
    return out


def loop_ms(torch, fn, n=20, reps=5):
    """Device time of one call of ``fn`` in ms: CUDA events around ``n``
    back-to-back calls, divided by ``n``, median of ``reps``; and the
    host's time to queue one call, in ms.  The stream first spins
    (``torch.cuda._sleep``) for longer than the host takes to queue the
    ``n`` calls, so the device runs them back to back and the events read
    the device, not the host's launch path, while the host's clock reads
    the launch path alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(max(3 * host, 1e-3), 0.5) * 2.0e9)
    times, queue = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queue.append((time.perf_counter() - t0) * 1e3 / n)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return float(np.median(times)), float(np.median(queue))


SPMV_FORMS = ("product", "rx", "elim", "elim_t", "ex", "eyz", "ryz")
# the spmv record's keys beyond the common ones: the residual's fused form
# "ex" and the sequence it replaces (device and host time a call, and the
# bound with the epilogue's bytes), the dense product, and the profiler's
# device time a launch in phase 2's solve
SPMV_EXTRA = ("fused_ms", "unfused_ms", "fused_bound_ms", "fused_host_ms",
              "unfused_host_ms", "dense_ms", "solve_ms_a_launch")


def spmv_form(torch, form, a, nm, km0, split, rnd, delta=3e-8):
    """One epilogue form of the fused call, as a product site calls it,
    on the input ``a`` (L, k, km) (two-segment forms take its two views
    split at ``km0``, as [z | y]; split forms split the output at
    ``split``, as [y | z]): the fused call's keywords (``a`` the first
    segment) and the sequence it replaces, given ``K``, the kernel with no
    epilogue on the concatenation: K, then the site's torch ops as they
    ran before the fusion.  Bases and x are strided views of one
    right-hand side, as at the sites."""
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


def epilogue_reads(kw, nm):
    """Output-shaped inputs the epilogue reads, in columns a row."""
    split = kw.get("split")
    cols = 0
    for name in ("base", "w", "x"):
        v = kw.get(name)
        if isinstance(v, tuple):
            cols += sum(c for t, c in zip(v, (split, nm - split))
                        if t is not None)
        elif v is not None:
            cols += nm
    return cols


def bits_equal(torch, a, b):
    """Bit for bit, signed zeros included."""
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


def check_spmv_kernel(torch, corpus, kkt, spmv):
    """The gather kernel (``csrc/spmv.cu``, one launch a fused product) on
    the paths' operands at 128 lanes and k = 1, 2, in every epilogue form
    of the product sites (``SPMV_FORMS``): within ``SPMV_TOL`` of its
    plain version (``rmatmul_plain``, the JAX package's width-grouped
    gather, then ``spmv.fused_tail``), and bit for bit equal to the
    sequence it replaces (the kernel with no epilogue, then the site's
    torch ops) and to its repeat.  ``elim_t`` sets a tenth of its base to
    the product, so those zeros carry acc - base's sign.  Times by
    ``loop_ms``: the product, its plain version, the dense
    ``torch.matmul`` it replaces
    and ``torch.sparse`` CSR @ on the same operand; each fused form beside
    the sequence it replaces.  Returns its record (the headline:
    ``SPMV_RECORD``, the product and the residual's fused form "ex")."""
    record = None
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(11)
    for label, key, op, M, km0, split in spmv_cases(torch, corpus, kkt):
        if not isinstance(op, spmv.SparseOperand):
            fail(f"spmv: {label} {key} is not a gather operand")
        csr = M.T.to_sparse_csr()
        nnz = op.rows.numel()
        table = nnz * 12 + (op.nm + 1) * 4

        def K(a):
            return spmv.spmv(a.contiguous(), op.colptr, op.rows, op.vals,
                             op.nm)

        for k in (1, 2):
            rows = LANES * k

            def rnd(cols):
                return torch.randn(LANES, k, cols, generator=gen,
                                   device="cuda", dtype=torch.float64)

            a = rnd(op.km)
            head = (key, k) == SPMV_RECORD and label == "phase 2"
            fused = {}
            for form in SPMV_FORMS:
                kw, seq = spmv_form(torch, form, a, op.nm, km0, split, rnd)
                if form == "elim_t":
                    kw["base"][..., ::10] = K(a)[..., ::10]
                first = kw.pop("a")
                tail = {n: v for n, v in kw.items() if n != "a2"}
                want = spmv.fused_tail(op.rmatmul_plain(a), **tail)
                got = op.rmatmul_fused(first, **kw)
                again = op.rmatmul_fused(first, **kw)
                old = seq(K)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                worst = max(worst, err)
                if not (bits_equal(torch, got, old)
                        and bits_equal(torch, got, again)):
                    fail(f"spmv {label} {key} k={k} {form}: the fused call's "
                         f"bits differ from the sequence it replaces or from "
                         f"its repeat")
                if form == "elim_t" and not bool((got[..., ::10] == 0).all()):
                    fail(f"spmv {label} {key} k={k}: acc - base gave no zero")
                if form != "product":
                    fused[form] = (
                        *loop_ms(torch, lambda: op.rmatmul_fused(first, **kw)),
                        *loop_ms(torch, lambda: seq(K), reps=3),
                        bound(rows * (op.km + op.nm
                                      + epilogue_reads(kw, op.nm)) * 8
                              + table, 2 * nnz * rows)[0], err)
                    continue
                at = a.reshape(rows, op.km).T.contiguous()
                times = dict(
                    ms=loop_ms(torch, lambda: op.rmatmul(a))[0],
                    plain_ms=loop_ms(torch, lambda: op.rmatmul_plain(a),
                                     reps=3)[0],
                    dense_ms=loop_ms(torch, lambda: torch.matmul(a, M),
                                     reps=3)[0],
                    library_ms=loop_ms(torch, lambda: torch.sparse.mm(
                        csr, at), reps=3)[0])
                b_ms, b_by = bound(rows * (op.km + op.nm) * 8 + table,
                                   2 * nnz * rows)
                print(f"spmv {label} {key}: ({LANES}, {k}, {op.km}) @ "
                      f"({op.km}, {op.nm}), {nnz} nonzeros, W {op.W}: "
                      + ", ".join(f"{n} {v:.4f}" for n, v in times.items())
                      + f"; bound {b_ms:.5f} ms by {b_by} "
                      f"({b_ms / times['ms']:.1%} of ms); rel err {err:.2e}")
                if head:
                    record = dict(
                        name="spmv", route="cuda",
                        source="eicos_tpu_torch/csrc/spmv.cu",
                        replaces="eicos_tpu/ops/spmv.py:114 (SparseOperand."
                                 "rmatmul, an XLA gather: no Pallas kernel)",
                        launches=0,
                        max_abs_err=float((got - want).abs().max()),
                        ms=times["ms"], plain_ms=times["plain_ms"],
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=times["library_ms"],
                        dense_ms=times["dense_ms"])
                del at
            print(f"spmv {label} {key} k={k}, fused forms (device ms, host "
                  f"ms a call; the sequence it replaces, the same; bound "
                  f"with the epilogue's bytes, ms; rel err): " + "; ".join(
                      f"{f} {v[0]:.4f}, {v[1]:.4f}; {v[2]:.4f}, {v[3]:.4f}; "
                      f"{v[4]:.5f}; {v[5]:.1e}" for f, v in fused.items()))
            if head:
                f_ms, f_host, s_ms, s_host, fb_ms, _ = fused["ex"]
                record.update(fused_ms=f_ms, unfused_ms=s_ms,
                              fused_bound_ms=fb_ms, fused_host_ms=f_host,
                              unfused_host_ms=s_host)
            del a, want, got, again, old
        del csr
    print(f"spmv: max rel err vs plain over every case and form {worst:.3e} "
          f"(tolerance {SPMV_TOL}); every fused call bit-equal to the "
          f"sequence it replaces and to its repeat")
    if not worst <= SPMV_TOL:
        fail("spmv: the gather kernel disagrees with its plain version")
    torch.cuda.empty_cache()
    return record


def check_wide_operands(torch, corpus, kkt, gemm, kernels):
    """K12 as the solves of phases 7 and 12 use it: ``kkt.WideOperand``
    (dgemm with a shared right operand, the lanes folded into its rows) on
    the operands ``kkt.make_sliced`` builds there, sA, sAT (a strided
    transpose), sGA and sAGT, at the path's lanes and at 128, k = 1, 2,
    against ``gemm.matmul_plain``, with times and bounds.  Returns the
    record of ``WIDE_RECORD`` (launches filled in later)."""
    record = None
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(12)
    for label, kw, lanes in (("phase 7", WIDE, WIDE_LANES),
                             ("phase 12", SCAN, SCAN_LANES)):
        st, base = corpus.make_mpc_like(**kw)
        st = st.with_gsplit(base.G, base.A)
        G = torch.tensor(base.G, device="cuda")
        A = torch.tensor(base.A, device="cuda")
        ops = kkt.make_sliced(st, G, A, st.m)
        for key in ("sA", "sAT", "sGA", "sAGT"):
            op = ops[key]
            if not isinstance(op, kkt.WideOperand):
                fail(f"K12: {label} {key} is not a wide operand")
            km, nm = op.bmat.shape
            for ln, k in ((lanes, 1), (lanes, 2), (LANES, 1), (LANES, 2)):
                a = torch.randn(ln, k, km, generator=gen, device="cuda",
                                dtype=torch.float64)
                before = kernels.COUNTS["dgemm"]
                got = op.rmatmul(a)
                if kernels.COUNTS["dgemm"] != before + 1:
                    fail(f"K12: {label} {key} did not launch dgemm once")
                want = gemm.matmul_plain(a, op.bmat)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                worst = max(worst, err)
                rows = ln * k
                times = dict(
                    ms=cuda_ms(lambda: op.rmatmul(a)),
                    plain_ms=cuda_ms(lambda: gemm.matmul_plain(a, op.bmat)),
                    library_ms=cuda_ms(lambda: torch.matmul(a, op.bmat)))
                b_ms, b_by = bound(8 * (rows * km + km * nm + rows * nm),
                                   2 * rows * km * nm)
                print(f"K12 {label} {key}: ({ln}, {k}, {km}) @ ({km}, {nm}), "
                      f"strides {op.bmat.stride()}: "
                      + ", ".join(f"{n} {v:.4f}" for n, v in times.items())
                      + f"; bound {b_ms:.4f} ms by {b_by} "
                      f"({100 * b_ms / times['ms']:.1f} %); rel err "
                      f"{err:.2e}")
                if (label, key, ln, k) == WIDE_RECORD:
                    record = dict(
                        launches=0,
                        max_abs_err=float((got - want).abs().max()),
                        ms=times["ms"], plain_ms=times["plain_ms"],
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=times["library_ms"])
                del a, got, want
        del G, A, ops
    print(f"K12: max rel err vs plain over every wide operand {worst:.3e} "
          f"(tolerance {KERNEL_TOL})")
    if not worst <= KERNEL_TOL:
        fail("K12: dgemm on a wide operand disagrees with its plain version")
    torch.cuda.empty_cache()
    return record


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


def fill_graph(torch, flags):
    """A captured graph, kept for composing, that sets every flag true."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        flags.fill_(True)
    return g


def loop_graph(torch, flags, trips, pre, body_graph):
    """S2 on ``flags`` (counted at ``trips[0]``), then a WHILE node whose
    body is ``body_graph`` and S2 again (``trips[1]``); ``pre`` more S2
    nodes before them, all on one handle.  Instantiated."""
    from eicos_tpu_torch.ops.graph_loop import LoopGraph

    lg = LoopGraph(flags.device)
    try:
        h = lg.handle(lg.root)
        dep = None
        for _ in range(pre + 1):
            dep = lg.cond(lg.root, dep, h, flags, trips, 0)
        _, body = lg.while_(lg.root, dep, h)
        last = lg.child(body, None, body_graph.raw_cuda_graph())
        lg.cond(body, last, h, flags, trips, 1)
        lg.instantiate()
    except BaseException:
        lg.close()
        raise
    return lg


def check_loop_cond(torch):
    """S2 (``loop_cond``) against ``loop_cond_plain`` on the main path's
    flag shapes, (128,) the lanes' done, (128, 2) and (128, 1) the
    refinement columns', each all true, with one entry false and with
    random entries: a graph of S2, then WHILE { set every flag true; S2 }
    must count the trips the plain version counts (1 and "not all").
    Timed: a graph of 64 S2 nodes in a row and a WHILE whose flags are
    all true, 20 launches back to back (``loop_ms``), a 65th of a launch
    an evaluation; the plain version (``~t.all()`` and the counter's
    increment as torch ops, without the read back) by the same loop."""
    from eicos_tpu_torch.ops.graph_loop import loop_cond_plain

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(17)
    err = 0
    for shape in ((LANES,), (LANES, 2), (LANES, 1)):
        for pattern in ("all", "one", "random"):
            f = np.ones(shape, bool)
            if pattern == "one":
                f.flat[int(rng.integers(f.size))] = False
            elif pattern == "random":
                f = rng.random(shape) < 0.9
            flags = torch.tensor(f, device=dev)
            trips = torch.zeros(2, dtype=torch.int64, device=dev)
            lg = loop_graph(torch, flags, trips, 0, fill_graph(torch, flags))
            try:
                lg.launch()
                torch.cuda.synchronize()
            finally:
                lg.close()
            plain = torch.zeros(2, dtype=torch.int64)
            pf = torch.tensor(f)
            if loop_cond_plain(pf, plain, 0):
                pf.fill_(True)
                loop_cond_plain(pf, plain, 1)
            err = max(err, int((trips.cpu() - plain).abs().max()))
    flags = torch.ones(LANES, 2, dtype=torch.bool, device=dev)
    trips = torch.zeros(2, dtype=torch.int64, device=dev)
    lg = loop_graph(torch, flags, trips, 63, fill_graph(torch, flags))
    try:
        launch_ms, _ = loop_ms(torch, lg.launch)
    finally:
        lg.close()
    torch.cuda.synchronize()
    ms = launch_ms / 65
    plain_ms, _ = loop_ms(torch, lambda: loop_cond_plain(flags, trips, 0))
    bound_ms, by = bound(flags.numel() + 16, flags.numel())
    print(f"loop_cond (S2): trip counts against the plain version on 9 flag "
          f"tensors, max abs error {err}; {ms * 1e3:.2f} us an evaluation "
          f"({launch_ms:.4f} ms a launch of 65), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.2e} ms ({by})")
    if err:
        fail(f"loop_cond disagrees with its plain version by {err} trips")
    return dict(name="loop_cond", route="cuda",
                source="eicos_tpu_torch/csrc/graph_loop.cu",
                replaces="eicos_tpu/solver.py:635 (lax.while_loop's "
                "condition, no Pallas kernel; kkt.py:1205, :1246)",
                launches=None, max_abs_err=float(err), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None)


def stamp_graph(torch, flags, trips, body_graph):
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


def stamp_replay(torch, f, reads, acc):
    """The block that ``loop_stamp_plain`` and the stamped
    ``loop_cond_plain`` make of the launches of ``stamp_graph`` on flags
    ``f``, fed the card's own clock readings: ``reads`` holds ``trips``
    before the first launch and after each.  A launch's start and end are
    its ring entry; its S2 stamps are the start plus the first
    accumulator's growth, and that plus the second's."""
    from eicos_tpu_torch.ops.graph_loop import (END, LAUNCHES, RING,
                                                STAMP_RING, START,
                                                loop_cond_plain,
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


def check_loop_stamp(torch):
    """The stamp kernel (``loop_stamp``) and S2's stamps against
    ``loop_stamp_plain`` and the stamped ``loop_cond_plain`` on the main
    path's flag shapes, as ``check_loop_cond`` sets them, each in
    ``stamp_graph`` launched once; then the lanes' flags all true,
    launched ``STAMP_RING`` + 3 times, the ring never read.  The card's
    block is read after every launch, and the plain versions, fed the
    clock readings the card wrote, must give it cell for cell: the trip
    counters, the last stamp, the launch counter, the overwritten count
    (3 at the end), the stamp nodes' own count (two a launch), the ring
    and the accumulators, whose sum must equal the launches' spans.
    Timed: a graph of 32 (start, end) pairs, 20 launches back to back
    (``loop_ms``), a 64th of a launch a stamp; the plain version on a
    host tensor."""
    from eicos_tpu_torch.ops.graph_loop import (END, LAUNCHES, LoopGraph,
                                                OVERWRITTEN, RING,
                                                STAMP_CELLS, STAMP_RING,
                                                STAMPS, START,
                                                loop_stamp_plain)

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(19)
    block, cases = 2, []
    for shape in ((LANES,), (LANES, 2), (LANES, 1)):
        for pattern in ("all", "one", "random"):
            f = np.ones(shape, bool)
            if pattern == "one":
                f.flat[int(rng.integers(f.size))] = False
            elif pattern == "random":
                f = rng.random(shape) < 0.9
            cases.append((f, 1))
    cases.append((np.ones(LANES, bool), STAMP_RING + 3))
    err = 0
    for f, n in cases:
        flags = torch.tensor(f, device=dev)
        trips = torch.zeros(block + STAMP_CELLS + 3, dtype=torch.int64,
                            device=dev)
        lg, acc = stamp_graph(torch, flags, trips, fill_graph(torch, flags))
        reads = [trips.tolist()]
        try:
            for _ in range(n):
                lg.launch()
                reads.append(trips.tolist())
        finally:
            lg.close()
        got = reads[-1]
        plain = stamp_replay(torch, f, reads, acc).tolist()
        err = max(err, max(abs(a - b) for a, b in zip(got, plain)))
        ends = [block + RING + 2 * ((r[block + LAUNCHES] - 1) % STAMP_RING)
                for r in reads[1:]]
        spans = sum(r[e + 1] - r[e] for r, e in zip(reads[1:], ends))
        want = (n, max(0, n - STAMP_RING), 2 * n, spans)
        have = (got[block + LAUNCHES], got[block + OVERWRITTEN],
                got[block + STAMPS], sum(got[a] for a in acc))
        if have != want:
            fail(f"loop_stamp: (launches, overwritten, stamps, summed "
                 f"accumulators) {have}, want {want}")
    trips = torch.zeros(block + STAMP_CELLS + 1, dtype=torch.int64,
                        device=dev)
    lg = LoopGraph(dev)
    try:
        dep = None
        for _ in range(32):
            dep = lg.stamp(lg.root, dep, trips, block, START)
            dep = lg.stamp(lg.root, dep, trips, block, END,
                           block + STAMP_CELLS)
        lg.instantiate()
        launch_ms, _ = loop_ms(torch, lg.launch)
    finally:
        lg.close()
    torch.cuda.synchronize()
    ms = launch_ms / 64
    host = torch.zeros(block + STAMP_CELLS + 1, dtype=torch.int64)
    t0 = time.perf_counter()
    for k in range(64):
        loop_stamp_plain(host, block, (START, END)[k % 2], k,
                         block + STAMP_CELLS)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 64
    bound_ms, by = bound(6 * 8, 0)
    print(f"loop_stamp: stamp blocks against the plain versions on "
          f"{len(cases)} graphs ({STAMP_RING + 3} launches of the last), "
          f"max abs error {err}; {ms * 1e3:.2f} us a stamp "
          f"({launch_ms:.4f} ms a launch of 64), plain {plain_ms:.4f} ms "
          f"on the host, bound {bound_ms:.2e} ms ({by})")
    if err:
        fail(f"loop_stamp disagrees with its plain versions by {err}")
    return dict(name="loop_stamp", route="cuda",
                source="eicos_tpu_torch/csrc/graph_loop.cu",
                replaces="none (the JAX package times no segment on the "
                "device)",
                launches=None, max_abs_err=float(err), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None)


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


RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cudaLaunchKernelEx", "cudaGraphLaunch", "cuLaunchKernel",
                    "cuLaunchKernelEx", "cuGraphLaunch")
LAST = {}                         # the last ``drive``: graph stats, peaks


def trace_solve(torch, bs, batch, acts):
    """One solve under ``torch.profiler`` with ``acts``, its launch counts
    settled: (wall s, the kernel rows (ms, name, count) by time, the
    runtime's launch rows by name, the port's launches outside graphs,
    segment replays)."""
    from eicos_tpu_torch import graphs
    from eicos_tpu_torch.ops import kernels
    from torch.profiler import profile

    torch.cuda.synchronize()
    kernels.reset_counts()
    graphs.reset_stats()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bs.solve(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graphs.settle()
    graphed = graphs.STATS["graph_counts"]
    # the port's launches outside graphs: eager ones and the warm-ups'
    port_eager = sum(v - graphed.get(k, 0) + graphs.STATS["warm_counts"].get(
        k, 0) for k, v in kernels.COUNTS.items() if k != "factors")
    rows, runtime = [], {}
    for e in prof.key_averages():
        if e.key in RUNTIME_LAUNCHES:
            runtime[e.key] = runtime.get(e.key, 0) + e.count
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
    return wall, rows, runtime, port_eager, graphs.STATS["replays"]


def composes(bs):
    """The solver's next solve is one composed launch: a program of it
    has composed and no ``graphs.host_driven()`` is open."""
    from eicos_tpu_torch import graphs

    return not graphs.is_host_driven() and any(p.loop is not None
                                               for p in programs_of(bs))


def profile_solve(torch, bs, batch, cuda_only=False, label="profile"):
    """Device time by kernel over one solve (torch.profiler), the
    device's idle share of the solve's wall time, the solve's kernel
    launches, all kernels counted, and its host launch calls: the
    runtime's kernel and graph launch rows, plus the port's kernels that
    the host launched outside a graph, which those rows do not see (the
    kernels' libraries link the CUDA runtime statically; ``ab_graphs``
    prints the check).  ``cuda_only`` records the device activity alone:
    a solve of ~10^6 launches (the eager scan) takes minutes of the
    profiler's host-side processing with the CPU's.  A composed solve
    goes to ``profile_composed``.  Returns a dict (``spmv_ms``, the spmv
    kernel's device time a launch, None without a trace; ``busy``,
    ``wall`` in ms, ``idle``, ``kernels``, ``runtime``: the launch rows
    by name, ``port_eager``: the port's launches outside graphs,
    ``host``)."""
    from torch.profiler import ProfilerActivity

    if composes(bs):
        return profile_composed(torch, bs, batch, cuda_only, label)
    acts = [ProfilerActivity.CUDA]
    if not cuda_only:
        acts.insert(0, ProfilerActivity.CPU)
    t_prof = time.perf_counter()
    wall, rows, runtime, port_eager, replays = trace_solve(torch, bs, batch,
                                                           acts)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"{label}: no device time in the trace (not measured)")
        return dict(spmv_ms=None, busy=None, wall=wall * 1e3, idle=None,
                    kernels=None, runtime=runtime, port_eager=port_eager)
    n_kernels = sum(r[2] for r in rows)
    host = sum(runtime.values()) + port_eager
    print(f"{label}: one solve {wall * 1e3:.1f} ms wall, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / (wall * 1e3):.3f}); "
          f"{n_kernels} kernel launches; the profile took "
          f"{time.perf_counter() - t_prof:.1f} s")
    print(f"{label}: host launch calls {host} (runtime rows {runtime}, the "
          f"port's kernels launched outside graphs {port_eager}; {replays} "
          f"segment replays); eager, every kernel a host launch: "
          f"{n_kernels}")
    for ms, key, count in rows[:10]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    per_launch = {}
    for name in ("spmv", "dgemm"):
        mine = [r for r in rows if name in r[1]]
        ms, count = sum(r[0] for r in mine), sum(r[2] for r in mine)
        per_launch[name] = ms / count if count else None
        print(f"  {name} kernels: {ms:.3f} ms in {count} launches"
              + (f", {ms / count * 1e3:.2f} us a launch" if count else ""))
    return dict(spmv_ms=per_launch["spmv"], busy=busy, wall=wall * 1e3,
                idle=1 - busy / (wall * 1e3), kernels=n_kernels,
                runtime=runtime, port_eager=port_eager, host=host)


def profile_composed(torch, bs, batch, cuda_only, label):
    """``profile_solve`` of a composed solve.  CUPTI's kernel tracing
    does not see a conditional node's body reliably (it saw 1,692 of a
    phase-2 solve's ~21,400 kernels, and all of a phase-6 one's in
    another call) and once faulted inside one, so no composed solve is
    traced on the device: the host launch rows come from a trace of the
    host's activity alone, the wall time and the device span (CUDA
    events around the solve) from an unprofiled solve, and the device
    busy time and kernel rows from the same solve's host-driven replay,
    which runs the same kernels but S2's; the idle share is busy over the
    unprofiled composed wall time (derived, printed so)."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    bs.solve(batch)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    span = e0.elapsed_time(e1)
    _, _, runtime, port_eager, replays = trace_solve(
        torch, bs, batch, [ProfilerActivity.CPU])
    host = sum(runtime.values()) + port_eager
    from eicos_tpu_torch import graphs

    with graphs.host_driven():
        out = profile_solve(torch, bs, batch, cuda_only,
                            f"{label}, its host-driven replay traced")
    if out["busy"] is None:
        return dict(out, wall=wall, idle=None, runtime=runtime,
                    port_eager=port_eager, host=host, span=span)
    idle = 1 - out["busy"] / wall
    print(f"{label}: a composed solve {wall:.1f} ms wall, {span:.1f} ms "
          f"device span (events); device busy {out['busy']:.1f} ms (its "
          f"host-driven replay's trace); idle share {idle:.3f} (derived); "
          f"host launch calls {host} (runtime rows {runtime}, the port's "
          f"kernels launched outside graphs {port_eager}; {replays} segment "
          f"runs, settled)")
    return dict(out, wall=wall, idle=idle, runtime=runtime,
                port_eager=port_eager, host=host, span=span)


@contextlib.contextmanager
def eager_segments():
    """Inside the block every segment of a solve calls its function
    eagerly: no graph is captured, replayed, composed or launched."""
    from eicos_tpu_torch import graphs

    real = graphs.Segment.__call__, graphs.Program.compose
    graphs.Segment.__call__ = lambda self, *args: self.fn(*args)
    graphs.Program.compose = lambda self, steps: None
    try:
        with graphs.host_driven():
            yield
    finally:
        graphs.Segment.__call__, graphs.Program.compose = real


def count_factors(kernels, kkt):
    """Wrap ``kkt.factor`` for good to count its calls under "factors" in
    ``kernels.COUNTS``, through ``kernels.count``, so that a captured
    factor counts at every replay of a program kept across solves.  Once
    a run."""
    if getattr(kkt.factor, "counts_factors", False):
        return
    real = kkt.factor

    def counted(*args, **kw):
        kernels.count("factors")
        return real(*args, **kw)

    counted.counts_factors = True
    kernels.COUNTS.setdefault("factors", 0)
    kkt.factor = counted


def drive(torch, kernels, kkt, bs, batch):
    """One solve with every launch count at 0 just before it: returns the
    solution, the counts just after, settled (``graphs.settle``: the
    composed launches' segment runs and S2 launches, read from the card's
    trip counters; the number of factors under "factors",
    ``count_factors``), the host syncs and the wall time.
    ``LAST`` gets the graph stats and the peak device memory of the
    solve."""
    from eicos_tpu_torch import graphs

    count_factors(kernels, kkt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    graphs.reset_stats()
    syncs0 = kkt.host_syncs
    t0 = time.perf_counter()
    sol = bs.solve(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs.settle()
    launches = dict(kernels.COUNTS)
    LAST.clear()
    LAST.update(graphs=dict(graphs.STATS),
                peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                reserved=torch.cuda.max_memory_reserved() / 2 ** 30)
    return sol, launches, kkt.host_syncs - syncs0, wall


def graph_line(label):
    """The graphs' account of the last ``drive``, printed, with the
    memory still reserved once the cache is emptied: what the solvers'
    kept programs hold between solves."""
    g = LAST["graphs"]
    torch = sys.modules["torch"]
    torch.cuda.empty_cache()
    print(f"{label}: graphs: {g['captures']} captures, {g['replays']} "
          f"replays, {g['copies']} input copies, {g['eager']} eager segment "
          f"calls, {g['loops']} composed launches of {g['solves']} program "
          f"solves; capture {g['capture_s']:.3f} s, composing "
          f"{g['compose_s']:.3f} s; peak device memory "
          f"{LAST['peak']:.3f} GiB allocated, {LAST['reserved']:.3f} GiB "
          f"reserved; {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB "
          f"reserved after the solve, the cache emptied (held by the kept "
          f"programs)")
    return dict(LAST)


def same_bits_eager(torch, kernels, kkt, bs, batch, first, launches, syncs,
                    label):
    """The graphed solve ``first`` (its launch counts and host syncs from
    ``drive``) against the same solve with every segment called eagerly:
    the same exit codes, iterations, x, y and z, the same counts and
    syncs.  Prints both solves' captures and peak memory.  Then the
    solver's next solve, composed (``same_composed``), whose counts it
    returns."""
    graphed = graph_line(f"{label}, graphed")
    with eager_segments():
        sol, e_launches, e_syncs, t_e = drive(torch, kernels, kkt, bs, batch)
    graph_line(f"{label}, eager ({t_e:.3f} s)")
    same = all(torch.equal(a, b) for a, b in (
        (first.exit_code, sol.exit_code), (first.info.iter, sol.info.iter),
        (first.x, sol.x), (first.y, sol.y), (first.z, sol.z)))
    print(f"{label}: the graphed solve gives the eager solve's bits: {same}; "
          f"counts equal: {launches == e_launches}; host syncs {syncs} and "
          f"{e_syncs}; captures {graphed['graphs']['captures']}")
    if not same or launches != e_launches or syncs != e_syncs:
        fail(f"{label}: the graphed solve differs from the eager one "
             f"(counts {launches} / {e_launches}, syncs {syncs} / "
             f"{e_syncs})")
    if first.info.iter.max() > 1 and not graphed["graphs"]["captures"]:
        fail(f"{label}: a solve past iteration 1 captured no graph")
    return same_composed(torch, kernels, kkt, bs, batch, first, launches,
                         syncs, label)


def programs_of(bs):
    """The kept programs of a solver (a ``Solver``'s by settings, a
    ``BatchedSolver``'s a device and its rescue's)."""
    progs = bs._programs
    progs = list(progs.values()) if isinstance(progs, dict) else list(progs)
    progs.append(getattr(bs, "_rescue_program", None))
    return [p for p in progs if p is not None]


def loop_line(bs, label):
    """Each composed program's instantiate time and the device memory its
    instantiation took (``cudaMemGetInfo`` before and after), printed."""
    out = []
    for p in programs_of(bs):
        if p.loop is not None:
            out.append((p.loop.instantiate_s, p.loop.held_bytes / 2 ** 20))
    print(f"{label}: composed graphs (instantiate s, MiB on the card): "
          + ", ".join(f"({t:.3f}, {m:.1f})" for t, m in out))
    return out


def composed_only(label, syncs):
    """The last ``drive`` was one composed launch a program solve: no
    capture, no eager call, no host sync; the stamp nodes counted on the
    card two launches a traced composed launch.  Returns the composed
    launches."""
    g = LAST["graphs"]
    print(f"{label}: {g['loops']} composed launches of {g['solves']} program"
          f" solves, {g['replays']} segment runs (settled), {syncs} host "
          f"syncs, {g['captures']} captures, {g['eager']} eager calls")
    if (g["loops"] != g["solves"] or not g["loops"] or syncs
            or g["captures"] or g["eager"]):
        fail(f"{label}: a kept program's solve was not one composed launch "
             f"with no host sync ({g['loops']} launches, {g['solves']} "
             f"solves, {syncs} syncs)")
    from eicos_tpu_torch.utils import timing

    stamps = g["graph_counts"].get("loop_stamp", 0)
    if stamps != 2 * g["loops"] * timing.tracing():
        fail(f"{label}: {stamps} stamp launches for {g['loops']} composed "
             f"launches")
    return g["loops"]


def as_composed(counts, syncs, loops):
    """A host-driven solve's counts as a composed solve of the same data
    in ``loops`` composed launches shows them, settled: each of its loop
    tests an S2 launch, and two stamp launches a traced launch."""
    from eicos_tpu_torch.utils import timing

    return dict(counts, loop_cond=counts.get("loop_cond", 0) + syncs,
                loop_stamp=2 * loops * timing.tracing())


def same_composed(torch, kernels, kkt, bs, batch, first, launches, syncs,
                  label):
    """The solver's next solve, one composed launch a program, against its
    host-driven first solve ``first`` (its counts and syncs from
    ``drive``): the same bits, 0 host syncs, and the first's counts once
    settled, each loop test an S2 launch.  Prints the composition's cost;
    returns the composed solve's counts."""
    sol, c_launches, c_syncs, wall = drive(torch, kernels, kkt, bs, batch)
    loops = composed_only(f"{label}, composed", c_syncs)
    loop_line(bs, label)
    same = all(torch.equal(a, b) for a, b in (
        (first.exit_code, sol.exit_code), (first.info.iter, sol.info.iter),
        (first.x, sol.x), (first.y, sol.y), (first.z, sol.z)))
    want = as_composed(launches, syncs, loops)
    print(f"{label}: the composed solve ({wall:.3f} s) gives the host-driven "
          f"solve's bits: {same}; settled counts equal: {c_launches == want}"
          f"; S2 launches {c_launches['loop_cond']}, host syncs {syncs} "
          f"before")
    if not same or c_launches != want:
        fail(f"{label}: the composed solve differs from the host-driven one "
             f"(counts {c_launches} / {want})")
    return c_launches


AB_MODES = ("eager", "composed", "host-driven", "host-driven", "composed",
            "eager")


def ab_graphs(torch, bs, batch, lanes, label):
    """Eager, composed, host-driven, host-driven, composed, eager in one
    call (``AB_MODES``; host-driven: the segments' graphs replayed from
    the host loop, a kept program's solve before composing): solves/s
    (median of 5 after a warm solve), the idle share of a profiled solve
    (the device traced alone: the runtime's launch rows come with it) and
    the host launch calls of each, with the composition's instantiate
    time and memory.  Returns the readings."""
    from eicos_tpu_torch import graphs

    out = []
    composed = loop_line(bs, f"{label}, A/B")
    for mode in AB_MODES:
        ctx = {"eager": eager_segments, "host-driven": graphs.host_driven}.get(
            mode, contextlib.nullcontext)()
        with ctx:
            bs.solve(batch)
            _, rate = timed(torch, bs, batch, lanes, reps=5)
            prof = profile_solve(torch, bs, batch, cuda_only=True,
                                 label=f"{label}, A/B {mode}")
        if prof["kernels"] is None:
            fail(f"{label}: the A/B profile has no device time")
        if mode == "eager":
            # every device event of an eager solve is one launch (or a
            # copy): the rows alone fall short of them by the port's
            print(f"{label}, A/B eager: {sum(prof['runtime'].values())} "
                  f"runtime launch rows + {prof['port_eager']} port "
                  f"launches against {prof['kernels']} device events")
        out.append((mode, rate, prof))
    print(f"{label}, A/B in one call: " + "; ".join(
        f"{m} {r:.2f} solves/s, idle {p['idle']:.3f}, {p['kernels']} device "
        f"events, {p['host']} host launch calls" for m, r, p in out)
        + f"; composed graph instantiated in {composed[0][0]:.3f} s, "
        f"{composed[0][1]:.1f} MiB")
    return out


def timed(torch, bs, batch, lanes, reps=3):
    """Median wall time of ``reps`` solves after the first; prints it and
    returns the last solution and the median solves/s.  The garbage of
    earlier work (a profile's events above all) is collected first, so that
    no collection pass lands inside a timed solve."""
    gc.collect()
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


def same_bits_unfused(torch, bs, batch, first, label):
    """A solve with every fused gather call (``SparseOperand.
    rmatmul_fused``) run as the sequence it replaces, the kernel with no
    epilogue on the concatenated input and then ``spmv.fused_tail``'s torch
    ops, as the product sites ran before the fusion, must give the bits
    of ``first``."""
    from eicos_tpu_torch.ops import spmv

    real = spmv.SparseOperand.rmatmul_fused

    def unfused(self, a, a2=None, base=None, op="add", w=None, gamma=0.0,
                x=None, split=None):
        ab = a if a2 is None else torch.cat([a, a2], -1)
        return spmv.fused_tail(real(self, ab), base, op, w, gamma, x, split)

    # the solver's kept programs replay the fused calls they captured:
    # released before and after, the solve captures the patched ones
    bs.close()
    spmv.SparseOperand.rmatmul_fused = unfused
    try:
        sol = bs.solve(batch)
        torch.cuda.synchronize()
    finally:
        spmv.SparseOperand.rmatmul_fused = real
        bs.close()
    same_bits(torch, first, sol, f"{label}, the unfused sequence's solve")


def outcome(sol, label):
    codes = sol.exit_code.cpu().numpy()
    iters = sol.info.iter.cpu().numpy()
    hist = {int(c): int((codes == c).sum()) for c in np.unique(codes)}
    print(f"{label}: exit codes {hist}; iterations min/median/max "
          f"{iters.min()}/{np.median(iters):g}/{iters.max()}")
    return codes, iters, hist


def print_solve_counts(launches, syncs, label):
    """A solve's sweep pairs (forward and backward band sweeps), host
    syncs, factors and big-product launches, on one line."""
    print(f"{label}: a solve: {launches['band_fwd_bw']} sweep pairs, "
          f"{syncs} host syncs, {launches['factors']} factors, "
          f"{launches['spmv']} spmv and {launches['dgemm']} dgemm launches, "
          f"{sum(v for k, v in launches.items() if k != 'factors')} kernel "
          f"launches in all")


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
             settings, rescue, names, reps=3, cuda_only=False, ab=False):
    """Drive one path of the port at full width: a first solve with the
    launch counts read around it, ``reps`` timed solves and one profiled
    solve (all printed before the gates), the bit-repeat check, the exit
    codes before and after the rescue, every lane OPTIMAL (or as on the
    CPU), lane 0 on the CPU plain path.  The first solve is held to the
    same solve with its segments run eagerly (``same_bits_eager``); ``ab``
    adds the in-call comparison of the two (``ab_graphs``).
    A path that launches the gather kernel also gives the bits of its
    unfused sequence (``same_bits_unfused``).
    Returns the launch counts and the solution of the first solve."""
    lanes = len(probs)
    bs = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue)
    torch.cuda.reset_peak_memory_stats()
    sol, launches, syncs, t_first = drive(torch, kernels, kkt, bs, batch)
    print(f"{label}: first solve {t_first:.3f} s; host syncs {syncs}; kernel "
          f"launches {launches}; rescued lanes {list(bs.last_rescued)}")
    print_solve_counts(launches, syncs, label)
    need_launched(launches, names, label)
    first = sol
    same_bits_eager(torch, kernels, kkt, bs, batch, first, launches, syncs,
                    label)
    if ab:
        ab_graphs(torch, bs, batch, lanes, label)
    sol, _ = timed(torch, bs, batch, lanes, reps)
    profile_solve(torch, bs, batch, cuda_only, label=f"{label}, profile")
    same_bits(torch, first, sol, label)
    if "spmv" in names:
        same_bits_unfused(torch, bs, batch, first, label)
    del first
    if rescue is not None:
        outcome(pt.BatchedSolver(st, settings, shared=shared).solve(batch),
                f"{label}, before the rescue")
        print(f"{label}: last_rescued {list(bs.last_rescued)}")
    outcome(sol, label)
    all_optimal_or_as_cpu(pt, st, probs, shared, settings, rescue, sol, label)
    same_as_cpu(pt, st, probs[0], settings, sol, label)
    bs.close()
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
    import torch

    real = kkt.band_factor
    got = []

    def capture(Kd, Ks, gemm_dtype=None):
        # a graph's capture records the factor and computes nothing: the
        # first calls that compute are the prologue's warm-up (the init
        # factor) and iteration 0's
        if (len(got) < count
                and not torch.cuda.is_current_stream_capturing()):
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
                             batch, shared, settings, None,
                             ["leaf_ldl", "spmv", "dgemm"], reps=1,
                             cuda_only=True)
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
    same_bits_eager(torch, kernels, kkt, gs, batch, gsol, launches, syncs,
                    "scan band, band_gemm f32")
    scan_launches(launches, "leaf_ldl", nb, "scan band, band_gemm f32")
    codes, _, _ = outcome(gsol, "scan band, band_gemm f32")
    short = [int(i) for i in np.flatnonzero(codes != 0)][:SCAN_CPU_LANES]
    tiers_as_cpu(pt, st, probs, shared, g32, gsol, short or [0],
                 "scan band, band_gemm f32")
    gs.close()
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
    same_bits_eager(torch, kernels, kkt, bs, batch, sol, launches, syncs,
                    "banded, f32 factor")
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
    bs.close()
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
    for solver in (one, s, bs):
        solver.close()


def phase_block64(torch, pt, kernels, kkt, make_band_plan, st, probs,
                  shared):
    """Phase 15: ``Settings(block=64)`` on a few of phase 2's lanes, under
    "reduced" (phase 4's strategy) and "banded" with a plan of 64-blocks.
    Off 128 the leaf is the plain one on every device, as in the JAX
    package, so no leaf kernel launches (printed); "reduced" runs dgemm
    and the inverse solves on a factor padded to 128, "banded" the scan.
    Every lane OPTIMAL, lane 0 against the CPU plain path."""
    base = probs[0]
    st64 = st.with_band_plan(make_band_plan(st, base.G, base.A, block=64))
    batch = pt.BatchedSolver.stack(probs[:BLOCK64_LANES], shared=shared)
    for label, cfg, pst, must in (
            ("reduced, block 64",
             pt.Settings(kkt_strategy="reduced", block=64), st,
             ["spmv", "dgemm", "linv_fwd", "linv_bwd"]),
            ("banded, block 64", pt.Settings(kkt_strategy="banded",
                                             block=64), st64, ["spmv"])):
        if cfg.kkt_strategy == "banded":
            print(f"{label}: plan Dp={pst.band.dim} nb={pst.band.dim // 64} "
                  f"bwb={pst.band.bwb}")
        bs = pt.BatchedSolver(pst, cfg, shared=shared)
        sol, launches, syncs, t_first = drive(torch, kernels, kkt, bs, batch)
        print(f"{label}: {BLOCK64_LANES} lanes; first solve {t_first:.3f} s; "
              f"host syncs {syncs}; kernel launches {launches}; the leaf is "
              f"plain by design: {launches['leaf_ldl']} leaf_ldl launches")
        need_launched(launches, must, label)
        same_bits_eager(torch, kernels, kkt, bs, batch, sol, launches, syncs,
                        label)
        if launches["leaf_ldl"] or launches["band_factor_bw"]:
            fail(f"{label}: a leaf or band kernel ran off 128: {launches}")
        _, _, hist = outcome(sol, label)
        if hist != {0: BLOCK64_LANES}:
            fail(f"{label}: not every lane OPTIMAL: {hist}")
        same_as_cpu(pt, pst, probs[0], cfg, sol, label)
        bs.close()
        del bs, sol
    torch.cuda.empty_cache()


def phase_mesh(torch, pt, kernels, kkt, make_mesh, st, batch, shared,
               settings, rescue):
    """Phase 16: ``BatchedSolver(mesh=make_mesh())`` on phase 2's batch
    and settings: the lanes split over the visible cards (one here, which
    then solves the whole batch from its thread), the same bits as the
    unsharded solve."""
    mesh = make_mesh()
    print(f"mesh: {len(mesh)} device(s) of {torch.cuda.device_count()} "
          f"visible: {[str(d) for d in mesh]}")
    ms_ = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue,
                           mesh=mesh)
    msol, launches, syncs, t_first = drive(torch, kernels, kkt, ms_, batch)
    print(f"mesh: {LANES} lanes; solve {t_first:.3f} s; host syncs {syncs}; "
          f"rescued lanes {list(ms_.last_rescued)}")
    need_launched(launches, ["band_factor_bw", "spmv"], "mesh")
    same_bits_eager(torch, kernels, kkt, ms_, batch, msol, launches, syncs,
                    "mesh")
    ref = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue).solve(
        batch)
    same_bits(torch, ref, msol, "mesh against the unsharded solve")
    outcome(msol, "mesh")
    ms_.close()
    del ms_, msol, ref
    torch.cuda.empty_cache()


def rescaled(pt, st, batch, seed):
    """``batch`` (shared G, A, h; per-lane c, b) with every value new and
    its feasible set kept: each row of G and h times a factor in [0.5, 2]
    (one factor a cone, so that s stays in its cone), each row of A and b
    too; c moved by 1e-2 of a normal draw."""
    rng = np.random.default_rng(seed)
    rg = rng.uniform(0.5, 2.0, st.m)
    off = st.l
    for q in st.q:
        rg[off:off + q] = rg[off]
        off += q
    ra = rng.uniform(0.5, 2.0, st.p)
    c = np.asarray(batch.c)
    return pt.ProblemData(
        G=rg[:, None] * np.asarray(batch.G),
        A=ra[:, None] * np.asarray(batch.A), h=rg * np.asarray(batch.h),
        b=ra * np.asarray(batch.b), c=c + 0.01 * rng.standard_normal(c.shape))


def same_solve(torch, got, want, label, counts=None, syncs=None,
               loops=None):
    """``got`` must have ``want``'s bits (exit codes, iterations, x, y, z)
    and, where given the (got, want) launch counts and host syncs of a
    composed solve ``got`` in ``loops`` composed launches and a fresh
    host-driven ``want``, 0 host syncs and ``want``'s counts with each of
    its loop tests an S2 launch and two stamps a traced launch."""
    same = all(torch.equal(a, b) for a, b in (
        (got.exit_code, want.exit_code), (got.info.iter, want.info.iter),
        (got.x, want.x), (got.y, want.y), (got.z, want.z)))
    equal = counts is not None and counts[0] == as_composed(
        counts[1], syncs[1], loops)
    ok = counts is None or (syncs[0] == 0 and equal)
    print(f"{label}: a fresh solve's bits: {same}"
          + ("" if counts is None else f"; settled counts equal: {equal}; "
             f"host syncs "
             f"{syncs[0]} (the fresh solve {syncs[1]}); S2 launches "
             f"{counts[0].get('loop_cond')}"))
    if not same or not ok:
        fail(f"{label}: the solve differs from a fresh solve of its data")


def held_memory(torch):
    """(allocated, reserved) GiB once the cache is emptied: what the live
    solvers hold between solves."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_allocated() / 2 ** 30,
            torch.cuda.memory_reserved() / 2 ** 30)


def first_rates(torch, make, batch, lanes, reps):
    """Solves/s of ``reps`` new solvers' first solves (median; garbage
    collected before each), each solver released after."""
    times = []
    for _ in range(reps):
        bs = make()
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bs.solve(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bs.close()
    return lanes / float(np.median(times)), times


def repeat_batched(torch, pt, kernels, kkt, label, st, batch, shared,
                   settings, rescue, lanes):
    """Phase 17 on one ``BatchedSolver``: X, then Y after ``update_data``
    with every value new, then X five times; every solve after the first
    is one composed launch with no host sync and gives a fresh solve's
    bits and, settled, its counts; the first result is the caller's.
    Prints first and repeated solves/s, host launch calls, idle share,
    the composition's cost and memory; returns them."""
    from eicos_tpu_torch import graphs

    def make():
        return pt.BatchedSolver(st, settings, shared=shared, rescue=rescue)

    bs = make()
    first, f_counts, f_syncs, t_first = drive(torch, kernels, kkt, bs, batch)
    first_graphs = dict(LAST)
    composed = loop_line(bs, label)
    kept = graphs.clone(first)
    y = rescaled(pt, st, batch, seed=23)
    bs.update_data(**{f: getattr(y, f) for f in ("G", "A", "c", "h", "b")})
    ysol, y_counts, y_syncs, _ = drive(torch, kernels, kkt, bs, None)
    y_loops = composed_only(f"{label}, Y after update_data", y_syncs)
    outcome(ysol, f"{label}, Y")
    fresh = make()
    want, w_counts, w_syncs, _ = drive(torch, kernels, kkt, fresh, y)
    fresh.close()
    del fresh
    same_solve(torch, ysol, want, f"{label}, Y", (y_counts, w_counts),
               (y_syncs, w_syncs), y_loops)
    del ysol, want
    gc.collect()
    walls, peaks = [], []
    for i in range(5):
        sol, counts, syncs, wall = drive(torch, kernels, kkt, bs, batch)
        loops = composed_only(f"{label}, X again ({i + 1})", syncs)
        same_solve(torch, sol, first, f"{label}, X again ({i + 1})",
                   (counts, f_counts), (syncs, f_syncs), loops)
        walls.append(wall)
        peaks.append((LAST["peak"], LAST["reserved"]))
    same_solve(torch, first, kept, f"{label}, the first result at the end")
    rep_rate = lanes / float(np.median(walls))
    held = held_memory(torch)
    prof_rep = profile_solve(torch, bs, batch, cuda_only=True,
                             label=f"{label}, repeated solve, profile")
    fresh = make()
    prof_first = profile_solve(torch, fresh, batch, cuda_only=True,
                               label=f"{label}, first solve, profile")
    fresh.close()
    del fresh
    first_rate, first_times = first_rates(torch, make, batch, lanes, 5)
    bs.close()
    released = held_memory(torch)
    out = dict(first_rate=first_rate, rep_rate=rep_rate,
               first_host=prof_first["host"], rep_host=prof_rep["host"],
               first_idle=prof_first["idle"], rep_idle=prof_rep["idle"],
               capture_s=first_graphs["graphs"]["capture_s"],
               captures=first_graphs["graphs"]["captures"],
               compose_s=first_graphs["graphs"]["compose_s"],
               composed=composed,
               first_peak=(first_graphs["peak"], first_graphs["reserved"]),
               rep_peak=max(peaks), held=held, released=released)
    print(f"{label}: solves/s first {first_rate:.2f} (times {first_times}), "
          f"repeated {rep_rate:.2f} (walls {walls}); host launch calls a "
          f"solve first {out['first_host']}, repeated {out['rep_host']}; "
          f"idle share first {out['first_idle']:.3f}, repeated "
          f"{out['rep_idle']:.3f}; the first solve captured {out['captures']}"
          f" graphs in {out['capture_s']:.3f} s and composed them in "
          f"{out['compose_s']:.3f} s (instantiate s, MiB: {composed}); peak "
          f"GiB (allocated, "
          f"reserved) first {out['first_peak'][0]:.3f}, "
          f"{out['first_peak'][1]:.3f}, repeated {out['rep_peak'][0]:.3f}, "
          f"{out['rep_peak'][1]:.3f}; held between solves {held[0]:.3f}, "
          f"{held[1]:.3f}; after close() {released[0]:.3f}, "
          f"{released[1]:.3f}")
    return out


def phase_repeat(torch, pt, corpus, kernels, kkt, make_band_plan, make_mesh,
                 st, probs, batch, shared, settings, rescue):
    """Phase 17: repeated solves through kept programs (module doc)."""
    from eicos_tpu_torch import graphs

    t0 = time.perf_counter()
    lp = repeat_batched(torch, pt, kernels, kkt, "repeat, phase 2", st, batch,
                        shared, settings, rescue, LANES)
    print(f"repeat, phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kst, _, kbatch, kshared = build_socp_batch(pt, corpus, LANES,
                                               make_band_plan)
    soc = repeat_batched(torch, pt, kernels, kkt, "repeat, phase 6", kst,
                         kbatch, kshared, settings, rescue, LANES)
    del kbatch
    print(f"repeat, phase 6: {time.perf_counter() - t0:.1f} s")

    # phase 3's forced rescue with 5, then 7 failing lanes: both pad to 8
    t0 = time.perf_counter()
    forced = pt.Settings(kkt_strategy="banded", iter_max=3)
    fs = pt.BatchedSolver(st, forced, shared=shared, rescue=rescue)
    five = pt.BatchedSolver.stack(probs[:5], shared=shared)
    seven = pt.BatchedSolver.stack(probs[5:12], shared=shared)
    drive(torch, kernels, kkt, fs, five)
    rprog = fs._rescue_program
    caps = rprog.captures
    print(f"repeat, forced rescue of 5: rescued {list(fs.last_rescued)}; "
          f"the rescue program captured {caps} graphs for "
          f"{rprog.inputs[2].shape[0]} lanes")
    rsol, r_counts, r_syncs, _ = drive(torch, kernels, kkt, fs, seven)
    print(f"repeat, forced rescue of 7: rescued {list(fs.last_rescued)}; "
          f"the same rescue program: {fs._rescue_program is rprog}, "
          f"{rprog.captures - caps} new captures")
    if (fs.last_rescued != tuple(range(7)) or fs._rescue_program is not rprog
            or rprog.captures != caps):
        fail("repeat, forced rescue: the second rescue did not replay the "
             "first one's padded program")
    _, _, hist = outcome(rsol, "repeat, forced rescue of 7")
    if hist != {0: 7}:
        fail(f"repeat, forced rescue of 7: not every lane OPTIMAL: {hist}")
    # the primary's program was new at 7 lanes; the rescue's launched its
    # composed graph
    print(f"repeat, forced rescue of 7: {LAST['graphs']['loops']} composed "
          f"launch (the rescue's) of {LAST['graphs']['solves']} solves")
    if LAST["graphs"]["loops"] != 1:
        fail("repeat, forced rescue of 7: the rescue's kept program did not "
             "launch its composed graph")
    rsol, r_counts, r_syncs, _ = drive(torch, kernels, kkt, fs, seven)
    r_loops = composed_only("repeat, forced rescue of 7 again", r_syncs)
    fresh = pt.BatchedSolver(st, forced, shared=shared, rescue=rescue)
    want, w_counts, w_syncs, _ = drive(torch, kernels, kkt, fresh, seven)
    same_solve(torch, rsol, want, "repeat, forced rescue of 7",
               (r_counts, w_counts), (r_syncs, w_syncs), r_loops)
    fresh.close()
    fs.close()
    del fresh, fs, rsol, want
    print(f"repeat, forced rescue: {time.perf_counter() - t0:.1f} s")

    # phase 10's Solver at the default settings ("full") on lane 0
    t0 = time.perf_counter()
    p0 = probs[0]
    one = pt.Solver(p0.G, p0.A, p0.c, p0.h, p0.b)
    drive(torch, kernels, kkt, one, False)
    y = rescaled(pt, st, pt.ProblemData(G=p0.G, A=p0.A, c=p0.c[None],
                                        h=p0.h, b=p0.b[None]), seed=29)
    new = dict(G=y.G, A=y.A, c=y.c[0], h=y.h, b=y.b[0])
    one.update_data(**new)
    code, counts, syncs, wall = drive(torch, kernels, kkt, one, False)
    loops = composed_only("repeat, Solver (full) after update_data", syncs)
    other = pt.Solver(**new)
    _, w_counts, w_syncs, w_wall = drive(torch, kernels, kkt, other, False)
    print(f"repeat, Solver (full): code {int(code)}; re-solve {wall:.3f} s, "
          f"a new Solver's first solve {w_wall:.3f} s")
    same_solve(torch, one.last_solution, other.last_solution,
               "repeat, Solver (full)", (counts, w_counts),
               (syncs, w_syncs), loops)
    one.close()
    other.close()
    del one, other
    print(f"repeat, Solver: {time.perf_counter() - t0:.1f} s")

    # phase 12: the scan
    t0 = time.perf_counter()
    sst, _, sbatch, sshared = build_scan_batch(pt, corpus, make_band_plan)
    ss = pt.BatchedSolver(sst, settings, shared=sshared)
    sfirst, s_counts, s_syncs, s_first = drive(torch, kernels, kkt, ss,
                                               sbatch)
    s_caps = LAST["graphs"]["captures"]
    s_cap_s = LAST["graphs"]["capture_s"]
    ssol, counts, syncs, _ = drive(torch, kernels, kkt, ss, sbatch)
    loops = composed_only("repeat, scan", syncs)
    same_solve(torch, ssol, sfirst, "repeat, scan", (counts, s_counts),
               (syncs, s_syncs), loops)
    del ssol
    _, s_rate = timed(torch, ss, sbatch, SCAN_LANES, reps=3)
    prof_rep = profile_solve(torch, ss, sbatch, cuda_only=True,
                             label="repeat, scan, repeated solve, profile")
    s_held = held_memory(torch)
    ss.close()
    fresh = pt.BatchedSolver(sst, settings, shared=sshared)
    prof_first = profile_solve(torch, fresh, sbatch, cuda_only=True,
                               label="repeat, scan, first solve, profile")
    fresh.close()
    del fresh, ss, sbatch, sfirst
    scan = dict(first_rate=SCAN_LANES / s_first, rep_rate=s_rate,
                first_host=prof_first["host"], rep_host=prof_rep["host"],
                first_idle=prof_first["idle"], rep_idle=prof_rep["idle"],
                captures=s_caps, capture_s=s_cap_s, held=s_held)
    print(f"repeat, scan: solves/s first {scan['first_rate']:.2f}, repeated "
          f"{s_rate:.2f}; host launch calls a solve first "
          f"{scan['first_host']}, repeated {scan['rep_host']}; idle share "
          f"first {scan['first_idle']:.3f}, repeated {scan['rep_idle']:.3f}; "
          f"{s_caps} captures in {s_cap_s:.3f} s; held between solves "
          f"{s_held[0]:.3f}, {s_held[1]:.3f} GiB; "
          f"{time.perf_counter() - t0:.1f} s")

    # phase 16: the mesh
    t0 = time.perf_counter()
    ms_ = pt.BatchedSolver(st, settings, shared=shared, rescue=rescue,
                           mesh=make_mesh())
    mfirst, m_counts, m_syncs, _ = drive(torch, kernels, kkt, ms_, batch)
    msol, counts, syncs, _ = drive(torch, kernels, kkt, ms_, batch)
    loops = composed_only("repeat, mesh", syncs)
    same_solve(torch, msol, mfirst, "repeat, mesh", (counts, m_counts),
               (syncs, m_syncs), loops)
    ms_.close()
    del ms_, msol, mfirst
    print(f"repeat, mesh: {time.perf_counter() - t0:.1f} s; graphs.STATS "
          f"after the phase: {graphs.STATS['captures']} captures")
    return dict(lp=lp, soc=soc, scan=scan)


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
    from eicos_tpu_torch.ops import spmv
    from eicos_tpu_torch.parallel import make_mesh
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
    spmv_record = check_spmv_kernel(torch, corpus, kkt, spmv)
    k12_record = check_wide_operands(torch, corpus, kkt, gemm, kernels)
    s2_record = check_loop_cond(torch)
    stamp_record = check_loop_stamp(torch)
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
    print_solve_counts(launches, syncs, "main path")
    need_launched(launches, band_names + ["spmv"], "main path")
    for r in band_records:
        r["launches"] = launches[r["name"]]
    spmv_record["launches"] = launches["spmv"]
    first = sol
    composed = same_bits_eager(torch, kernels, kkt, bs, batch, first,
                               launches, syncs, "main path")
    need_launched(composed, ["loop_cond"], "main path, composed")
    s2_record["launches"] = composed["loop_cond"]
    stamp_record["launches"] = composed["loop_stamp"]
    ab_graphs(torch, bs, batch, LANES, "main path")
    sol, _ = timed(torch, bs, batch, LANES)
    spmv_record["solve_ms_a_launch"] = profile_solve(
        torch, bs, batch, label="main path (phase 2), profile")["spmv_ms"]
    same_bits(torch, first, sol, "main path")
    same_bits_unfused(torch, bs, batch, first, "main path")
    codes, iters, hist = outcome(sol, "main path")
    if hist != {0: LANES}:
        fail(f"not every lane exited OPTIMAL: {hist}")
    if bs.last_rescued:
        fail(f"the main path rescued lanes {list(bs.last_rescued)}")
    banded_pcost = sol.info.pcost.cpu().numpy()
    # torch's own account of the synchronizing calls of one solve, beside
    # the loops' count (one per loop test of a host-driven solve)
    import warnings

    # (``same_bits_unfused`` released the program: one solve composes it)
    bs.solve(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        syncs0 = kkt.host_syncs
        bs.solve(batch)
        counted = kkt.host_syncs - syncs0
    torch.cuda.set_sync_debug_mode(0)
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    print(f"synchronizing calls flagged by torch in one composed solve: "
          f"{flagged} (loop count {counted}; the rescue reads the exit "
          f"codes)")
    same_as_cpu(pt, st, probs[0], settings, sol, "main path")
    bs.close()
    del bs
    print(f"phase 2: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 3: forced rescue, the primary cut at 3 iterations
    t_phase = time.perf_counter()
    sub = pt.BatchedSolver.stack(probs[:RESCUE_LANES], shared=shared)
    fs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded", iter_max=3),
                          shared=shared, rescue=rescue)
    fsol, launches, syncs, t_f = drive(torch, kernels, kkt, fs, sub)
    same_bits_eager(torch, kernels, kkt, fs, sub, fsol, launches, syncs,
                    "forced rescue")
    _, _, hist = outcome(fsol, "forced rescue")
    print(f"forced rescue: {t_f:.3f} s; rescued lanes {list(fs.last_rescued)}"
          f"; kernel launches {launches}")
    if fs.last_rescued != tuple(range(RESCUE_LANES)):
        fail(f"forced rescue took lanes {fs.last_rescued}, expected all "
             f"{RESCUE_LANES}")
    if hist != {0: RESCUE_LANES}:
        fail(f"forced rescue: not every lane OPTIMAL: {hist}")
    need_launched(launches, band_names + dense_names, "forced rescue")
    fs.close()
    del fs
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
    same_bits_eager(torch, kernels, kkt, rs, batch, first, launches, syncs,
                    "reduced")
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
    rs.close()
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
    same_bits_eager(torch, kernels, kkt, ss, sbatch, ssol, launches, syncs,
                    "SOCP reduced")
    print(f"SOCP reduced: exit codes by lane {ssol.exit_code.tolist()}")
    same_bits(torch, ssol, ss.solve(sbatch), "SOCP reduced")
    same_as_cpu(pt, sst, sprobs[0], red, ssol, "SOCP reduced")
    soc_red_pcost = ssol.info.pcost.cpu().numpy()
    print(f"phase 5: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 6: the SOCP lane of the main path (NT-scaled kept cones)
    t_phase = time.perf_counter()
    ss.close()
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
                       kbatch, kshared, settings, rescue,
                       band_names + ["spmv"], ab=True)
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
                           wbatch, wshared, settings, None,
                           wide_names + ["spmv", "dgemm"])
    for r in wide_records:
        r["launches"] = launches[r["name"]]
    k12_record["launches"] = launches["dgemm"]
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
    same_bits_eager(torch, kernels, kkt, us, batch, first, launches, syncs,
                    "reduced on substitution")
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
    us.close()
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
    same_bits_eager(torch, kernels, kkt, ns, nbatch, first, launches, syncs,
                    "normal")
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
    ns.close()
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
    one.close()
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
        same_bits_eager(torch, kernels, kkt, fs_, fbatch, fsol, launches,
                        syncs, label)
        again, rate = timed(torch, fs_, fbatch, FULL_LANES, reps=1)
        same_bits(torch, fsol, again, label)
        codes, iters, hist = outcome(fsol, label)
        if hist != {0: FULL_LANES}:
            fail(f"{label}: not every lane OPTIMAL: {hist}")
        objectives_close(fsol, banded_pcost[:FULL_LANES], {2: STRATEGY_TOL},
                         label)
        profile_solve(torch, fs_, fbatch)
        fs_.close()
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
    same_bits_eager(torch, kernels, kkt, hs, batch, hsol, launches, syncs,
                    "reduced, f32 factor")
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
    hs.close()
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

    # ---- phase 15: Settings(block=64)
    t_phase = time.perf_counter()
    phase_block64(torch, pt, kernels, kkt, make_band_plan, st, probs, shared)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 16: BatchedSolver(mesh=make_mesh())
    t_phase = time.perf_counter()
    phase_mesh(torch, pt, kernels, kkt, make_mesh, st, batch, shared,
               settings, rescue)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 17: repeated solves through the solvers' kept programs
    t_phase = time.perf_counter()
    phase_repeat(torch, pt, corpus, kernels, kkt, make_band_plan, make_mesh,
                 st, probs, batch, shared, settings, rescue)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # one entry a kernel: the band kernels at the main path's bandwidth 1,
    # with phase 7's bandwidth-3 readings beside them under "bw3", the
    # leaves with phases 12's and 13's readings under "scan", and dgemm
    # with its wide-operand form on phase 7's solve under "k12"
    wide = {r["name"]: {k: r[k] for k in order[4:]} for r in wide_records}
    scan = {name: {k: r[k] for k in order[4:]}
            for name, r in scan_records.items()}
    print(json.dumps({"kernels": [
        {k: r[k] for k in order}
        | ({"bw3": wide[r["name"]]} if r["name"] in wide else {})
        | ({"scan": scan[r["name"]]} if r["name"] in scan else {})
        | ({"k12": k12_record} if r["name"] == "dgemm" else {})
        | ({"fused": {k: r[k] for k in SPMV_EXTRA}}
           if r["name"] == "spmv" else {})
        for r in band_records + dense_records + subst_records
        + [spmv_record, s2_record, stamp_record]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
