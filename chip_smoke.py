"""Smoke test of eicos_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch twin on the card, drives the main path
(the 128-lane MPC01-scale banded LP batch of bench.py) through
``BatchedSolver``, and re-solves lane 0 on the CPU plain path.

    python3 chip_smoke.py

Needs one CUDA device and nvcc.  Prints the card (``nvidia-smi`` name and
power limit), the build time, each kernel's error and timing, the main
path's outcome, a JSON line of per-kernel numbers, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HORIZON, NX, NU = 249, 2, 4       # bench.py's MPC01-family scale
LANES = 128
B = 128
KP = 16
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOP_PER_S = 67e12            # H100 SXM f64 tensor-core peak (same)
KERNEL_TOL = 1e-10                # kernel vs plain twin, max relative error
RESID_TOL = 1e-9                  # ||K x - b||_inf / ||b||_inf
LANE_TOL = 1e-8                   # lane 0: GPU vs CPU objective, relative


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


def check_kernels(torch, band, plain):
    """Each kernel against its plain twin at the main path's shape, with
    times and bounds.  Returns the per-kernel records (launches filled in
    later from the main path)."""
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
    print(f"band_factor vs plain: max rel err L/Dinv/d "
          f"{[rel_err(a, b) for a, b in zip(fk, fp)]}")
    if not fac_err <= KERNEL_TOL:
        fail(f"band_factor disagrees with its plain twin: {fac_err}")

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
        print(f"k={k}: band_fwd rel err {errs[k][0]:.3e}, band_bwd "
              f"{errs[k][1]:.3e}, band_solve vs plain {errs[k][2]:.3e}, "
              f"residual {resid:.3e}")
        if not max(errs[k][:3]) <= KERNEL_TOL:
            fail(f"band solve kernels disagree with the plain twins (k={k})")
        if not resid <= RESID_TOL:
            fail(f"band solve residual {resid} (k={k})")

    lanes = LANES
    blk = B * B * 8
    # bytes: each input read once, each output written once
    fac_bytes = lanes * nb * (4 * blk + B * 8)
    # ops: two B^3 products per block row after the first (2 B^3 flops
    # each), the leaf (~B^3/6 rank-1 updates of 3 flops) and the
    # unit-lower inverse (~B^3/6 FMAs)
    fac_ops = lanes * ((nb - 1) * 4 * B ** 3 + nb * (B ** 3 // 2 + B ** 3 // 3))
    records = []

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F64_FLOP_PER_S * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    b_ms, b_by = bound(fac_bytes, fac_ops)
    ms = cuda_ms(lambda: band.band_factor(Kd, Ks))
    pms = cuda_ms(lambda: plain.band_factor_plain(Kd, Ks), reps=5)
    print(f"band_factor: {ms:.4f} ms (plain {pms:.3f} ms), bound "
          f"{b_ms:.4f} ms by {b_by} ({fac_bytes / 1e9:.3f} GB, "
          f"{fac_ops / 1e9:.2f} GFLOP)")
    records.append(dict(
        name="band_factor", route="cuda",
        source="eicos_tpu_torch/csrc/band_factor.cu",
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
    fac_in = lanes * nb * 2 * blk
    io = 2 * lanes * k * nb * B * 8
    sweep_ops = lanes * k * nb * 2 * 2 * B * B
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
        print(f"{name}: {ms:.4f} ms at k={k} ({ms16:.4f} ms at k={KP}); "
              f"plain {pms:.4f} ms; solve_triangular {lms:.4f} ms; bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.3f} GB)")
        ei = 4 if name == "band_fwd" else 5
        records.append(dict(
            name=name, route="cuda",
            source="eicos_tpu_torch/csrc/band_solve.cu",
            replaces=("eicos_tpu/ops/pallas_band_ds.py:1457"
                      if name == "band_fwd"
                      else "eicos_tpu/ops/pallas_band_ds.py:1497"),
            max_abs_err=max(errs[kk][ei] for kk in errs), ms=ms,
            plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms))
    del Lfull, LfullT
    torch.cuda.empty_cache()
    return records


def build_batch(pt, corpus, make_band_plan):
    """bench.py's batch: shared G/A/h, per-lane c and x0 (in b)."""
    rng = np.random.default_rng(7)
    st, base = corpus.make_mpc_like(horizon=HORIZON, nx=NX, nu=NU, seed=3)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    probs = []
    for _ in range(LANES):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(st.n)
        b = np.asarray(base.b).copy()
        b[:NX] += 0.05 * rng.standard_normal(NX)
        probs.append(pt.ProblemData(G=base.G, A=base.A, c=c, h=base.h, b=b))
    shared = ("G", "A", "h")
    return st, probs, pt.BatchedSolver.stack(probs, shared=shared), shared


def profile_solve(torch, bs, batch):
    """Device time by kernel over one solve (torch.profiler) and the
    device's idle share of the solve's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
          f"{busy:.1f} ms (idle share {1 - busy / (wall * 1e3):.3f})")
    for ms, key, count in rows[:10]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {key[:90]}")


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import corpus, kkt
    from eicos_tpu_torch.ops import band, kernels
    from eicos_tpu_torch.ops import band_ldl as plain
    from eicos_tpu_torch.plan import make_band_plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    records = check_kernels(torch, band, plain)

    # ---- the main path: 128 lanes of the MPC01-scale LP
    st, probs, batch, shared = build_batch(pt, corpus, make_band_plan)
    print(f"main path: n={st.n} p={st.p} m={st.m}, Dp={st.band.dim}, "
          f"bwb={st.band.bwb}, {LANES} lanes")
    settings = pt.Settings(kkt_strategy="banded")
    bs = pt.BatchedSolver(st, settings, shared=shared)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    syncs0 = kkt.host_syncs
    t0 = time.perf_counter()
    sol = bs.solve(batch)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.COUNTS)
    syncs = kkt.host_syncs - syncs0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sol = bs.solve(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    codes = sol.exit_code.cpu().numpy()
    iters = sol.info.iter.cpu().numpy()
    hist = {int(c): int((codes == c).sum()) for c in np.unique(codes)}
    med = float(np.median(times))
    print(f"exit codes {hist}; iterations min/median/max "
          f"{iters.min()}/{np.median(iters):g}/{iters.max()}")
    print(f"first solve {t_first:.3f} s; timed solves {times} s; median "
          f"{LANES / med:.2f} solves/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    print(f"host syncs per solve: {syncs}")
    print(f"kernel launches per solve: {launches}")
    if hist != {0: LANES}:
        fail(f"not every lane exited OPTIMAL: {hist}")
    if not all(launches[r["name"]] > 0 for r in records):
        fail(f"a kernel of the main path was never launched: {launches}")
    for r in records:
        r["launches"] = launches[r["name"]]
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

    # ---- lane 0 again on the CPU plain path
    t0 = time.perf_counter()
    cpu = pt.solve(st, probs[0], settings, device="cpu")
    t_cpu = time.perf_counter() - t0
    g_pc = float(sol.info.pcost[0])
    c_pc = float(cpu.info.pcost)
    print(f"lane 0: GPU code {int(codes[0])} iter {int(iters[0])} pcost "
          f"{g_pc!r}; CPU plain code {int(cpu.exit_code)} iter "
          f"{int(cpu.info.iter)} pcost {c_pc!r} ({t_cpu:.1f} s)")
    if (int(cpu.exit_code) != int(codes[0])
            or int(cpu.info.iter) != int(iters[0])
            or not abs(g_pc - c_pc) <= LANE_TOL * abs(c_pc)):
        fail("lane 0 disagrees between the kernels and the plain path")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in order}
                                  for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
