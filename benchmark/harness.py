"""The port's benchmark: one cell of ``BENCHMARK.json``, run once.

Everything a cell needs is found by name: its configuration in the file
the manifest gives and its generator in ``families/<family>.py``, its
traffic mix in ``traffic/<traffic>.json`` (read by ``mixes.py``), the limits of its comparison in ``limits/<cell>.json`` and
each per-layer metric's reader in ``metrics/<metric>.py``.  A run:

1. set-up: the program's kernels (built once into its checkout), the
   mix's plant, pool, structure and solver, and its warm batches;
2. the window: batches in a closed loop for ``--seconds``; a batch that
   starts inside the window runs to its end, and the window closes with
   the last one;
3. the peak of reserved device memory, then the program's state freed;
4. the comparison (``reference/certificate.py``) of every lane's exit code
   and iterations, and of the x, y, z, s of the batches sampled from the
   seed, of the last batch and of every batch in which the rescue
   answered a lane;
5. with ``--trace 1``: the band factor at the cell's band shape under
   CUDA events, and ``torch.profiler`` over one new solver's first solve,
   which the host drives: no composed solve is ever profiled, since the
   profiler's device tracing misses a conditional graph node's kernels
   and has faulted inside one;
6. the import guard, then the checks on standard error and the result on
   standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

import frozen
import mixes
from reference import certificate

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run (compared whole:
# ``eicos_tpu_torch`` is the program, ``eicos_tpu`` the JAX package)
BANNED = ("jax", "jaxlib", "flax", "eicos_tpu", "chip_smoke", "bench")
SAMPLE_STREAM = 3      # seed_rng stream of the sampled batches


def say(msg):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def load_cell(name):
    """The cell ``name``: its manifest entry, configuration, traffic mix,
    limits, and the metrics it reports with and without the trace."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    cell = work[name]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    with open(os.path.join(HERE, "limits", name + ".json")) as fh:
        limits = json.load(fh)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=mine(manifest["end_to_end"]),
                per_layer=mine(manifest["per_layer"]))


def reader(metric):
    """The ``read(rec)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules(modules=None):
    """The banned top-level names found in ``sys.modules``."""
    names = {k.split(".")[0] for k in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(BANNED))


def card_line():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class Run:
    """One run of a cell: set-up, window, comparison, trace extras.
    ``device="cpu"`` (tests only) runs the same control flow on CPU
    tensors and reads no device metric."""

    def __init__(self, spec, seed, seconds, trace, device="cuda",
                 settings=None, rescue=None, t_start=None):
        import torch

        import eicos_tpu_torch as pt

        self.torch = torch
        self.spec, self.seed, self.seconds = spec, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.cuda = device != "cpu"
        self.t_start = time.perf_counter() if t_start is None else t_start
        marks = [("imports", time.perf_counter())]
        if self.cuda:
            from eicos_tpu_torch.ops import kernels

            torch.cuda.init()
            marks.append(("CUDA context", time.perf_counter()))
            kernels.build()
            marks.append(("kernel build check", time.perf_counter()))
        self.mix = mixes.Sweep(pt, spec["config"], spec["traffic"],
                               self.seed, device, settings, rescue)
        marks.append(("plant, plan, solver", time.perf_counter()))
        self.mix.warm()
        self.sync()
        marks.append((f"{spec['traffic']['warm']} warm batches",
                      time.perf_counter()))
        t = self.t_start
        parts = []
        for name, at in marks:
            parts.append(f"{name} {at - t:.3f}")
            t = at
        say("set-up, s: " + "; ".join(parts))

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def window(self):
        """The measured window; fills the run's record."""
        from eicos_tpu_torch import graphs, kkt
        from eicos_tpu_torch.ops import kernels

        torch = self.torch
        share = float(self.spec["traffic"]["check_share"])
        pick = mixes.seed_rng(self.seed, SAMPLE_STREAM)
        events = []

        def mark():
            if self.trace and self.cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

        kernels.reset_counts()
        graphs.reset_stats()
        syncs0 = kkt.host_syncs
        self.setup_s = time.perf_counter() - self.t_start
        batches, kept = [], {}
        t_win = time.perf_counter()
        t_end = t_win
        # the batches go on from the warm ones
        i = first = int(self.spec["traffic"]["warm"])
        while i == first or time.perf_counter() - t_win < self.seconds:
            t0 = time.perf_counter()
            out, spans, t_end = self.mix.run(i, mark)
            batches.append(dict(
                spans, latency=t_end - t0, lanes=out["code"].shape[0],
                optimal=int((out["code"] == 0).sum()),
                iters=int(out["iters"].sum()),
                iter_max=int(out["iters"].max()),
                rescued=len(out["rescued"])))
            if pick.random() < share or out["rescued"]:
                kept[i] = out
            last = (i, out)
            i += 1
        kept[last[0]] = last[1]          # the last batch is always compared
        self.window_s = t_end - t_win
        self.batches, self.kept = batches, kept
        self.events_ms = None
        if events:
            events[-1].synchronize()
            self.events_ms = [a.elapsed_time(b) for a, b in
                              zip(events[0::2], events[1::2])]
        if self.trace:
            graphs.settle()
        self.stats = dict(graphs.STATS)
        self.counts = dict(kernels.COUNTS)
        self.host_syncs = kkt.host_syncs - syncs0
        self.peak_bytes = (torch.cuda.max_memory_reserved() if self.cuda
                           else None)
        self.mix.close()
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def compare(self):
        """The comparison: returns {number: (value, limit)} for the numbers
        that the cell's limits name, and the lanes that failed it among the
        OPTIMAL ones; ``self.readings`` keeps every reading."""
        limits = self.spec["limits"]
        worst = {k: 0.0 for k in certificate.READINGS}
        bad_lanes = 0
        for i, out in self.kept.items():
            plant, k = self.mix.data(i)
            r = certificate.readings(
                plant.G, plant.A, plant.C[k], plant.h, plant.Bv[k], plant.l,
                plant.q, out["x"], out["y"], out["z"], out["s"])
            over = np.zeros(out["code"].shape[0], bool)
            for name in certificate.READINGS:
                # a NaN reading is the worst, and over every limit
                worst[name] = float(np.max([worst[name], r[name].max()]))
                if name in limits:
                    over |= ~(r[name] <= limits[name])
            bad_lanes += int((over & (out["code"] == 0)).sum())
        nonopt = sum(b["lanes"] - b["optimal"] for b in self.batches)
        iter_max = max(int(b["iter_max"]) for b in self.batches)
        self.readings = dict(worst, nonoptimal_lanes=nonopt,
                             iter_max=iter_max)
        checks = {k: (v, limits[k]) for k, v in self.readings.items()
                  if k in limits}
        self.checked_lanes = sum(o["code"].shape[0] for o in
                                 self.kept.values())
        self.rescued_lanes = sum(len(o["rescued"]) for o in
                                 self.kept.values())
        return checks, bad_lanes

    def record(self):
        """What the per-layer readers read."""
        return dict(batches=self.batches, window_s=self.window_s,
                    stats=self.stats, counts=self.counts,
                    host_syncs=self.host_syncs, events_ms=self.events_ms,
                    band_factor=getattr(self, "band", None))

    def band_factor(self):
        """The band factor alone at the cell's band shape (bw 1): median
        CUDA-event time of 20 calls after a warm-up, with the bytes and
        operations of ``frozen.band_factor_work``."""
        shape = self.mix.band_shape()
        if not self.cuda or shape is None or shape[2] != 1:
            self.band = None
            return
        from eicos_tpu_torch.ops import band

        lanes, nb, _ = shape
        Kd, Ks = frozen.random_band(self.torch, lanes, nb, self.seed,
                                    self.device)
        ms = frozen.cuda_ms(self.torch, lambda: band.band_factor(Kd, Ks))
        nbytes, ops = frozen.band_factor_work(lanes, nb)
        bound_ms, by = frozen.bound(nbytes, ops)
        self.band = dict(ms=ms, bound_ms=bound_ms)
        say(f"band factor alone: {lanes} lanes, nb {nb}: {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {by}")
        del Kd, Ks
        self.torch.cuda.empty_cache()

    def breakdown(self):
        """``torch.profiler`` over one new solver's first solve of the
        cell's first batch (``mix.first_solve``), which the host drives:
        the device's top operations and the longest idle gaps by the host
        operation under them.  None where the trace has no device time."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self.mix.first_solve()
            self.sync()
        return summarize(torch, prof)


def summarize(torch, prof, top=10, gaps_named=500):
    """(device_ops, idle_gaps) of a profile, each [[name, seconds], ...]."""
    cuda = torch.autograd.DeviceType.CUDA
    ops = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            ops[e.key] = ops.get(e.key, 0.0) + us
    if not ops:
        return None
    device_ops = [[k[:160], v / 1e6] for k, v in
                  sorted(ops.items(), key=lambda kv: -kv[1])[:top]]
    kern, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if getattr(e, "device_type", None) == cuda:
            kern.append(span)
        else:
            host.append((span[0], span[1], e.name))
    kern.sort()
    gaps = []
    end = kern[0][1]
    for a, b in kern[1:]:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    gaps.sort(reverse=True)
    hs = np.array([h[0] for h in host], float)
    he = np.array([h[1] for h in host], float)
    named = {}
    for length, a, b in gaps[:gaps_named]:
        mid = 0.5 * (a + b)
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        name = ("(no host operation)" if inside.size == 0 else
                host[inside[np.argmin(he[inside] - hs[inside])]][2])
        named[name] = named.get(name, 0.0) + length / 1e6
    rest = sum(g[0] for g in gaps[gaps_named:]) / 1e6
    if rest:
        named["(shorter gaps)"] = rest
    idle = [[k[:160], v] for k, v in
            sorted(named.items(), key=lambda kv: -kv[1])[:top]]
    return dict(device_ops=device_ops, idle_gaps=idle)


def end_to_end(run, good_lanes):
    """The end-to-end metrics by name."""
    lat = [b["latency"] for b in run.batches]
    vals = dict(solves_per_s=good_lanes / run.window_s,
                batch_p90_ms=float(np.percentile(lat, 90)) * 1e3,
                setup_s=run.setup_s)
    if run.peak_bytes is not None:
        vals["peak_mem_gib"] = run.peak_bytes / 2 ** 30
    return vals


def execute(spec, seed, seconds, trace, device="cuda", t_start=None,
            settings=None, rescue=None):
    """One run of the cell ``spec`` (``load_cell``): returns (result dict
    without the import guard's verdict, the check lines)."""
    run = Run(spec, seed, seconds, trace, device, settings, rescue, t_start)
    run.window()
    checks, bad = run.compare()
    ok = all(v <= lim for v, lim in checks.values())
    attempted = sum(b["lanes"] for b in run.batches)
    good = sum(b["optimal"] for b in run.batches) - bad
    metrics, breakdown = {}, None
    if trace:
        run.band_factor()
        rec = run.record()
        for m in spec["per_layer"]:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        breakdown = run.breakdown()
    else:
        vals = end_to_end(run, good)
        for m in spec["end_to_end"]:
            if m["name"] in vals:
                metrics[m["name"]] = dict(value=float(vals[m["name"]]),
                                          unit=m["unit"])
    result = dict(correct=bool(ok), attempted=int(attempted),
                  failed=int(attempted - good), metrics=metrics)
    if run.cuda:
        torch = run.torch
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=1, memory_peak_bytes=int(run.peak_bytes))
        if trace:
            dev.update(busy_s=sum(run.events_ms) / 1e3,
                       window_s=run.window_s)
        result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: dict(value=v, limit=lim)
                        for k, (v, lim) in checks.items()}
    spans = {}
    for key in ("upload", "solve", "readback", "latency"):
        ms = [b[key] * 1e3 for b in run.batches if key in b]
        if ms:
            spans[key] = (float(np.median(ms)), float(np.percentile(ms, 90)))
    say("batch spans, ms (median, p90): " + "; ".join(
        f"{k} {m:.3f}, {p:.3f}" for k, (m, p) in spans.items()))
    say(f"{len(run.batches)} batches, {attempted} lanes in "
        f"{run.window_s:.3f} s; {run.checked_lanes} lanes of "
        f"{len(run.kept)} batches compared ({run.rescued_lanes} rescued); "
        f"set-up "
        f"{run.setup_s:.3f} s")
    return result, run


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    spec = load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 2
    say(f"card: {card_line()}")
    result, _ = execute(spec, args.seed, args.seconds, args.trace,
                        t_start=t_start)
    found = banned_modules()
    if found:
        say(f"modules that a run may not load are loaded: {found}; no "
            f"result")
        return 3
    for k, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        say(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}")
    print(json.dumps(result), flush=True)
    return 0
