"""Readings that set a cell's limits, at the cell's own size, in one
process (the benchmark's own runs do not run this):

    python3 benchmark/control.py --workload <cell> --program 1,2,... \
        --control 101,102,... --reduced 201,... --seconds 3

- ``program``: the program as the configuration states it, on each seed:
  the lower readings.  Beside them, the same answers rounded to float32
  (``rounded``): where the limits sit against an answer of float32
  quality.
- ``control``: the program with its own float32 path switched on for the
  solve and its rescue (the configuration's ``control`` settings): the
  upper readings.
- ``reduced``: every lane solved by the rescue's own settings, with no
  rescue behind them: the readings of the rescue's answers on many lanes
  where the cell's runs meet only a few.

Every batch of the short window is compared (the runs compare a sample).
Prints one JSON line a seed and arm.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402

F32 = ("x", "y", "z", "s")


def readings(run):
    run.compare()
    return run.readings


def arm(spec, seed, seconds, device, name, settings=None, rescue=None):
    run = harness.Run(spec, seed, seconds, False, device, settings, rescue)
    run.window()
    out = [dict(arm=name, seed=seed, batches=len(run.batches),
                lanes=sum(b["lanes"] for b in run.batches),
                rescued=sum(b["rescued"] for b in run.batches),
                iters=sum(b["iters"] for b in run.batches),
                readings=readings(run))]
    if name == "program":
        for o in run.kept.values():
            for f in F32:
                o[f] = o[f].astype("float32").astype("float64")
        out.append(dict(out[0], arm="rounded", readings=readings(run)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--reduced", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.load_cell(args.workload)
    # every batch compared; one warm batch is enough for readings
    spec["traffic"] = dict(spec["traffic"], check_share=1.0, warm=1)
    control = spec["config"]["control"]
    seeds = [(s, "program") for s in args.program.split(",") if s] + \
        [(s, "control") for s in args.control.split(",") if s] + \
        [(s, "reduced") for s in args.reduced.split(",") if s]
    arms = dict(program={}, control=dict(settings=control["settings"],
                                         rescue=control["rescue"]),
                reduced=dict(settings=spec["config"]["rescue"], rescue={}))
    for seed, name in seeds:
        kw = arms[name]
        for line in arm(spec, int(seed), args.seconds, args.device, name,
                        **kw):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
