"""Median host span of the composed launch call ("program.launch": the
host's ``cudaGraphLaunch`` of a kept program's one graph); None where the
program records no spans."""

import statistics


def read(rec):
    ns = [s["end"] - s["start"] for s in rec["stats"].get("spans") or ()
          if s["name"] == "program.launch"]
    return statistics.median(ns) / 1e6 if ns else None
