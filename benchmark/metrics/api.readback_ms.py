"""Median host span from ``solve()`` returning to the results (exit codes,
x, y, z, s, iterations) being in host memory."""

import statistics


def read(rec):
    spans = [b["readback"] for b in rec["batches"]]
    return statistics.median(spans) * 1e3 if spans else None
