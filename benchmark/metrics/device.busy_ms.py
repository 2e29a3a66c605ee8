"""Median per batch of a CUDA-event span on the solve's stream, from the
moment ``update_data`` has returned to the moment ``solve()`` has: the
device's work on the solve, with the host's launch and its exit-code read
around it.  Gaps inside a composed graph are inside the span: events
cannot see them."""

import statistics


def read(rec):
    ev = rec["events_ms"]
    return statistics.median(ev) if ev else None
