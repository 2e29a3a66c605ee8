"""Median per request of its composed launches' device spans: the card's
clock from the launch's first node to its last (``graphs.STATS``
"launches", stamped by the program), summed a request (a batch and its
rescue); None where the program stamps nothing."""

import statistics


def read(rec):
    per = {}
    for e in rec["stats"].get("launches") or ():
        per[e["request"]] = per.get(e["request"], 0) + e["device_ns"]
    return statistics.median(per.values()) / 1e6 if per else None
