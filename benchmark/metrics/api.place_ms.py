"""Median per request of the program's own "api.place" spans
(``BatchedSolver._place``: the batch's values put on the device, inside
``update_data`` or a ``solve`` given a new batch), summed a request; None
where the program records no spans."""

import statistics


def read(rec):
    per = {}
    for s in rec["stats"].get("spans") or ():
        if s["name"] == "api.place":
            ns = s["end"] - s["start"]
            per[s["request"]] = per.get(s["request"], 0) + ns
    return statistics.median(per.values()) / 1e6 if per else None
