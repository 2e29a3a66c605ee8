"""Device time a batch of the three refinement-trip segments (the init
systems' trip and the iteration's two- and one-right-hand-side trips),
summed over their trips by the program's stamps (``graphs.STATS``
"segments_ns") and over the window's batches; None where the program
stamps nothing."""


def read(rec):
    segs = rec["stats"].get("segments_ns") or {}
    ns = [v for k, v in segs.items() if "refinement trip" in k]
    return sum(ns) / 1e6 / len(rec["batches"]) if ns else None
