"""Device time a batch of the solve's segment "iteration A" (the
statistics, the scalings, the factor and the predictor solve's start),
summed over its trips by the program's stamps (``graphs.STATS``
"segments_ns") and over the window's batches; None where the program
stamps nothing."""


def read(rec):
    ns = (rec["stats"].get("segments_ns") or {}).get("iteration A")
    return None if ns is None else ns / 1e6 / len(rec["batches"])
