"""Capture and composing time a batch: ``graphs.STATS`` "capture_s" +
"compose_s" over the window, over its batches."""


def read(rec):
    st = rec["stats"]
    return (st["capture_s"] + st["compose_s"]) * 1e3 / len(rec["batches"])
