"""Percent of the window's wall time outside the composed launches' device
spans (``graphs.STATS`` "launches", stamped on the card's clock): the
upload, the input copies, the clone, the readback and every host step
between launches, but not the gaps inside a launch; None where the
program stamps nothing."""


def read(rec):
    launches = rec["stats"].get("launches")
    if not launches:
        return None
    busy_s = sum(e["device_ns"] for e in launches) / 1e9
    return 100.0 * (1.0 - busy_s / rec["window_s"])
