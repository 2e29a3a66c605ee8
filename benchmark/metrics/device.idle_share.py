"""Percent of the window's wall time outside the solves' CUDA-event
spans (``device.busy_ms``): the upload, the readback and the host's work
between batches, in which the device has no solve to run."""


def read(rec):
    ev = rec["events_ms"]
    if not ev:
        return None
    return 100.0 * (1.0 - sum(ev) / 1e3 / rec["window_s"])
