"""Megabytes (10^6 bytes) a batch that the program placed on the device
from the host: ``graphs.STATS`` "upload_bytes" (counted in
``solver.to_device``) over the window's batches; None where the program
has no such counter."""


def read(rec):
    nbytes = rec["stats"].get("upload_bytes")
    if not nbytes:
        return None
    return nbytes / 1e6 / len(rec["batches"])
