"""Median host span of a batch's upload: ``update_data``, which places
the batch's fields on the device."""

import statistics


def read(rec):
    spans = [b["upload"] for b in rec["batches"] if "upload" in b]
    return statistics.median(spans) * 1e3 if spans else None
