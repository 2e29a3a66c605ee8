"""The band factor alone at the cell's band shape (bw 1), as a percent of
its roofline: the larger of bytes / 3.35 TB/s and f64 operations / 67
TFLOP/s, counted by ``frozen.band_factor_work``, over the median
CUDA-event time.  A kernel alone, on a seeded band, not inside a solve."""


def read(rec):
    band = rec["band_factor"]
    if not band:
        return None
    return 100.0 * band["bound_ms"] / band["ms"]
