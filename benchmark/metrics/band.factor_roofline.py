"""The band factor inside the solve, as a percent of its roofline: the
larger of bytes / 3.35 TB/s and f64 operations / 67 TFLOP/s, counted by
``band_work.band_factor_work_bw`` at the window's lanes and the band
shape (nb, bwb) that the program records (``graphs.STATS``
"band_shape"), over the stamped device time a call of the region
"band.factor" ("regions_ns" over "regions_runs"); None where the program
stamps no such region or records no shape."""

from band_work import band_factor_work_bw
from frozen import bound


def read(rec):
    stats = rec["stats"]
    ns = (stats.get("regions_ns") or {}).get("band.factor")
    runs = (stats.get("regions_runs") or {}).get("band.factor")
    shape = stats.get("band_shape")
    if not ns or not runs or shape is None:
        return None
    nb, bwb = shape
    lanes = rec["batches"][0]["lanes"]
    bound_ms, _ = bound(*band_factor_work_bw(lanes, nb, bwb))
    return 100.0 * bound_ms / (ns / 1e6 / runs)
