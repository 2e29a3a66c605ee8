"""The percent of the window's band-factor launches that took the cluster
kernel (``kernels.COUNTS["band_factor_cluster"]``) rather than one CTA a
lane (``"band_factor_bw"``), once ``graphs.settle()`` has added what the
composed launches ran.  None without a record: a program that counts no
cluster factor, or a window that ran no band factor."""


def read(rec):
    counts = rec.get("counts") or {}
    if "band_factor_cluster" not in counts:
        return None
    total = counts["band_factor_cluster"] + counts.get("band_factor_bw", 0)
    if not total:
        return None
    return 100.0 * counts["band_factor_cluster"] / total
