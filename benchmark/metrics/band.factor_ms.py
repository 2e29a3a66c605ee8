"""Device time a batch in the band factors that the program stamps inside
its captured segments (``graphs.STATS`` "regions_ns" of the region
"band.factor": every band factor of a solve, the init factor's
included), over the window's batches; None where the program stamps no
such region (an untraced program, a structure without cones, the CPU, or
a program without the region)."""


def read(rec):
    ns = (rec["stats"].get("regions_ns") or {}).get("band.factor")
    return ns / 1e6 / len(rec["batches"]) if ns else None
