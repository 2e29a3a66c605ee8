"""Device time a batch in the band sweeps that the program stamps inside
its captured segments (``graphs.STATS`` "regions_ns" of the region
"band.sweeps": each forward and backward sweep pair of every solve with
the factored band), over the window's batches; None where the program
stamps no such region (an untraced program, a structure without cones,
the CPU, or a program without the region)."""


def read(rec):
    ns = (rec["stats"].get("regions_ns") or {}).get("band.sweeps")
    return ns / 1e6 / len(rec["batches"]) if ns else None
