"""Device time a batch in the second-order-cone regions that the program
stamps inside its captured segments (``graphs.STATS`` "regions_ns": the
NT scalings, the kept cone blocks of the KKT assembly and the cone line
search, each region's device time summed over its runs), summed over the
regions and over the window's batches; None where the program stamps no
region (an untraced program, a structure without cones, the CPU, or a
program without the key)."""


def read(rec):
    ns = rec["stats"].get("regions_ns") or {}
    cones = [v for k, v in ns.items() if k.startswith("cones.")]
    return sum(cones) / 1e6 / len(rec["batches"]) if cones else None
