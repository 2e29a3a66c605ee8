"""The solve loops' host synchronisations a batch (``kkt.host_syncs``);
0 where every solve is one composed launch."""


def read(rec):
    return rec["host_syncs"] / len(rec["batches"])
