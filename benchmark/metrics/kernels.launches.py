"""Launches of the port's own kernels a batch: the sum of
``kernels.COUNTS`` once ``graphs.settle()`` has added what the composed
launches ran."""


def read(rec):
    return sum(rec["counts"].values()) / len(rec["batches"])
