"""Interior-point iterations a lane: the mean of ``Solution.info.iter``
over the window's lanes."""


def read(rec):
    batches = rec["batches"]
    return sum(b["iters"] for b in batches) / sum(b["lanes"] for b in batches)
