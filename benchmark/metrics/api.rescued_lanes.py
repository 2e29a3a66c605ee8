"""Lanes a batch that the rescue solved again and improved
(``BatchedSolver.last_rescued``), over the window's batches."""


def read(rec):
    batches = rec["batches"]
    return sum(b["rescued"] for b in batches) / len(batches)
