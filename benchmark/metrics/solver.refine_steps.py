"""Iterative-refinement steps a lane a batch: ``graphs.STATS``
"refine_steps" (the steps of every refined solve, the init systems' and
each iteration's three, summed over a solve's lanes by the program as it
finishes) over the window's lanes; None where the program counts no
steps (an untraced program, or a program without the key)."""


def read(rec):
    steps = rec["stats"].get("refine_steps")
    if steps is None:
        return None
    return steps / sum(b["lanes"] for b in rec["batches"])
