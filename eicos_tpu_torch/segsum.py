"""Scatter-adds over static index maps, summed in a fixed order.

``Tensor.index_add_`` with repeated targets adds through atomics on a CUDA
device, in a new order on every call, so two solves of one batch could
differ in their last bits and, near the edge of an exit tier, in their
exit code.  A ``SegmentSum`` is built once from a static map: for each
distinct target, the positions of its contributions in their original
order, padded with a slot that reads 0.  A sum is one gather and then,
for up to ``SEQUENTIAL_MAX`` contributions to a target, one add per slot
in that order: the sequential order of ``index_add_`` into zeros on the
CPU (and of the JAX package's ``.at[].add`` and ``segment_sum`` there),
so the CPU values keep their bits and the card's are the same bits
(``tests/test_torch_segsum.py``).  Beyond that, one reduction over the
slots, whose order is fixed but not sequential.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

SEQUENTIAL_MAX = 16


class SegmentSum(NamedTuple):
    targets: torch.Tensor  # (U,) distinct targets, ascending
    slots: torch.Tensor    # (c, U) positions in the values; N reads 0


def segment_map(index, device, keep: Optional[np.ndarray] = None
                ) -> SegmentSum:
    """The ``SegmentSum`` of the flat static map ``index`` (N,): value i
    adds to target ``index[i]``; where ``keep`` is given, only the values
    it marks take part."""
    index = np.asarray(index, np.int64).ravel()
    n = index.size
    src = np.arange(n) if keep is None else np.flatnonzero(
        np.asarray(keep).ravel())
    src = src[np.argsort(index[src], kind="stable")]
    targets, first, counts = np.unique(index[src], return_index=True,
                                       return_counts=True)
    slots = np.full((int(counts.max(initial=0)), targets.size), n, np.int64)
    col = np.repeat(np.arange(targets.size), counts)
    slots[np.arange(src.size) - first[col], col] = src
    return SegmentSum(
        targets=torch.as_tensor(targets, dtype=torch.int64, device=device),
        slots=torch.as_tensor(slots, dtype=torch.int64, device=device))


def segment_sum(seg: SegmentSum, vals: torch.Tensor) -> torch.Tensor:
    """(..., N) values -> (..., U) sums, one per target of ``seg``."""
    padded = torch.cat([vals, vals.new_zeros(*vals.shape[:-1], 1)], -1)
    g = padded[..., seg.slots]                       # (..., c, U)
    c = seg.slots.shape[0]
    if not c or c > SEQUENTIAL_MAX:
        return g.sum(-2)
    out = g[..., 0, :]
    for j in range(1, c):
        out = out + g[..., j, :]
    return out
