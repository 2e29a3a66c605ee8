"""Data parallelism over lanes: the port of ``eicos_tpu.parallel.sharding``.

Lanes share one structure and never couple, so a batch splits into even
shards along its lane axis, one a device of the mesh, with the shared
fields copied to each.  The JAX package runs the shards as one SPMD
program with no collective inside the loop; here each shard is solved by
``solver.solve_batch`` on its own device, from one host thread a device,
all at once, and the solutions are gathered on the mesh's first device.

A mesh is a sequence of ``torch.device``: ``make_mesh`` gives the visible
cards; the CPU tests pass ``[torch.device("cpu")] * 2``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import graphs
from ..problem import ProblemData
from ..settings import Settings
from ..solver import Solution, solve_batch, to_device
from ..structure import ProblemStructure
from ..utils import timing

_FIELDS = ("G", "A", "c", "h", "b")


def make_mesh(n_devices: int | None = None) -> tuple:
    """The first ``n_devices`` visible CUDA devices (all of them by
    default); raises where fewer are visible than asked for."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise RuntimeError(f"a mesh of {n} CUDA devices asked for, "
                           f"{count} visible")
    return tuple(torch.device("cuda", i) for i in range(n))


def shard_batch(batch: ProblemData, mesh: Sequence[torch.device],
                shared: tuple = ()) -> list:
    """``batch`` (host arrays; the fields in ``shared`` without a lane
    axis) split into ``len(mesh)`` even shards along the lane axis, each
    moved to its device as ``solver.to_device`` moves a batch.  Raises
    ``ValueError`` unless the mesh size divides the lanes."""
    shared = tuple(shared)
    per_lane = [f for f in _FIELDS if f not in shared]
    if not per_lane:
        raise ValueError("a batch needs at least one per-lane field")
    lanes = np.shape(getattr(batch, per_lane[0]))[0]
    size = len(mesh)
    if size < 1 or lanes % size:
        raise ValueError(f"{lanes} lanes do not split evenly over a mesh "
                         f"of {size} devices")
    step = lanes // size
    return [to_device(ProblemData(**{
        f: (getattr(batch, f) if f in shared
            else np.asarray(getattr(batch, f))[i * step:(i + 1) * step])
        for f in _FIELDS}), dev, shared) for i, dev in enumerate(mesh)]


def _gather(parts: list, device: torch.device):
    """Concatenate (nested NamedTuples of) per-shard tensors along the
    lane axis on ``device``."""
    first = parts[0]
    if isinstance(first, tuple):
        return type(first)(*[_gather([p[i] for p in parts], device)
                             for i in range(len(first))])
    return torch.cat([p.to(device) for p in parts])


def solve_shards(structure: ProblemStructure, shards: list,
                 mesh: Sequence[torch.device],
                 settings: Settings = Settings(),
                 programs: Optional[Sequence] = None) -> Solution:
    """Solve the shards of ``shard_batch`` at once, one host thread a
    device, and gather the ``Solution`` on ``mesh[0]``.  ``programs``:
    one ``graphs.Program`` a shard (``solver.program_for``), which the
    shard's thread captures, composes and launches with its device
    current; without them each shard's solve makes its own for the
    call.  A shard's spans nest in the caller's open span, and a caller
    inside ``graphs.host_driven()`` drives every shard from the host."""
    results: list = [None] * len(shards)
    errors: list = []
    spans = timing.current()
    hosted = graphs.is_host_driven()

    def run(i: int) -> None:
        dev = mesh[i]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        try:
            with ctx, timing.within(spans), (
                    graphs.host_driven() if hosted
                    else contextlib.nullcontext()):
                results[i] = solve_batch(
                    structure, shards[i], settings,
                    program=None if programs is None else programs[i])
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        except BaseException as e:      # re-raised on the calling thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(shards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return _gather(results, mesh[0])


def solve_batch_sharded(structure: ProblemStructure, batch: ProblemData,
                        mesh: Sequence[torch.device],
                        settings: Settings = Settings(),
                        shared: tuple = ()) -> Solution:
    """Solve a batch with its lane axis split evenly over ``mesh``
    (``eicos_tpu.parallel.sharding.solve_batch_sharded``; ``shared`` as
    for ``BatchedSolver``).  The lanes must divide evenly over the mesh;
    each shard finishes when its slowest lane does."""
    return solve_shards(structure, shard_batch(batch, mesh, shared), mesh,
                        settings)
