"""Timing: the port of ``eicos_tpu.utils.timing``, the analogue of the
reference's tic/toc helpers, with ``timed``, which waits for the device
work of a call (host time around an asynchronous launch measures only the
launch), and a ``torch.profiler`` trace context."""

from __future__ import annotations

import contextlib
import os
import time


def tic() -> float:
    """Start a timer (returns an opaque token for toc)."""
    return time.perf_counter()


def toc(t0: float) -> float:
    """Milliseconds since ``tic()`` — matches the reference's ms units."""
    return 1e3 * (time.perf_counter() - t0)


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists
    and dicts)."""
    import torch

    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    return found


def timed(fn, *args, **kwargs):
    """Run ``fn`` and wait for the device work of the tensors it returned
    (``torch.cuda.synchronize`` on each of their CUDA devices); returns
    (result, milliseconds)."""
    import torch

    t0 = tic()
    out = fn(*args, **kwargs)
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out, toc(t0)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` over the block, CPU and CUDA activities (CUDA
    only where a device exists), written as a Chrome trace
    ``trace.json`` into ``logdir``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
