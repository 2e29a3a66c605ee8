"""Timing: the port of ``eicos_tpu.utils.timing``, the analogue of the
reference's tic/toc helpers, with ``timed``, which waits for the device
work of a call (host time around an asynchronous launch measures only the
launch), a ``torch.profiler`` trace context, and the port's host spans.

Spans.  ``span(name)`` records a name, a start and an end on
``time.perf_counter_ns``, the span it runs inside (its parent, on the same
thread, or the one ``within`` carries over from another) and a request
number: a solve of ``api.Solver`` or ``api.BatchedSolver`` is one request,
and the ``update_data`` that prepares it carries its number.  Spans go into
one ring of ``SPAN_RING`` under a lock, which the threads of a sharded solve
share; ``spans()`` reads it, ``clear_spans()`` empties it (``graphs.
reset_stats`` does), and ``dropped()`` counts the spans the ring let go.
``EICOS_TORCH_TRACE=0`` turns spans off (read as a request's outermost span
opens) and the device stamps of ``graphs`` (read as a program composes);
tracing is on where it is unset.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

SPAN_RING = 1 << 16


def tracing() -> bool:
    """Spans and device stamps are recorded unless ``EICOS_TORCH_TRACE``
    is "0"."""
    return os.environ.get("EICOS_TORCH_TRACE", "1") != "0"


class Span(NamedTuple):
    """One recorded span; ``parent`` and ``request`` are 0 for none,
    ``launch`` a composed launch's index in its program."""

    name: str
    start: int
    end: int
    id: int
    parent: int
    request: int
    launch: Optional[int]


_SPANS: collections.deque = collections.deque(maxlen=SPAN_RING)
_DROPPED = [0]
_LOCK = threading.Lock()
_TLS = threading.local()       # ``stack``: the open spans (``span``)
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)


def new_request() -> int:
    """A new request number."""
    return next(_REQUESTS)


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def request() -> int:
    """The request of this thread's innermost open span; 0 for none."""
    st = _stack()
    return st[-1][5] if st and st[-1] is not None else 0


class span:
    """A context manager that records one span (module doc) as it exits;
    ``request`` sets the request of a span and those inside it, which
    otherwise take their parent's.  Inside a span that tracing found off,
    nothing is recorded.  An open span is its ``Span`` fields in a list on
    this thread's stack (None where off), moved into the ring whole."""

    __slots__ = ("name", "request", "launch")

    def __init__(self, name: str, request: Optional[int] = None,
                 launch: Optional[int] = None):
        self.name, self.request, self.launch = name, request, launch

    def __enter__(self) -> "span":
        try:
            st = _TLS.stack
        except AttributeError:
            st = _TLS.stack = []
        if st:
            top = st[-1]
            if top is None:
                st.append(None)
                return self
            parent, req = top[3], top[5]
        elif tracing():
            parent = req = 0
        else:
            st.append(None)
            return self
        if self.request is not None:
            req = self.request
        st.append([self.name, time.perf_counter_ns(), 0, next(_IDS), parent,
                   req, self.launch])
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        rec = _TLS.stack.pop()
        if rec is not None:
            rec[2] = end
            with _LOCK:
                if len(_SPANS) == SPAN_RING:
                    _DROPPED[0] += 1
                _SPANS.append(rec)
        return False


def current() -> list:
    """This thread's open spans, for ``within`` on another thread."""
    return list(_stack())


@contextlib.contextmanager
def within(stack: list):
    """Inside the block, this thread's spans nest in ``stack`` (from
    ``current()`` on the thread that started this one)."""
    prev = getattr(_TLS, "stack", None)
    _TLS.stack = list(stack)
    try:
        yield
    finally:
        _TLS.stack = prev


def spans() -> list:
    """The spans in the ring, oldest first, as ``Span``s."""
    with _LOCK:
        return [Span(*rec) for rec in _SPANS]


def dropped() -> int:
    """Spans the ring let go since ``clear_spans``."""
    return _DROPPED[0]


def clear_spans() -> None:
    with _LOCK:
        _SPANS.clear()
        _DROPPED[0] = 0


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
