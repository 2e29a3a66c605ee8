"""The interior-point loop as captured CUDA graphs: the port's counterpart
of the JAX package's jit-compiled loop body.

``solver.solve_batch`` runs its loop body as five ``Segment``s of one
``Runner``: the iteration's parts A, B and C and the two refinement trips
(two right-hand sides and one).  A segment wraps a function of tensors and
runs it by the device of the runner:

- CPU: the function is called, every time; nothing touches ``torch.cuda``.
- CUDA: a segment's first call runs the function eagerly (the warm-up:
  kernels built and loaded, caches filled, cuBLAS handles made).  Once the
  runner is armed (after the loop's iteration 0), the next call captures
  the function into a ``torch.cuda.CUDAGraph`` on a side stream
  (``capture_error_mode="thread_local"``: a sharded solve captures from
  one host thread a device) and replays it; later calls replay only.

Inputs.  A tensor that the runner holds (``hold``: the solve's constants;
``buffers``: the loop state; every captured segment's outputs) is read in
place by the graph, and every later call must pass that same tensor.  Any
other tensor is copied into a static buffer before each replay.  Other
arguments must be the same objects (or equal scalars) at every call.
Outputs are the captured tensors, and each replay rewrites them in place:
read a segment's outputs before it replays again.  A segment that updates
its inputs does so with ``copy_`` at its end, after it has computed every
new value from the old ones (the loop state in C, the refinement state in
the trips), so no replay reads a buffer it has already overwritten.

Pools.  Each graph has a memory pool of its own: a shared pool is safe only
when the graphs replay in the order they were captured, and a trip replays
zero or more times an iteration.  The graphs and their pools live for one
``solve_batch`` call; nothing made inside a capture may outlive it (see
``Runner.stream``: cuBLAS's workspace would).

Counts.  A capture records the kernel launches that its function makes
(``kernels.recording``) and each replay adds them to ``kernels.COUNTS``,
so a graphed solve counts as the same solve run eagerly.  ``STATS`` sums
captures, replays, input copies, eager calls, capture time and the port's
kernel launches made by replays, over every runner.

Failures raise: a capture or replay that fails raises ``RuntimeError``
naming the segment, and nothing runs the segment eagerly instead.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from .ops import kernels

STATS: dict = {}
_LOCK = threading.Lock()
_TLS = threading.local()    # ``streams``: this thread's capture stream a device
_SCALARS = (bool, int, float, str, type(None), torch.dtype, torch.device)


def reset_stats() -> None:
    with _LOCK:
        STATS.clear()
        STATS.update(captures=0, replays=0, copies=0, eager=0, capture_s=0.0,
                     graph_counts={})


reset_stats()


def _stat(counts=None, **kw) -> None:
    with _LOCK:
        for k, v in kw.items():
            STATS[k] += v
        for k, v in (counts or {}).items():
            STATS["graph_counts"][k] = STATS["graph_counts"].get(k, 0) + v


def _flatten(tree, opaque: dict, leaves: list):
    """Append the leaves of ``tree`` to ``leaves`` and return its spec:
    tuples, lists and NamedTuples are nodes, except those in ``opaque``
    (by id); anything else is a leaf."""
    typ = type(tree)
    if id(tree) not in opaque and (typ is tuple or typ is list or (
            isinstance(tree, tuple) and hasattr(typ, "_fields"))):
        return typ, tuple(_flatten(x, opaque, leaves) for x in tree)
    leaves.append(tree)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    typ, kids = spec
    vals = [_unflatten(k, it) for k in kids]
    return typ(vals) if typ is tuple or typ is list else typ(*vals)


def tensors(tree) -> list:
    """The tensor leaves of ``tree``, in order."""
    leaves: list = []
    _flatten(tree, {}, leaves)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def copy_into(dst, src) -> None:
    """``copy_`` every tensor of ``src`` into its place in ``dst``, a tree
    of the same structure."""
    for d, s in zip(tensors(dst), tensors(src), strict=True):
        d.copy_(s)


def _captures(device: torch.device) -> bool:
    """Segments on ``device`` capture graphs: CUDA tensors do."""
    return device.type == "cuda"


class _CudaGraph:
    """One ``torch.cuda.CUDAGraph``, captured on the runner's side
    stream and replayed on the current one."""

    def __init__(self, stream):
        self.stream = stream
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn, args):
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.device(self.stream.device), \
                torch.cuda.stream(self.stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*args)
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        cur.wait_stream(self.stream)
        return out

    def replay(self) -> None:
        self.graph.replay()


def _new_graph(runner: "Runner"):
    return _CudaGraph(runner.stream())


class Segment:
    """A function of tensors that a ``Runner`` runs eagerly, or captures
    and then replays (module doc)."""

    def __init__(self, runner: "Runner", name: str, fn):
        self.runner, self.name, self.fn = runner, name, fn
        self.warm = False
        self._graph = None

    def __call__(self, *args):
        r = self.runner
        if self._graph is None:
            if not (r.graphed and r.armed and self.warm):
                self.warm = True
                _stat(eager=1)
                return self.fn(*args)
            return self._capture(args)
        return self._replay(args)

    def _capture(self, args):
        r = self.runner
        leaves: list = []
        self._spec = _flatten(args, r._opaque, leaves)
        self._static, self._copied = [], set()
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor) and id(x) not in r._held:
                x = r._keep(x.clone())
                self._copied.add(i)
            self._static.append(x)
        graph = _new_graph(r)
        t0 = time.perf_counter()
        try:
            with kernels.recording() as delta:
                out = graph.capture(self.fn,
                                    _unflatten(self._spec, iter(self._static)))
        except Exception as e:
            raise RuntimeError(f"capturing segment {self.name!r} failed: "
                               f"{e}") from e
        _stat(captures=1, capture_s=time.perf_counter() - t0)
        for t in tensors(out):
            r._keep(t)
        self._graph, self._out, self._delta = graph, out, delta
        self._launch(0)
        return out

    def _replay(self, args):
        leaves: list = []
        if _flatten(args, self.runner._opaque, leaves) != self._spec:
            raise RuntimeError(f"segment {self.name!r}: arguments of another "
                               f"structure than at its capture")
        copies = 0
        for i, (x, s) in enumerate(zip(leaves, self._static)):
            if x is s:
                continue
            if i in self._copied and isinstance(x, torch.Tensor):
                if (x.shape, x.dtype, x.device) != (s.shape, s.dtype,
                                                    s.device):
                    raise RuntimeError(
                        f"segment {self.name!r}: argument {i} is "
                        f"{x.dtype} {tuple(x.shape)} on {x.device}, captured "
                        f"as {s.dtype} {tuple(s.shape)} on {s.device}")
                s.copy_(x)
                copies += 1
            elif not (isinstance(x, _SCALARS) and type(x) is type(s)
                      and x == s):
                raise RuntimeError(f"segment {self.name!r}: argument {i} is "
                                   f"not the one its graph reads")
        self._launch(copies)
        return self._out

    def _launch(self, copies: int) -> None:
        try:
            self._graph.replay()
        except Exception as e:
            raise RuntimeError(f"replaying segment {self.name!r} failed: "
                               f"{e}") from e
        kernels.add_counts(self._delta)
        _stat(self._delta, replays=1, copies=copies)


class Runner:
    """The segments of one ``solve_batch`` call on ``device`` and the
    tensors they share; a context manager that releases the graphs, their
    pools and the held tensors at its exit."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphed = _captures(self.device)
        self.armed = False
        self._held: dict = {}       # id -> tensor, kept alive for the call
        self._opaque: dict = {}     # id -> constant held as one argument
        self._segments: list = []

    def _keep(self, t: torch.Tensor) -> torch.Tensor:
        self._held[id(t)] = t
        return t

    def stream(self):
        """The side stream that this thread's segments capture on, one a
        device for the thread's life.  cuBLAS keeps a workspace for each
        (handle, stream) from the stream's first product on: made inside a
        capture it would come from that graph's pool and hold the pool for
        good, so a few products on a new stream make it first, outside any
        capture."""
        streams = _TLS.__dict__.setdefault("streams", {})
        s = streams.get(self.device)
        if s is None:
            s = torch.cuda.Stream(device=self.device)
            s.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.device(self.device), torch.cuda.stream(s):
                for dt in (torch.float64, torch.float32):
                    m = torch.ones(2, 2, dtype=dt, device=self.device)
                    torch.addmm(m, m, m)
                    torch.bmm(m[None], m[None])
            torch.cuda.current_stream(self.device).wait_stream(s)
            streams[self.device] = s
        return s

    def hold(self, tree):
        """Hold ``tree``, a constant of the call, for the call: segments
        read its tensors in place and take ``tree`` itself as one
        argument, compared by identity."""
        self._opaque[id(tree)] = tree
        for t in tensors(tree):
            self._keep(t)
        return tree

    def buffers(self, tree):
        """A copy of ``tree`` in distinct tensors, held for the call: the
        state that a segment updates in place."""
        leaves: list = []
        spec = _flatten(tree, {}, leaves)
        return _unflatten(spec, iter([
            self._keep(x.clone()) if isinstance(x, torch.Tensor) else x
            for x in leaves]))

    def segment(self, name: str, fn) -> Segment:
        seg = Segment(self, name, fn)
        self._segments.append(seg)
        return seg

    def arm(self) -> None:
        """From now on a warm segment captures at its next call."""
        self.armed = True

    def close(self) -> None:
        for seg in self._segments:
            seg._graph = seg._out = seg._static = None
        self._segments.clear()
        self._held.clear()
        self._opaque.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
