"""The solve as captured CUDA graphs: the port's counterpart of the JAX
package's jit-compiled solve and of its cached executable.

``solver.solve_batch`` runs a solve as ``Segment``s of one ``Program``: the
prologue (equilibration, the KKT context, the init factor and its solves'
start), the init systems' refinement trip, the loop state's init, the
iteration's parts A, B and C with the two refinement trips (two
right-hand sides and one), and the finish.  A segment wraps a function of
tensors and runs it by the device of its program:

- CPU: the function is called, every time; nothing touches ``torch.cuda``.
- CUDA: a segment's first call runs the function eagerly as its warm-up
  (kernels built and loaded, caches filled, cuBLAS handles made), on
  scratch copies of the arguments it updates in place and with its
  kernel launches uncounted; the same call then captures the function
  into a ``torch.cuda.CUDAGraph`` on a side stream
  (``capture_error_mode="thread_local"``: a sharded solve captures from
  one host thread a device) and replays it; later calls replay only.

A ``Program`` lives as long as the solver object that owns it
(``api.Solver``, ``api.BatchedSolver``): it is captured at the first solve
and replayed by every later solve of its key (structure, settings, and
each input's shape, dtype and device), whose values are copied into the
program's static input buffers first.

Composed solve.  At the end of its first solve a kept program on the card
composes its segments into one CUDA graph (``compose``; ``_new_loop``,
``ops/graph_loop.py``): each segment's captured graph a child graph node,
each loop of the solve (init trip, iterations, the two refinement trips)
a conditional WHILE node whose body ends with S2, the kernel that sets
the node's handle to "not every lane done" and counts its own launches on
the card.  Every later solve of the program is its input copies, one
``launch`` and a copy of the result: no host read.  The host loop stays
for the first solve, CPU tensors, a live table and programs that no owner
keeps (module-level ``solve``).  The composed graph reads the program's
held tensors in place, so every argument of a composed segment call is
one (``Segment.compose`` raises otherwise), and a loop's body may hold
only the node types a conditional body allows (kernel, memset, memcpy
between device memory, empty, child graph, conditional; a segment with
another raises naming it).

Inputs.  A tensor that the program holds (``hold``: constants, the loop
state and every captured segment's outputs; ``buffers``: the input
buffers) is read in place by the graph, and every later call must pass
that same tensor; a held tuple is one argument, compared by identity.
Any other tensor is copied into a static buffer before each replay.
Other arguments must be the same objects (or equal scalars) at every
call.  Outputs are the captured tensors, and each
replay rewrites them in place: read a segment's outputs before it replays
again.  A segment that updates its inputs (``writes``) does so with
``copy_`` at its end, after it has computed every new value from the old
ones (the loop state in C, the refinement state in the trips), so no
replay reads a buffer it has already overwritten.

Pool.  A program's graphs share one memory pool.  A graph captured later
may take memory that an earlier one freed inside its capture, its
temporaries, and never memory that holds a tensor still alive.  Every
captured output is held until the program closes, so what two graphs share
is temporaries alone, which only the graph's own replay reads: they may
replay in any order, as the trips do (zero or more times an iteration),
one at a time on one stream.  The graphs, their pool and the held tensors
live until the program is closed: at the end of the call for a program
made by ``solve_batch`` alone, else by its owner, or when the owner is
garbage-collected.  Nothing made inside a capture may outlive the program
(see ``Program.stream``: cuBLAS's workspace would).

Counts.  A capture records the kernel launches that its function makes
(``kernels.recording``) and each replay adds them to ``kernels.COUNTS``,
so a graphed solve counts as the same solve run eagerly.  A composed
launch runs segments the host does not see: ``settle()`` reads each
composed program's trip counters (one host read a program) and adds each
segment's counts once a run, and S2's launches under ``loop_cond``, so a
settled composed solve counts as the host-driven one, whose loop tests
(its host syncs) are S2's launches.  ``STATS`` sums program solves,
captures, replays, input copies, eager calls (warm-ups included), capture
time, composed launches (``loops``), composing time, the port's kernel
launches made by replays (``graph_counts``) and those of the warm-ups,
which ``COUNTS`` leaves out (``warm_counts``), over every program;
``reset_stats`` drops composed launches not settled yet.  ``STATS``
"upload_bytes" counts the bytes ``solver.to_device`` placed on a device;
"kept_bytes" those of the device copies that an ``update_data`` kept for
the fields it was not given instead of placing them again (a broadcast
field's once), counted once an ``update_data``.

Tracing (``utils/timing``: on unless ``EICOS_TORCH_TRACE=0``, read as a
program composes).  A traced composed graph stamps the card's clock
(``ops/graph_loop.py``): its first and last nodes mark each launch's start
and end in a ring, and each S2 node closes the segment placed just before
it, so every segment's device time sums in a cell of its own, inside every
loop, with no node more than the two stamps a launch.  ``settle()`` reads
them with the trip counters, in the same one read: ``STATS``
"segments_ns" sums each segment's device time by its name, "launches"
lists each launch's device span ("device_ns") and its start and end on the
host's ``perf_counter_ns`` ("start_ns", "end_ns"), its index in its
program and its request; "stamps_overwritten" counts the launches whose
ring entry was overwritten before a settle read it.  The card's clock is
mapped onto the host's by two points, one taken at ``reset_stats`` and
one at ``settle`` (a stamp kernel launched outside any graph between two
synchronizes; "clock_err_ns" is the larger half-width).  ``settle()`` also copies the
host spans of ``utils/timing`` into ``STATS`` "spans" (dicts of
``timing.Span``'s fields) and "spans_dropped"; ``reset_stats`` empties
them.  ``host_driven()`` makes this thread's solves drive their segments
from the host even where a program has composed.

Probes (``Probes``, which the solver makes for a traced program of a
structure with cones before its first capture, so that its segments'
graphs hold them): the refinement steps of its solves (the finish adds
each solve's, summed over the lanes), the shape (nb, bwb) of the band it
factors (``band_shape``), on the card the panel ring its band sweeps take
(``sweep_ring``: (slots, bytes) by (bw, KT)), and the device time of the
regions inside its segments (``region(name)``: a stamp kernel at a
region's start and end, on a stamp block of the region's own): the cone
regions, each band factor ("band.factor") and each pair of band sweeps
("band.sweeps").  An LP program has none, so its graphs keep their nodes.
``settle()`` reads them with the trip counters: ``STATS`` "refine_steps",
"regions_ns" and "regions_runs" by region, "band_shape" and "sweep_ring",
keys that only a probed program adds.

Failures raise: a capture, replay, composition or composed launch that
fails raises ``RuntimeError`` naming the segment (or the CUDA call), and
nothing runs the segment eagerly or the solve from the host instead.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import NamedTuple, Optional

import torch

from .ops import kernels
from .ops.graph_loop import (END, LAST, LAUNCHES, OVERWRITTEN, RING,
                             STAMP_CELLS, STAMP_RING, STAMPS, START,
                             stamp_on)
from .utils import timing

STATS: dict = {}
_LOCK = threading.Lock()
# ``streams``: this thread's capture stream a device; ``host_driven``
_TLS = threading.local()
_SCALARS = (bool, int, float, str, type(None), torch.dtype, torch.device)
_PENDING: "weakref.WeakSet" = weakref.WeakSet()   # programs to settle
_STAMPED: "weakref.WeakSet" = weakref.WeakSet()   # traced composed programs
_PROBED: "weakref.WeakSet" = weakref.WeakSet()    # programs with probes


REGIONS = ("cones.scalings", "cones.kept_blocks", "cones.line_search",
           "band.factor", "band.sweeps")
REGION_CELLS = RING + 2 + 1     # a region's stamp block (a ring of one run)
#                                 and its accumulator


class Probes:
    """A traced program's probes on its device (module doc): ``cells`` is
    int64, cell 0 the refinement steps, then ``REGION_CELLS`` a region of
    ``regions`` (none off the card)."""

    def __init__(self, device: torch.device):
        self.regions = REGIONS if device.type == "cuda" else ()
        self.cells = torch.zeros(1 + REGION_CELLS * len(self.regions),
                                 dtype=torch.int64, device=device)
        self.band_shape: Optional[tuple] = None   # (nb, bwb) factored
        self.sweep_ring: dict = {}   # (bw, KT) -> the sweeps' (slots, bytes)

    def block(self, name: str) -> int:
        return 1 + REGION_CELLS * self.regions.index(name)

    def count_steps(self, steps: torch.Tensor) -> None:
        """Add ``steps`` (an integer tensor, summed) to the step count."""
        self.cells[:1].add_(steps.sum())


@contextlib.contextmanager
def region(name: str):
    """Time the block as the region ``name`` of the segment that runs it,
    where that segment's program probes the region (module doc); else
    nothing."""
    pr = getattr(_TLS, "probes", None)
    if pr is None or name not in pr.regions:
        yield
        return
    b = pr.block(name)
    stamp_on(pr.cells, b, START)
    yield
    stamp_on(pr.cells, b, END, acc=b + REGION_CELLS - 1)


def band_shape(nb: int, bwb: int) -> None:
    """Record (nb, bwb), the shape of the band that the segment running
    this factors, on its program's probes (module doc); else nothing."""
    pr = getattr(_TLS, "probes", None)
    if pr is not None:
        pr.band_shape = (nb, bwb)


def sweep_ring(bw: int, kt: int, ring: tuple) -> None:
    """Record ``ring``, the (slots, bytes) of the panel ring that the band
    sweeps of the segment running this take at bandwidth ``bw`` and width
    ``kt``, on its program's probes (module doc); else nothing."""
    pr = getattr(_TLS, "probes", None)
    if pr is not None:
        pr.sweep_ring[bw, kt] = ring


@contextlib.contextmanager
def _probing(probes: Optional[Probes]):
    prev = getattr(_TLS, "probes", None)
    _TLS.probes = probes
    try:
        yield
    finally:
        _TLS.probes = prev


def reset_stats() -> None:
    """Zero ``STATS`` and empty the span ring; composed launches not
    settled yet are dropped (their counters read as the new start), every
    program's probes read as their new start (what its first, host-driven
    solve counted included), and every traced program on the card takes
    its clock's first point."""
    for program in _take_pending():
        program.settle(add=False)
    with _LOCK:
        STATS.clear()
        STATS.update(solves=0, captures=0, replays=0, copies=0, eager=0,
                     capture_s=0.0, loops=0, compose_s=0.0, graph_counts={},
                     warm_counts={}, upload_bytes=0, kept_bytes=0,
                     segments_ns={}, launches=[], stamps_overwritten=0,
                     clock_err_ns=0, spans=[], spans_dropped=0)
        stamped = list(_STAMPED)
        probed = list(_PROBED)
    timing.clear_spans()
    for program in probed:
        program.rebase_probes()
    for program in stamped:
        program.start_clock()


def _take_pending() -> list:
    with _LOCK:
        out = list(_PENDING)
        _PENDING.clear()
    return out


def settle() -> None:
    """Add the segment replays and kernel launches of every composed
    launch since the last settle to ``kernels.COUNTS`` and ``STATS``,
    from the device's trip counters, with the stamps of a traced program:
    one host read a program.  Then copy the span ring into ``STATS``."""
    for program in _take_pending():
        program.settle()
    out = [s._asdict() for s in timing.spans()]
    with _LOCK:
        STATS["spans"] = out
        STATS["spans_dropped"] = timing.dropped()


@contextlib.contextmanager
def host_driven():
    """Inside the block this thread's solves, and the shard threads a
    sharded solve starts from it, drive their segments from the host
    (replays and one flag read a loop test) even where the program has
    composed: ``Program.launch`` returns None.  A profiler
    then sees a kept solver's warm solve kernel by kernel, which it does
    not inside a composed launch's conditional nodes."""
    prev = is_host_driven()
    _TLS.host_driven = True
    try:
        yield
    finally:
        _TLS.host_driven = prev


def is_host_driven() -> bool:
    """Whether this thread is inside ``host_driven()``."""
    return getattr(_TLS, "host_driven", False)


reset_stats()


def _stat(counts=None, warm=None, segments=None, **kw) -> None:
    with _LOCK:
        for k, v in kw.items():
            STATS[k] += v
        for key, add in (("graph_counts", counts), ("warm_counts", warm),
                         ("segments_ns", segments)):
            for k, v in (add or {}).items():
                STATS[key][k] = STATS[key].get(k, 0) + v


def count_upload(nbytes: int) -> None:
    """``nbytes`` placed on a device from the host (``solver.to_device``)."""
    _stat(upload_bytes=nbytes)


def count_kept(nbytes: int) -> None:
    """``nbytes`` of device copies kept instead of placed again
    (``solver.to_device`` under ``update_data``)."""
    _stat(kept_bytes=nbytes)


def _is_node(tree) -> bool:
    """Tuples, lists and NamedTuples are nodes of a tree."""
    typ = type(tree)
    return typ is tuple or typ is list or (isinstance(tree, tuple)
                                           and hasattr(typ, "_fields"))


def _flatten(tree, opaque: dict, leaves: list):
    """Append the leaves of ``tree`` to ``leaves`` and return its spec:
    nodes are flattened, except those in ``opaque`` (by id); anything else
    is a leaf."""
    if id(tree) not in opaque and _is_node(tree):
        return type(tree), tuple(_flatten(x, opaque, leaves) for x in tree)
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


def clone(tree):
    """A copy of ``tree`` in new tensors (the other leaves as they are)."""
    leaves: list = []
    spec = _flatten(tree, {}, leaves)
    return _unflatten(spec, iter([
        x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]))


def copy_into(dst, src) -> None:
    """``copy_`` every tensor of ``src`` into its place in ``dst``, a tree
    of the same structure."""
    for d, s in zip(tensors(dst), tensors(src), strict=True):
        d.copy_(s)


def _captures(device: torch.device) -> bool:
    """Segments on ``device`` capture graphs: CUDA tensors do."""
    return device.type == "cuda"


class _CudaGraph:
    """One ``torch.cuda.CUDAGraph``, captured on the program's side
    stream into the program's pool and replayed on the current stream."""

    def __init__(self, stream, pool):
        self.stream, self.pool = stream, pool
        # the captured graph stays valid after capture_end, to be composed;
        # the replay instantiates it at its first call
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

    def capture(self, fn, args):
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        # no cyclic collection inside the capture: a collected solver's
        # finalizer closes its program, and destroying a graph there
        # invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.stream.device), \
                    torch.cuda.stream(self.stream):
                self.graph.capture_begin(pool=self.pool,
                                         capture_error_mode="thread_local")
                try:
                    out = fn(*args)
                except BaseException:
                    with contextlib.suppress(Exception):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(self.stream)
        return out

    def replay(self) -> None:
        self.graph.replay()

    def raw(self) -> int:
        """The captured ``cudaGraph_t``."""
        return self.graph.raw_cuda_graph()


def _new_graph(program: "Program"):
    return _CudaGraph(program.stream(), program.pool())


class Loop(NamedTuple):
    """A loop of a composed plan: ``body`` (segments and loops) runs while
    not every entry of ``flag`` is true, tested before the first trip and
    after each; ``pre`` and ``trip`` are the trip counter slots of the two
    tests (``Program.compose``), ``pre_seg`` and ``trip_seg`` the segments
    called last before each test (None: none), whose device time a traced
    program's test closes."""

    flag: torch.Tensor
    body: tuple
    pre: int
    trip: int
    pre_seg: Optional["Segment"]
    trip_seg: Optional["Segment"]


class Stamps(NamedTuple):
    """Where a traced program's stamps live in its ``trips``: the stamp
    block's first cell (``ops/graph_loop.py``), each segment's accumulator
    by ``id`` of the segment, the plan's segments in the order of their
    first call, and the segment the launch's end stamp closes."""

    block: int
    acc: dict
    segments: tuple
    last: "Segment"

    def cells(self, seg) -> tuple:
        """The (block, accumulator) cells of a test that closes ``seg``;
        (None, None) where there is none, and the time runs on to the
        next test's segment."""
        return (None, None) if seg is None else (self.block,
                                                 self.acc[id(seg)])


def _new_loop(program: "Program", plan: tuple):
    """``plan`` as one CUDA graph (``ops/graph_loop.LoopGraph``), built and
    instantiated: a segment is a child graph node of its captured graph,
    a ``Loop`` an S2 node and a WHILE node whose body ends with another S2
    node; a traced program's plan between a start and an end stamp node.
    The nodes in a loop's body must be of the types a conditional
    body may hold (checked first, naming the segment).  The graph's
    ``instantiate_s`` and ``held_bytes`` (the device memory that
    instantiation took, by ``cudaMemGetInfo``) are what composing cost."""
    from .ops.graph_loop import LoopGraph

    free0 = torch.cuda.mem_get_info(program.device)[0]
    t0 = time.perf_counter()
    g = LoopGraph(program.device)
    st, trips = program.stamps, program.trips
    try:
        dep = None
        if st is not None:
            dep = g.stamp(g.root, None, trips, st.block, START)
        dep = _emit(g, g.root, plan, program, False, dep)
        if st is not None:
            g.stamp(g.root, dep, trips, st.block, END, st.acc[id(st.last)])
        g.instantiate()
    except BaseException:
        g.close()
        raise
    g.instantiate_s = time.perf_counter() - t0
    g.held_bytes = free0 - torch.cuda.mem_get_info(program.device)[0]
    return g


def _emit(g, root, items, program: "Program", in_body: bool, dep=None):
    """Add ``items`` to ``root``, a graph of ``g``, one after another,
    the first after ``dep``; returns the last node."""
    trips, st = program.trips, program.stamps

    def cond(graph, after, h, flag, slot, seg):
        cells = (None, None) if st is None else st.cells(seg)
        return g.cond(graph, after, h, flag, trips, slot, *cells)

    for it in items:
        if isinstance(it, Loop):
            h = g.handle(root)
            dep = cond(root, dep, h, it.flag, it.pre, it.pre_seg)
            node, body = g.while_(root, dep, h)
            last = _emit(g, body, it.body, program, True)
            cond(body, last, h, it.flag, it.trip, it.trip_seg)
            dep = node
            continue
        raw = it._graph.raw()
        try:
            if in_body:
                g.check(raw)
            dep = g.child(root, dep, raw)
        except RuntimeError as e:
            raise RuntimeError(f"composing segment {it.name!r} failed: "
                               f"{e}") from e
    return dep


def _composes(device: torch.device) -> bool:
    """Programs on ``device`` that an owner keeps compose their solve into
    one graph: CUDA tensors do."""
    return device.type == "cuda"


class Segment:
    """A function of tensors that a ``Program`` runs eagerly, or captures
    and then replays (module doc).  ``writes`` are the positions of the
    arguments that the function updates in place."""

    def __init__(self, program: "Program", name: str, fn, writes=()):
        self.program, self.name, self.fn = program, name, fn
        self.writes = frozenset(writes)
        self._graph = self._out = None

    def __call__(self, *args):
        if self._graph is not None:
            return self._replay(args)
        if not self.program.graphed:
            _stat(eager=1)
            return self._run(*args)
        self._warm_up(args)
        out = self._capture(args)
        self._launch(0)
        return out

    def _run(self, *args):
        """The function, with its program's probes on."""
        with _probing(self.program.probes):
            return self.fn(*args)

    @property
    def out(self):
        """The captured outputs, which every replay rewrites."""
        return self._out

    def compose(self, args) -> None:
        """Ready the segment for a composed graph that calls it with
        ``args``: captured (warmed up, not launched) if it never ran, and
        reading only tensors that the program holds, these same ones,
        since nothing is copied inside a composed launch."""
        if self._graph is None:
            self._warm_up(args)
            self._capture(args)
        leaves: list = []
        if _flatten(args, self.program._opaque, leaves) != self._spec:
            raise RuntimeError(f"segment {self.name!r}: arguments of another "
                               f"structure than at its capture")
        for i, (x, s) in enumerate(zip(leaves, self._static)):
            if i in self._copied or not (x is s or (
                    isinstance(x, _SCALARS) and type(x) is type(s)
                    and x == s)):
                raise RuntimeError(
                    f"segment {self.name!r}: a composed graph reads its "
                    f"arguments in place, and argument {i} is not the "
                    f"tensor the program holds for it")

    def _warm_up(self, args) -> None:
        """The eager call before the capture, on scratch copies of the
        arguments that the function writes, its launches not counted: the
        capture then finds every kernel built, cache filled and handle
        made."""
        with kernels.recording() as launched:
            self._run(*[clone(x) if i in self.writes else x
                        for i, x in enumerate(args)])
        _stat(eager=1, warm=launched)

    def _capture(self, args):
        r = self.program
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
                out = graph.capture(self._run,
                                    _unflatten(self._spec, iter(self._static)))
        except Exception as e:
            raise RuntimeError(f"capturing segment {self.name!r} failed: "
                               f"{e}") from e
        _stat(captures=1, capture_s=time.perf_counter() - t0)
        r.captures += 1
        r.hold(out)
        self._graph, self._out, self._delta = graph, out, delta
        return out

    def _replay(self, args):
        leaves: list = []
        if _flatten(args, self.program._opaque, leaves) != self._spec:
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



class Program:
    """The segments of a solve on ``device`` and the tensors they share,
    kept from one solve to the next (module doc); a context manager that
    releases them at its exit.  ``key`` is what the program was built for
    (``solver.program_key``); ``inputs`` its static input buffers
    (``load``), ``state`` the loop state and ``parts`` the solver's
    segments, all made by its first solve.  ``owner``: an object whose
    collection closes the program."""

    def __init__(self, device, key=None, owner=None):
        self.device = torch.device(device)
        self.graphed = _captures(self.device)
        # a kept program composes its solve at the end of its first
        self.composes = owner is not None and _composes(self.device)
        self.key = key
        self.inputs = self.state = self.parts = None
        self.probes: Optional[Probes] = None    # where traced (``probe``)
        self._probed: Optional[list] = None     # its cells at the settle
        self.captures = 0           # graphs captured by this program
        self._held: dict = {}       # id -> tensor, kept alive until close
        self._opaque: dict = {}     # id -> constant held as one argument
        self._segments: list = []
        self._pool = None           # the graphs' memory pool
        self._init_loop()
        self._finalizer = (None if owner is None
                           else weakref.finalize(owner, self.close))

    def _init_loop(self) -> None:
        self.loop = None            # the composed graph (``compose``)
        self.plan = self.result = self.trips = None
        self.stamps: Optional[Stamps] = None    # where traced
        self._counters = 0          # trip counter cells of ``trips``
        self._launches = 0          # composed launches made
        self._settled = (0, None)   # (launches, ``trips`` values) settled
        self._requests: list = []   # a launch's request, by ring entry
        self._clock: list = []      # (card ns, host ns, error ns) points

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

    def pool(self):
        """The memory pool that the program's graphs share (module doc)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def hold(self, tree):
        """Hold ``tree`` until the program closes: segments read its
        tensors in place and take it, and each node inside it, as one
        argument, compared by identity.  A captured output is held so."""
        if _is_node(tree):
            self._opaque[id(tree)] = tree
            for x in tree:
                self.hold(x)
        elif isinstance(tree, torch.Tensor):
            self._keep(tree)
        return tree

    def buffers(self, tree):
        """A copy of ``tree`` in distinct tensors, held until the program
        closes: the state that a segment updates in place."""
        out = clone(tree)
        for t in tensors(out):
            self._keep(t)
        return out

    def probe(self) -> Optional[Probes]:
        """The program's probes, made once, before any capture, where
        tracing is on (module doc); None where it is off."""
        if self.probes is None and timing.tracing():
            self.probes = Probes(self.device)
            self._keep(self.probes.cells)
            self._probed = [0] * self.probes.cells.shape[0]
            with _LOCK:
                _PROBED.add(self)
        return self.probes

    def rebase_probes(self) -> None:
        """Read the probes' cells as the start of the next settle's count
        (one host read)."""
        if self.probes is not None:
            self._probed = self.probes.cells.tolist()

    def segment(self, name: str, fn, writes=()) -> Segment:
        seg = Segment(self, name, fn, writes)
        self._segments.append(seg)
        return seg

    def load(self, data, adopt: bool = False):
        """The input buffers, holding ``data``'s values: made from its
        first ``data`` (as they are with ``adopt``, else copies), then
        written with each new ``data``'s values, except a field that is
        its buffer already, which is read in place.  Once a solve."""
        _stat(solves=1)
        if self.inputs is None:
            if adopt:
                self.inputs = data
                for t in tensors(data):
                    self._keep(t)
            else:
                self.inputs = self.buffers(data)
            return self.inputs
        copies = 0
        for buf, x in zip(tensors(self.inputs), tensors(data), strict=True):
            if x is not buf:
                buf.copy_(x)
                copies += 1
        _stat(copies=copies)
        return self.inputs

    def compose(self, steps) -> None:
        """Build the composed graph from ``steps(call, loop)``, a solve's
        control flow written against two functions: ``call(segment,
        *args)`` (records the call and returns the segment's captured
        outputs) and ``loop(flag, body)`` (records ``body()``'s calls as a
        ``Loop`` on ``flag``, a held tensor); what ``steps`` returns is
        the composed solve's result, rewritten by every launch.  Every
        segment called is captured first if it never ran (``Segment.
        compose``).  Raises ``RuntimeError`` if a segment, a node or the
        instantiation fails: nothing is run instead."""
        t0 = time.perf_counter()
        slots = [0]
        stack: list = [[]]
        order: dict = {}            # id -> segment, by first call
        last = [None]               # the segment called last

        def call(seg: Segment, *args):
            seg.compose(args)
            stack[-1].append(seg)
            order.setdefault(id(seg), seg)
            last[0] = seg
            return seg.out

        def loop(flag, body) -> None:
            if id(flag) not in self._held:
                raise RuntimeError("a composed loop's flag must be a tensor "
                                   "that the program holds")
            before = last[0]
            stack.append([])
            body()
            items = tuple(stack.pop())
            stack[-1].append(Loop(flag, items, slots[0], slots[0] + 1,
                                  before, last[0]))
            slots[0] += 2

        result = steps(call, loop)
        n = self._counters = slots[0]
        if timing.tracing() and last[0] is not None:
            segs = tuple(order.values())
            self.stamps = Stamps(n, {id(seg): n + STAMP_CELLS + k
                                     for k, seg in enumerate(segs)},
                                 segs, last[0])
            n += STAMP_CELLS + len(segs)
            self._requests = [0] * STAMP_RING
        self.trips = self._keep(torch.zeros(n, dtype=torch.int64,
                                            device=self.device))
        self.plan, self.result = tuple(stack[0]), result
        self.loop = _new_loop(self, self.plan)
        self._settled = (0, [0] * n)
        if self.stamps is not None:
            with _LOCK:
                _STAMPED.add(self)
            self.start_clock()
        _stat(compose_s=time.perf_counter() - t0)

    def launch(self):
        """The solve as one launch of the composed graph; returns the
        result, which the launch rewrites, or None where the program has
        not composed or ``host_driven()`` is open (the caller then drives
        the segments itself).  Spanned as "program.launch" with its index,
        by which ``settle`` joins the launch's stamps to its request."""
        if self.loop is None or is_host_driven():
            return None
        with timing.span("program.launch", launch=self._launches):
            try:
                self.loop.launch()
            except Exception as e:
                raise RuntimeError(f"launching the composed solve failed: "
                                   f"{e}") from e
            if self.stamps is not None:
                self._requests[self._launches % STAMP_RING] = \
                    timing.request()
        self._launches += 1
        _stat(loops=1)
        with _LOCK:
            _PENDING.add(self)
        return self.result

    def settle(self, add: bool = True) -> None:
        """Read the trip counters and the stamps (one host read, after a
        traced program's clock point) and, with ``add``, add what the
        composed launches since the last settle ran to ``kernels.COUNTS``
        and ``STATS``: each segment's captured counts once a run, S2's
        launches under ``loop_cond``, the stamp nodes' under
        ``loop_stamp`` (each counts its own launches on the card), and the
        stamps (module doc)."""
        first = self._settled[0]
        launches = self._launches - first
        if not launches:
            return
        st = self.stamps
        point = self._calibrate() if st is not None else None
        vals = self.trips.tolist()
        delta = [t - s for t, s in zip(vals, self._settled[1])]
        self._settled = (self._launches, vals)
        if st is not None:
            # read: the ring's entries may be written again
            self.trips[st.block + RING:st.block + STAMP_CELLS].zero_()
            if point is not None:
                self._clock[1:] = [(vals[st.block + LAST],) + point]
        probed = None
        if self.probes is not None:
            pv = self.probes.cells.tolist()
            probed = [v - s for v, s in zip(pv, self._probed)]
            self._probed = pv
        if not add:
            return
        if probed is not None:
            self._add_probes(probed)
        counts = {"loop_cond": sum(delta[:self._counters])}
        if st is not None:
            counts["loop_stamp"] = delta[st.block + STAMPS]
            self._add_stamps(st, vals, delta, first)
        replays = 0

        def run(items, n: int) -> None:
            nonlocal replays
            for it in items:
                if isinstance(it, Loop):
                    run(it.body, delta[it.trip])
                    continue
                replays += n
                for k, v in it._delta.items():
                    counts[k] = counts.get(k, 0) + v * n

        run(self.plan, launches)
        kernels.add_counts(counts)
        _stat(counts, replays=replays)

    def _add_probes(self, delta: list) -> None:
        """What the probes counted since the last settle into ``STATS``."""
        pr = self.probes
        with _LOCK:
            STATS["refine_steps"] = STATS.get("refine_steps", 0) + delta[0]
            if pr.band_shape is not None:
                STATS["band_shape"] = pr.band_shape
            if pr.sweep_ring:
                STATS.setdefault("sweep_ring", {}).update(pr.sweep_ring)
            for name in pr.regions:
                b = pr.block(name)
                for key, v in (("regions_ns", delta[b + REGION_CELLS - 1]),
                               ("regions_runs", delta[b + LAUNCHES])):
                    cell = STATS.setdefault(key, {})
                    cell[name] = cell.get(name, 0) + v

    def _add_stamps(self, st: Stamps, vals: list, delta: list,
                    first: int) -> None:
        """The stamps of launches ``first`` on, read as ``vals``, into
        ``STATS`` (module doc)."""
        out = []
        for i in range(max(first, self._launches - STAMP_RING),
                       self._launches):
            e = st.block + RING + 2 * (i % STAMP_RING)
            start, end = vals[e], vals[e + 1]
            if start and end:
                out.append(dict(index=i,
                                request=self._requests[i % STAMP_RING],
                                device_ns=end - start,
                                start_ns=self._on_host(start),
                                end_ns=self._on_host(end)))
        err = max((p[2] for p in self._clock), default=0)
        _stat(segments={seg.name: delta[st.acc[id(seg)]]
                        for seg in st.segments},
              stamps_overwritten=delta[st.block + OVERWRITTEN])
        with _LOCK:
            STATS["launches"].extend(out)
            STATS["clock_err_ns"] = max(STATS["clock_err_ns"], err)

    def _calibrate(self) -> Optional[tuple]:
        """(host ns, error ns) of one reading of the card's clock, which
        the stamp kernel writes into the stamp block's last cell, launched
        outside any graph between two synchronizes: the host time is their
        middle, the error half their distance.  None off the card."""
        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter_ns()
        self.loop.stamp_now(self.trips, self.stamps.block + LAST)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        return (t0 + t1) // 2, (t1 - t0) // 2

    def start_clock(self) -> None:
        """The clock's first point (``reset_stats``, ``compose``)."""
        point = self._calibrate()
        self._clock = [] if point is None else [
            (int(self.trips[self.stamps.block + LAST]),) + point]

    def _on_host(self, ns: int) -> int:
        """A reading of the card's clock on the host's ``perf_counter_ns``,
        through the clock's first and last points (the same clock where
        there are none: a CPU program's stamps are the host's)."""
        if not self._clock:
            return ns
        (g0, h0, _), (g1, h1, _) = self._clock[0], self._clock[-1]
        rate = (h1 - h0) / (g1 - g0) if g1 != g0 else 1.0
        return h0 + round((ns - g0) * rate)

    def close(self) -> None:
        """Release the graphs, their pool, the buffers and the held
        tensors; a later solve builds the program anew.  Composed
        launches not settled yet go uncounted."""
        if self._finalizer is not None:
            self._finalizer.detach()
        with _LOCK:
            _PENDING.discard(self)
            _STAMPED.discard(self)
            _PROBED.discard(self)
        if self.loop is not None:
            self.loop.close()
        self._init_loop()
        for seg in self._segments:
            seg._graph = seg._out = seg._static = None
        self._segments.clear()
        self._held.clear()
        self._opaque.clear()
        self._pool = None
        self.inputs = self.state = self.parts = None
        self.probes = self._probed = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
