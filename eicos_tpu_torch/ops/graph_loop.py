"""The program graph of a solve and its loop condition, S2 (``loop_cond``,
``csrc/graph_loop.cu``): the port's counterpart of the JAX package's
``lax.while_loop``s (``eicos_tpu/solver.py:635``, ``eicos_tpu/kkt.py:1205``
and ``:1246``), which run on the device with no host round trip.

``LoopGraph`` builds one CUDA graph node by node: child graph nodes (a
segment's captured graph, cloned), conditional WHILE nodes, and the kernel
nodes of S2, each after the node before it in its graph; then it is
instantiated, launched on the current stream and destroyed.  S2 sets its
WHILE node's handle to "not every flag true" and adds one to its trip
counter, an int64 entry of a tensor on the card, so that the launches a
composed solve made can be counted later with one read
(``graphs.settle``).  ``loop_cond_plain`` is S2's plain version: the CPU
interprets a plan with it (``tests/test_torch_loop.py``).

A traced program graph also stamps the card's clock (``csrc/graph_loop.cu``
says how): ``stamp`` adds the first and the last node of the root graph,
S2 given a stamp block closes the segment before it, and ``stamp_now``
reads the clock outside any graph, for the host's calibration.  The block
is ``STAMP_CELLS`` int64 cells of the program's trip-counter tensor: the
last stamp, the launches made, the ring entries overwritten before the
host read them, the stamp nodes' own launches, then a ring of
``STAMP_RING`` (start, end) pairs.
``stamp_on`` launches the stamp kernel on a stream, so that a segment's
capture holds it: a region inside the segment, on a block of its own.
``loop_stamp_plain`` and the stamped ``loop_cond_plain`` are the plain
versions, on a clock the caller passes.

Only a CUDA tensor reaches ``LoopGraph``; every failure raises
``RuntimeError`` with the CUDA call's message.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels


STAMP_RING = 1024          # launches a program's ring of stamps holds
LAST, LAUNCHES, OVERWRITTEN, STAMPS, RING = range(5)  # a stamp block's cells
STAMP_CELLS = RING + 2 * STAMP_RING
START, END, NOW = 0, 1, 2    # the stamp kernel's phases


def loop_cond_plain(flags: torch.Tensor, trips: torch.Tensor, slot: int,
                    block=None, acc=None, now: int = 0) -> torch.Tensor:
    """S2's plain version: ``~flags.all()`` (the next trip runs) with one
    added to ``trips[slot]``; with a stamp block (the index of its first
    cell in ``trips``), ``now`` minus the last stamp added to
    ``trips[acc]`` and ``now`` the last stamp."""
    trips[slot] += 1
    if block is not None:
        trips[acc] += now - trips[block + LAST]
        trips[block + LAST] = now
    return ~flags.all()


def loop_stamp_plain(trips: torch.Tensor, block: int, phase: int, now: int,
                     acc=None, ring: int = STAMP_RING) -> None:
    """The stamp kernel's plain version on the block at ``trips[block]``:
    ``START`` and ``END`` of a launch (``acc``: the finish's accumulator),
    or ``NOW``."""
    if phase != NOW:
        i = int(trips[block + LAUNCHES])
        e = block + RING + 2 * (i % ring)
        if phase == START:
            if int(trips[e]) != 0:
                trips[block + OVERWRITTEN] += 1
            trips[e], trips[e + 1] = now, 0
        else:
            trips[acc] += now - trips[block + LAST]
            trips[e + 1] = now
            trips[block + LAUNCHES] = i + 1
        trips[block + STAMPS] += 1
    trips[block + LAST] = now


def stamp_on(cells: torch.Tensor, block: int, phase: int,
             acc=None) -> None:
    """One stamp kernel launch on the current stream (a node of the
    segment's graph where that stream captures): ``START`` or ``END``
    (which adds the time since the start to ``cells[acc]``) on the stamp
    block at ``cells[block]``, a ring of one run (a region's block,
    ``graphs.Probes``).  Counted under ``loop_stamp``."""
    dev = cells.device
    if not (cells.dtype == torch.int64 and cells.dim() == 1
            and 0 <= block and block + RING + 2 <= cells.shape[0]
            and (acc is None or 0 <= acc < cells.shape[0])):
        raise ValueError(f"stamp_on: block {block}, acc {acc} of "
                         f"{cells.dtype} {tuple(cells.shape)}")
    base = cells.data_ptr()
    err = kernels.lib("graph_loop").eicos_loop_stamp_on(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        base + 8 * block, 1, None if acc is None else base + 8 * acc, phase,
        torch.cuda.current_stream(dev).cuda_stream)
    if err is not None:
        raise RuntimeError(f"eicos_loop_stamp_on: "
                           f"{err.decode(errors='replace')}")
    kernels.count("loop_stamp")


class LoopGraph:
    """One CUDA graph on ``device``, built node by node (module doc).
    ``root`` is the top-level graph; a graph argument is ``root`` or a
    WHILE node's body, a ``dep`` the node it follows in that graph (None:
    the first)."""

    def __init__(self, device: torch.device):
        self._index = (device.index if device.index is not None
                       else torch.cuda.current_device())
        self.device = torch.device(device.type, self._index)
        self._lib = kernels.lib("graph_loop")
        self.exec = None
        self.root = self._out("eicos_loop_create", self._index)

    def _call(self, name: str, *args) -> None:
        err = getattr(self._lib, name)(*args)
        if err is not None:
            raise RuntimeError(f"{name}: {err.decode(errors='replace')}")

    def _out(self, name: str, *args) -> int:
        out = ctypes.c_void_p()
        self._call(name, *args, ctypes.byref(out))
        return out.value

    def handle(self, graph) -> int:
        """A conditional handle for a node of ``graph``."""
        h = ctypes.c_ulonglong()
        self._call("eicos_loop_handle", graph, ctypes.byref(h))
        return h.value

    def while_(self, graph, dep, handle: int):
        """A WHILE node on ``handle``: (node, its body graph)."""
        body, node = ctypes.c_void_p(), ctypes.c_void_p()
        self._call("eicos_loop_while", graph, dep, handle,
                   ctypes.byref(body), ctypes.byref(node))
        return node.value, body.value

    def child(self, graph, dep, raw: int) -> int:
        """``raw`` (a ``cudaGraph_t``) cloned into a child graph node."""
        return self._out("eicos_loop_child", graph, dep, raw)

    def cond(self, graph, dep, handle: int, flags: torch.Tensor,
             trips: torch.Tensor, slot: int, block=None, acc=None) -> int:
        """An S2 node: set ``handle`` to "not all of ``flags``" and add one
        to ``trips[slot]``; with ``block`` and ``acc`` (cells of ``trips``),
        the time since the block's last stamp added to ``trips[acc]``.
        The node reads both tensors in place at every launch: the caller
        holds them as long as the graph."""
        kernels.check("flags", flags, tuple(flags.shape), self.device,
                      dtype=torch.bool)
        last = ptr = None
        if block is not None:
            last = self._cells(trips, block + LAST)
            ptr = self._cells(trips, acc)
        return self._out("eicos_loop_cond", graph, dep, handle,
                         flags.data_ptr(), flags.numel(),
                         self._cells(trips, slot), last, ptr)

    def stamp(self, graph, dep, trips: torch.Tensor, block: int, phase: int,
              acc=None) -> int:
        """A stamp kernel node (``START`` or ``END``, which adds the time
        since the last stamp to ``trips[acc]``) on the stamp block at
        ``trips[block]``."""
        self._cells(trips, block + STAMP_CELLS - 1)     # the block fits
        return self._out("eicos_loop_stamp", graph, dep,
                         self._cells(trips, block), STAMP_RING,
                         None if acc is None else self._cells(trips, acc),
                         phase)

    def stamp_now(self, trips: torch.Tensor, cell: int) -> None:
        """The card's clock into ``trips[cell]``, by one launch on the
        current stream outside any graph; counted nowhere."""
        self._call("eicos_loop_stamp_now", self._index,
                   self._cells(trips, cell), self._stream())

    def _cells(self, trips: torch.Tensor, cell: int) -> int:
        """The address of ``trips[cell]``, an int64 vector on the card."""
        kernels.check("trips", trips, tuple(trips.shape), self.device,
                      dtype=torch.int64)
        if trips.dim() != 1 or not 0 <= cell < trips.shape[0]:
            raise ValueError(f"trips: slot {cell} of {tuple(trips.shape)}")
        return trips.data_ptr() + 8 * cell

    def check(self, raw: int) -> None:
        """Raise ``RuntimeError`` naming the first node of ``raw`` that a
        conditional body may not hold."""
        self._call("eicos_loop_check", raw)

    def instantiate(self) -> None:
        """Instantiate the graph and upload it on the current stream."""
        self.exec = self._out("eicos_loop_instantiate", self._index,
                              self.root, self._stream())

    def launch(self) -> None:
        """One launch on the current stream."""
        self._call("eicos_loop_launch", self._index, self.exec,
                   self._stream())

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def close(self) -> None:
        """Destroy the executable and the graph."""
        if self.root is not None:
            root, ex, self.root, self.exec = self.root, self.exec, None, None
            self._call("eicos_loop_destroy", root, ex)
