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

Only a CUDA tensor reaches ``LoopGraph``; every failure raises
``RuntimeError`` with the CUDA call's message.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels


def loop_cond_plain(flags: torch.Tensor, trips: torch.Tensor,
                    slot: int) -> torch.Tensor:
    """S2's plain version: ``~flags.all()`` (the next trip runs) with one
    added to ``trips[slot]``."""
    trips[slot] += 1
    return ~flags.all()


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
             trips: torch.Tensor, slot: int) -> int:
        """An S2 node: set ``handle`` to "not all of ``flags``" and add one
        to ``trips[slot]``.  The node reads both tensors in place at every
        launch: the caller holds them as long as the graph."""
        kernels.check("flags", flags, tuple(flags.shape), self.device,
                      dtype=torch.bool)
        kernels.check("trips", trips, tuple(trips.shape), self.device,
                      dtype=torch.int64)
        if trips.dim() != 1 or not 0 <= slot < trips.shape[0]:
            raise ValueError(f"trips: slot {slot} of {tuple(trips.shape)}")
        return self._out("eicos_loop_cond", graph, dep, handle,
                         flags.data_ptr(), flags.numel(),
                         trips.data_ptr() + 8 * slot)

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
