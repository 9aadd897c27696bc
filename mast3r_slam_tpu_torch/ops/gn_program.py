"""Device programs of the Gauss-Newton loops, shared by the tracking GN
(``ops/tracking_gn.py``) and the global GN (``ops/global_gn.py``).

A program runs a loop that the JAX package runs as ``lax.while_loop`` on
the device: the loop's pieces, captured once each in CUDA graphs over
static buffers, joined under WHILE conditional nodes (``csrc/gn_while.cu``)

    [prologue] -> WHILE { [body] -> continue }

or, with a loop inside the iteration (the global GN's CG loop),

    [prologue] -> WHILE { [pre] -> test -> WHILE { [step] -> continue }
                          -> [post] -> continue }

so that one launch runs the iterations the JAX loop runs and the host
reads nothing.  A call copies its inputs into the static buffers, launches
the graph on the current stream and clones the outputs (two calls in
flight never share them); a call from another stream first waits for the
previous call's end.

``ProgramCache`` keeps the programs of one loop by key while the memory
they hold on a device stays within ``PROGRAM_BYTES``, the least recently
used dropped first.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from . import kernels

# the memory that one loop's programs may hold on a device: each holds its
# static buffers and its captures' pool
PROGRAM_BYTES = 4 << 30


class Loop(NamedTuple):
    """A WHILE node's state: it repeats while ``active`` (a bool scalar on
    the card) holds and ``iters`` (int32, counted by the node's kernel) is
    below ``max_iters``."""

    active: torch.Tensor
    iters: torch.Tensor
    max_iters: int


class Program:
    """One loop as a device program.  ``make(inputs)`` returns the pieces over
    the static ``inputs``: ``warm_up()`` (run once on a side stream before
    the captures, so that library handles and workspaces exist), ``parts()``
    (the callables captured in order: prologue and body, or prologue, pre,
    step and post), ``loops`` (the outer ``Loop`` and the inner one or None)
    and ``outputs()`` (the tensors a call returns clones of).  ``counter``
    counts the launches.  A build that fails raises."""

    def __init__(self, make, inputs, counter: kernels.LaunchCounter):
        dev = inputs[0].device
        self.device = dev
        self.counter = counter
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.closed = False
        with torch.cuda.device(dev):
            self.inputs = tuple(torch.empty_like(a) for a in inputs)
            self.pieces = p = make(self.inputs)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._fill(inputs)
                p.warm_up()
            torch.cuda.current_stream(dev).wait_stream(side)
            # thread_local: another thread (the tracker, the backend's
            # worker) may use the card meanwhile.  One memory pool for the
            # captures, which run in their capture order
            pool = torch.cuda.graph_pool_handle()
            self.graphs = []
            for part in p.parts():
                g = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(g, pool=pool, capture_error_mode="thread_local"):
                    part()
                self.graphs.append(g)
            raw = [g.raw_cuda_graph() for g in self.graphs]
            outer, inner = p.loops
            flags = lambda loop: (loop.active.data_ptr(), loop.iters.data_ptr(),
                                  loop.max_iters)
            exec_ = ctypes.c_void_p()
            name = "gn_while_build" + ("_nested" if inner is not None else "")
            args = flags(outer) + (flags(inner) if inner is not None else ())
            kernels.check(kernels.entry_point(name)(*raw, *args, ctypes.byref(exec_)), name)
            self.exec = exec_.value
            self.done.record(torch.cuda.current_stream(dev))
            # what it holds: the static inputs and the captures' pool (the
            # pieces' own buffers, a few scalars and vectors, aside)
            self.nbytes = sum(a.numel() * a.element_size() for a in self.inputs) + sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == tuple(pool))

    def _fill(self, inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)

    def __call__(self, inputs) -> Optional[tuple]:
        """Clones of the outputs, or None once the program is closed."""
        with self.lock, torch.cuda.device(self.device):
            if self.closed:
                return None
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.done)
            self._fill(inputs)
            kernels.check(kernels.entry_point("gn_while_launch")(
                self.exec, stream.cuda_stream), "gn_while_launch")
            self.counter.add()
            out = tuple(a.clone() for a in self.pieces.outputs())
            self.done.record(stream)
        return out

    def close(self):
        """Free the executable graph and the captures' memory, once the last
        launch has ended."""
        with self.lock:
            if self.closed:
                return
            self.closed = True
            self.done.synchronize()
            kernels.check(kernels.entry_point("gn_while_destroy")(self.exec),
                          "gn_while_destroy")
            self.graphs, self.pieces, self.inputs = [], None, ()


class ProgramCache:
    """One loop's programs by key, least recently used first.  A program
    built on a device drops that device's least recently used others until
    what they hold there, its own included, is within ``PROGRAM_BYTES``
    (the new one is kept whatever its size).  Programs are built under the
    cache's lock."""

    def __init__(self):
        self._programs: "OrderedDict[tuple, Program]" = OrderedDict()
        self._lock = threading.Lock()
        self.built = 0  # programs built so far

    def run(self, key: tuple, build, inputs) -> tuple:
        """The outputs of the program of ``key`` (``build()`` makes it at its
        first call) on ``inputs``."""
        while True:
            with self._lock:
                prog = self._programs.get(key)
                if prog is None:
                    prog = self._programs[key] = build()
                    self.built += 1
                    same = [k for k, p in self._programs.items() if p.device == prog.device]
                    held = sum(self._programs[k].nbytes for k in same)
                    for k in same[:-1]:
                        if held <= PROGRAM_BYTES:
                            break
                        held -= self._programs[k].nbytes
                        self._programs.pop(k).close()
                else:
                    self._programs.move_to_end(key)
            out = prog(inputs)
            if out is not None:  # else dropped meanwhile: build it again
                return out

    def program(self, key: tuple) -> Optional[Program]:
        """The program of ``key`` if it is kept."""
        with self._lock:
            return self._programs.get(key)

    def held(self) -> list:
        """(key, bytes held) of the programs kept, least recently used first."""
        with self._lock:
            return [(k, p.nbytes) for k, p in self._programs.items()]

    def clear(self) -> None:
        """Drop every program (its graph and captured memory)."""
        with self._lock:
            while self._programs:
                self._programs.popitem(last=False)[1].close()
