"""Device stages replayed from CUDA graphs: the port's counterpart of a
jitted stage (the JAX package's jax.jit of _stage_support_impl and
_stage_dense_impl, and its one-dispatch mode, ElasEngine.process_jit at
stereovision_tpu/models/elas.py:404-421).

StageGraph runs a device function on fixed-shape tensors.  On a CUDA device
it takes the example inputs it is given as its static inputs, runs the
function once eagerly on the current stream (the warm-up, which does the
one-time work that must not happen under capture: building the kernel
library, the wrappers' cudaFuncSetAttribute and device-attribute queries,
the resident prior table and the cloud's resize taps, each synchronised
where it is made), and captures it into a torch.cuda.CUDAGraph on a side
stream.  Each call then copies its inputs into the static ones
(non_blocking; an input that is the static tensor itself is not copied) and
replays the graph on the current stream: every kernel of the stage from one
launch.  It hands back the static outputs, which the next replay of the
same instance overwrites: the caller clones or fetches them first.

Capture runs with capture_error_mode="thread_local": only this thread's
calls are checked, so other threads of the process (a previous stream's
workers, the command line's detection thread) may go on launching and
allocating while a stage is captured.  A ReplayTurn's graphs are
captured on the thread that takes its first turn.  Python's cyclic garbage
collector is paused while any capture is under way: a collection runs
the destructors of unreachable objects on the thread it happens to run on,
and destroying a CUDA graph there (an engine left in a reference cycle with
its process_jit) voids a capture under way.

The kernel wrappers' launch counters (ops/cuda/*_cu.py) count in Python,
which a replay does not run: the capture records the counts of the
wrappers it calls (ops.cuda._lib.recording), and every replay adds them.

On a CUDA device capture is mandatory: a capture or replay that fails
raises RuntimeError naming the stage, and nothing runs the eager path
instead.  On the CPU there is no graph: the object calls the function.

ReplayTurn is the one schedule of a frame through such graphs, shared by
ElasEngine.process_jit and StereoEngine.process_frame: the graphs made at
the first turn, one turn at a time, and each turn's replays ordered after
the last turn's clones of the outputs they overwrite.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from .ops.cuda import _lib


class StageGraph:
    """fn on fixed-shape tensors, replayed from a CUDA graph on the card
    and called eagerly on the CPU.

    fn(*inputs) returns a tensor or a tuple of tensors.  inputs: tensors on
    `device` that become the static inputs (shapes and dtypes fixed from
    here on; they may be another StageGraph's outputs, which are then read
    in place).  pool: another StageGraph's `pool`, whose memory this
    graph shares (stages replayed one after the other on one stream).
    graph: the graph class, torch.cuda.CUDAGraph by default on a CUDA
    device; given on the CPU (a stand-in), it is captured and replayed
    there too.  capture_s: the host seconds of the capture proper (the
    warm-up before it not included)."""

    def __init__(self, name: str, fn: Callable, inputs: Sequence = (),
                 device=None, pool=None, graph=None):
        self.name = name
        self.fn = fn
        self.device = torch.device(device if device is not None
                                   else inputs[0].device)
        self.static = tuple(inputs)
        self.graph = None
        self.outputs = None
        self.counts = []
        self.capture_s = 0.0
        cuda = self.device.type == "cuda"
        if graph is None and not cuda:
            return
        graph = graph or torch.cuda.CUDAGraph
        try:
            fn(*self.static)
            self.graph = graph()
            side = torch.cuda.Stream(self.device) if cuda else None
            if cuda:
                side.wait_stream(torch.cuda.current_stream(self.device))
            with (torch.cuda.stream(side) if cuda
                  else contextlib.nullcontext()), \
                    _lib.recording() as counts, _collector_paused():
                t = time.perf_counter()
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    self.outputs = fn(*self.static)
                finally:
                    self.graph.capture_end()
                self.capture_s = time.perf_counter() - t
            if cuda:
                torch.cuda.current_stream(self.device).wait_stream(side)
        except Exception as err:
            raise RuntimeError("%s: CUDA graph capture failed" % name) \
                from err
        self.counts = counts

    @property
    def pool(self):
        """The graph's memory pool (None without a graph)."""
        return self.graph.pool() if self.graph is not None else None

    def __call__(self, *inputs):
        """Run the stage on inputs (NumPy arrays or tensors of the static
        inputs' shapes): on the card, copy them in and replay, returning
        the static outputs; on the CPU, call fn on them."""
        if self.graph is None:
            return self.fn(*(torch.as_tensor(x).to(self.device)
                             for x in inputs))
        if len(inputs) != len(self.static):
            raise ValueError("%s: %d inputs, expected %d"
                             % (self.name, len(inputs), len(self.static)))
        for dst, x in zip(self.static, inputs):
            if x is dst:
                continue
            src = torch.as_tensor(np.ascontiguousarray(x)
                                  if isinstance(x, np.ndarray) else x)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError("%s: an input of %s %s for a static input "
                                 "of %s %s" % (self.name, tuple(src.shape),
                                               src.dtype, tuple(dst.shape),
                                               dst.dtype))
            if src.device.type == "cpu" and self.device.type == "cuda":
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)
        try:
            self.graph.replay()
        except RuntimeError as err:
            raise RuntimeError("%s: CUDA graph replay failed" % self.name) \
                from err
        _lib.add_counts(self.counts)
        return self.outputs


class ReplayTurn:
    """One frame at a time through graphs whose replays overwrite their
    static outputs.  `with turn(make) as graphs:` takes the turn's lock
    (callers on several threads take turns), makes the graphs with make()
    at the first turn (kept until close()), and on the card orders the
    current stream after the event recorded at the end of the last turn,
    that is after its clones and fetches of the outputs that this turn's
    replays overwrite; a turn that ends without an exception records that
    event.  graphs: the list make() gave, empty until the first turn and
    after close()."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs = []
        self._lock = threading.Lock()
        self._done = None

    @contextlib.contextmanager
    def __call__(self, make: Callable[[], Sequence[StageGraph]]):
        with self._lock:
            if not self.graphs:
                self.graphs.extend(make())
            if self._done is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    self._done)
            yield tuple(self.graphs)
            if self.device.type == "cuda":
                self._done = torch.cuda.Event()
                self._done.record()

    def close(self):
        """Drop the graphs (and their memory, once no one else holds
        them); the next turn makes new ones."""
        self.graphs.clear()


# captures under way in the process, and whether the collector was on
# before the first of them: gc.disable()/enable() act on the whole process
_gc_lock = threading.Lock()
_gc_state = {"depth": 0, "was_on": False}


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector off within the block.  Captures
    on several threads may overlap: the first to enter turns it off, and
    the last to leave turns it on again if it was on at the first entry."""
    with _gc_lock:
        if _gc_state["depth"] == 0:
            _gc_state["was_on"] = gc.isenabled()
            gc.disable()
        _gc_state["depth"] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_state["depth"] -= 1
            if _gc_state["depth"] == 0 and _gc_state["was_on"]:
                gc.enable()
