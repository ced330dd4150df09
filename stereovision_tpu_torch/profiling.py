"""Stage-level profiling: the reference's Timer
(src/common_includes/elas/timer.{h,cpp}: named sections, grouped report)
plus a device trace through torch.profiler (counterpart of
stereovision_tpu/profiling.py, name for name), and the port's own spans.

A CUDA call returns before the card has run it, so `sync()` waits for the
card (torch.cuda.synchronize) before a section's clock stops.

Spans.  The engine's entry points and the host middle open spans named
"svtt.*" (span, root, frame), each recorded as a Span: its name, the frame
it belongs to, the enclosing span on the same thread, the thread, its
start and end on time.perf_counter_ns (CLOCK_MONOTONIC on Linux, one clock
for every process of the host) and its counts (keywords, or count() from
inside it).  Recording is off until trace_start() and costs one flag test
a span while off: span() returns the shared no-op NULL.  While it is on,
spans go into a bounded in-memory ring (the oldest dropped past RING) that
trace_drain() empties; in a process that has torch loaded, a span opened
while torch.profiler records on its thread also opens
torch.profiler.record_function(name), so that a profiler run
(device_trace) shows it beside the kernels it launched.  Without a
profiler a span costs a few us; a record_function ~20 us and, on an H100
machine's host, ~2-3 ms a frame of the eager ops it surrounds.
trace_start() takes an anchor, a (time.time_ns(), time.perf_counter_ns())
pair, which maps a span's times onto the profiler's (CLOCK_REALTIME) with
wall_ns().

This module imports no torch at import: the host middle (hostlib/) and the
host-geometry pool's spawned workers record spans without it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from collections import OrderedDict
from types import MappingProxyType
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

# the span ring's length: past it the oldest spans are dropped
RING = 65536


def sync(x):
    """Wait until the card has computed x (a tensor, or tuples, lists and
    dicts of them); nothing to wait for on the CPU.  Returns x."""
    import torch
    if torch.is_tensor(x):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (tuple, list)):
        for leaf in x:
            sync(leaf)
    elif isinstance(x, dict):
        for leaf in x.values():
            sync(leaf)
    return x


class StageTimer:
    """Named-section wall-clock profiler (reference Timer semantics:
    start(name) closes the previous section; plot() prints a grouped
    report, timer.cpp:56-72)."""

    GROUPS = OrderedDict([
        ("Pre", ("Grayscale", "Descriptor", "Support Matches",
                 "Delaunay Triangulation", "Disparity Planes", "Grid")),
        ("Disparity", ("Matching",)),
        ("Post", ("L/R Consistency Check", "Remove Small Segments",
                  "Gap Interpolation", "Adaptive Mean", "Median",
                  "Reprojection")),
    ])

    def __init__(self):
        self.sections: "OrderedDict[str, float]" = OrderedDict()
        self._current: Optional[str] = None
        self._t0 = 0.0

    def start(self, name: str):
        now = time.perf_counter()
        if self._current is not None:
            self.sections[self._current] = (
                self.sections.get(self._current, 0.0) + now - self._t0)
        self._current = name
        self._t0 = now

    def stop(self):
        if self._current is not None:
            now = time.perf_counter()
            self.sections[self._current] = (
                self.sections.get(self._current, 0.0) + now - self._t0)
            self._current = None

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.stop()

    def report(self) -> str:
        self.stop()
        lines = []
        total = sum(self.sections.values())
        grouped = {g: 0.0 for g in self.GROUPS}
        for name, t in self.sections.items():
            lines.append(f"  {name:<28s} {t * 1000:8.2f} ms")
            for g, members in self.GROUPS.items():
                if name in members:
                    grouped[g] += t
        for g, t in grouped.items():
            if t > 0:
                lines.append(f"  [{g:<26s}] {t * 1000:8.2f} ms")
        lines.append(f"  {'TOTAL':<28s} {total * 1000:8.2f} ms")
        return "\n".join(lines)

    def plot(self):
        print(self.report())


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[str]:
    """torch.profiler around the block: host activity, and the card's
    kernels where CUDA is available; on exit a Chrome trace (viewable in
    chrome://tracing or Perfetto) is written into logdir.  Yields the
    trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace_%d_%d.json" % (os.getpid(),
                                                      time.time_ns()))
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def profile_pipeline(engine, left, right, n: int = 3) -> Dict[str, float]:
    """Per-stage timing of one ElasEngine frame (engine: a StereoEngine),
    with the card synchronised after each stage.  Returns {section:
    seconds} (best of n)."""
    from .engine import bgr_to_gray

    e = engine.elas
    best: Dict[str, float] = {}
    for _ in range(n):
        t = StageTimer()
        with t.section("Grayscale"):
            g1, g2 = bgr_to_gray(left), bgr_to_gray(right)
        with t.section("Descriptor+Support (device)"):
            desc1, desc2, d_can = sync(e.stage_support(g1, g2))
        with t.section("Host geometry"):
            g = e.host_mid(d_can.cpu().numpy())
        with t.section("Matching+Post (device)"):
            # the geometry goes to the engine's device in one packed upload
            sync(e.stage_dense(desc1, desc2, *e.upload_geometry(g)))
        for k, v in t.sections.items():
            best[k] = min(best.get(k, 1e9), v)
    return best


# ---- spans -----------------------------------------------------------------

class Span(NamedTuple):
    """One recorded span.  parent and id number the spans of a process;
    thread_id is the OS thread id (threading.get_native_id), unique across
    the host's processes."""
    name: str
    frame_id: Optional[int]
    parent: Optional[int]
    thread_id: int
    t0_ns: int
    t1_ns: int
    counts: dict
    id: int


class Ids:
    """Consecutive ids handed out under a lock (an engine's frame and
    batch numbers): take(n) reserves n and returns the first."""

    def __init__(self):
        self._next = 0
        self._lock = threading.Lock()

    def take(self, n: int = 1) -> int:
        with self._lock:
            first = self._next
            self._next += n
        return first


class _Recorder:
    """The process's span recording: the switch, the ring, the anchor, and
    each thread's open spans and current frame."""

    def __init__(self):
        self.on = False
        self.ring: "collections.deque[tuple]" = collections.deque(
            maxlen=RING)
        # span ids (next() of an itertools.count is atomic under the GIL)
        self.ids = itertools.count()
        self.anchor: Optional[Tuple[int, int]] = None
        # torch.profiler.record_function, and whether the profiler records
        # on the calling thread; None where torch is not loaded
        self.record_function = self.profiling = None
        self.local = threading.local()

    def stack(self) -> list:
        loc = self.local
        if not hasattr(loc, "stack"):
            # the OS thread id once a thread: threading.get_native_id()
            # took 6-10 us a call on an H100 machine's host CPU
            loc.stack, loc.frame, loc.last_frame = [], None, None
            loc.tid = threading.get_native_id()
        return loc.stack


_REC = _Recorder()


class _NullSpan:
    """What span() returns while recording is off: enters, counts and
    records nothing."""
    __slots__ = ()
    id = frame_id = None
    counts = MappingProxyType({})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


NULL = _NullSpan()


class _Span:
    """An open span; recorded into the ring when it closes."""
    __slots__ = ("name", "counts", "frame_id", "parent", "id", "t0",
                 "_root", "_outer", "_rf", "_stack")

    def __init__(self, name: str, counts: dict, root: bool = False,
                 frame_id: Optional[int] = None):
        self.name, self.counts = name, counts
        self._root, self.frame_id = root, frame_id

    def __enter__(self):
        rec = _REC
        self._stack = stack = rec.stack()
        self.id = next(rec.ids)
        if self._root:
            # a root has no parent and sets its thread's current frame
            self.parent, self._outer = None, rec.local.frame
            rec.local.frame = self.frame_id
        else:
            self.parent = stack[-1].id if stack else None
            self.frame_id = rec.local.frame
        stack.append(self)
        self._rf = None
        if rec.record_function is not None and rec.profiling():
            self._rf = rec.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        rec = _REC
        self._stack.pop()
        if self._root:
            rec.local.frame = self._outer
            rec.local.last_frame = self.frame_id
        # plain tuples in the ring; Span when drained
        rec.ring.append((self.name, self.frame_id, self.parent,
                         rec.local.tid, self.t0, t1, self.counts, self.id))
        return False

    def add(self, **counts) -> None:
        self.counts.update(counts)


def recording() -> bool:
    """Whether spans are being recorded."""
    return _REC.on


def span(name: str, **counts):
    """A span around the with-block, a child of the thread's innermost
    open span, in its current frame; NULL while recording is off."""
    if not _REC.on:
        return NULL
    return _Span(name, counts)


def root(name: str, frame_id: Optional[int], **counts):
    """A span with no parent that makes frame_id its thread's current
    frame for the block (spans opened inside carry it); NULL while
    recording is off."""
    if not _REC.on:
        return NULL
    return _Span(name, counts, root=True, frame_id=frame_id)


def frame(ids: Ids, entry: str):
    """The root span "svtt.frame" of one frame through an entry point:
    its frame id the next of `ids`, its count "entry" the entry point's
    name; NULL while recording is off (no id is taken)."""
    if not _REC.on:
        return NULL
    return _Span("svtt.frame", {"entry": entry}, root=True,
                 frame_id=ids.take())


@contextlib.contextmanager
def _frame_scope(frame_id: Optional[int]) -> Iterator[None]:
    rec = _REC
    rec.stack()
    outer, rec.local.frame = rec.local.frame, frame_id
    try:
        yield
    finally:
        rec.local.frame = outer


def in_frame(frame_id: Optional[int]):
    """Make frame_id the thread's current frame for the block, without a
    span (work handed to another thread); NULL while recording is off."""
    if not _REC.on:
        return NULL
    return _frame_scope(frame_id)


def current_frame() -> Optional[int]:
    """The calling thread's current frame id (set by root, frame and
    in_frame)."""
    _REC.stack()
    return _REC.local.frame


def last_frame() -> Optional[int]:
    """The frame id of the root span (root or frame) that the calling
    thread closed last: work done for a frame after its entry point
    returned opens its own root in it."""
    _REC.stack()
    return _REC.local.last_frame


def count(**counts) -> None:
    """Add counts to the thread's innermost open span (none while
    recording is off, or outside every span)."""
    if _REC.on:
        stack = _REC.stack()
        if stack:
            stack[-1].counts.update(counts)


def record(name: str, t0_ns: int, t1_ns: int, **counts) -> None:
    """A span with given times (a wait measured across threads), a child
    of the thread's innermost open span, in its current frame."""
    rec = _REC
    if not rec.on:
        return
    stack = rec.stack()
    rec.ring.append((name, rec.local.frame, stack[-1].id if stack else None,
                     rec.local.tid, int(t0_ns), int(t1_ns), counts,
                     next(rec.ids)))


def ingest(spans: Iterable, frame_id: Optional[int]) -> None:
    """Spans recorded in another process (a pool worker's trace_drain()
    spans) into this process's ring: renumbered, in frame `frame_id`, their
    roots children of the thread's innermost open span."""
    rec = _REC
    if not rec.on:
        return
    spans = [Span(*s) for s in spans]
    stack = rec.stack()
    top = stack[-1].id if stack else None
    new = {s.id: next(rec.ids) for s in spans}
    for s in spans:
        rec.ring.append(s._replace(frame_id=frame_id, id=new[s.id],
                                   parent=new.get(s.parent, top)))


def _anchor() -> Tuple[int, int]:
    """(time.time_ns(), time.perf_counter_ns()) read together: of five
    tries, the one whose two perf_counter_ns readings around the
    time_ns() lie closest."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        w = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, w, (p0 + p1) // 2)
    return best[1], best[2]


def trace_start() -> Tuple[int, int]:
    """Turn recording on and take the anchor; returns the anchor.  Where
    torch is loaded, spans opened under torch.profiler also open
    torch.profiler.record_function."""
    rec = _REC
    torch = sys.modules.get("torch")
    if torch is not None:
        rec.record_function = torch.profiler.record_function
        rec.profiling = torch.autograd._profiler_enabled
    rec.anchor = _anchor()
    rec.on = True
    return rec.anchor


def trace_stop() -> None:
    """Turn recording off (the ring keeps what it holds)."""
    _REC.on = False


def trace_drain() -> dict:
    """{"spans": the spans recorded since the last drain, oldest first,
    "anchor": trace_start()'s anchor}; empties the ring."""
    ring, out = _REC.ring, []
    while True:
        try:
            out.append(Span._make(ring.popleft()))
        except IndexError:
            break
    return {"spans": out, "anchor": _REC.anchor}


def wall_ns(t_ns: int, anchor: Tuple[int, int]) -> int:
    """A span's time (perf_counter_ns) on CLOCK_REALTIME, the clock of
    torch.profiler's events (trace_start_ns() + time_range * 1000)."""
    return anchor[0] + (t_ns - anchor[1])
