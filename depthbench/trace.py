"""What a traced run reads: the benchmark's own spans around the port's
layers, and torch.profiler over a stretch of the measured window.

Spans wrap methods of the engine's instances (stage A, host middle, stage
B, reprojection) in torch.profiler.record_function and a host clock; they
are installed in traced runs only.  The profiler's reading follows
chip_smoke.py's profile(): the union of the device's busy intervals against
the host's wall time, device seconds by kernel and by every op's name, the
runtime's launch calls (every CPU event whose name holds "Launch"), and
device seconds by the program's own spans ("svtt.*", recorded by the
profiler where the program's span recording is on).
"""

from __future__ import annotations

import functools
import re
import time
from typing import Dict, List, Tuple

import numpy as np

# the port's kernels by their __global__ names; K3's call is one ccl_apply
KERNEL_NAMES = {"K1": ("match_keys_kernel",),
                "K2": ("support_scan_kernel",),
                "K3": ("ccl_local", "ccl_border", "ccl_count", "ccl_apply"),
                "K4": ("lr_check_kernel",)}
CALL_KERNEL = {"K1": "match_keys_kernel", "K2": "support_scan_kernel",
               "K3": "ccl_apply", "K4": "lr_check_kernel"}
# the span names, "depthbench.<what>", of the wrapped methods
SPANS = {"elas": ("stage_support", "stage_support_batched", "host_mid",
                  "host_mid_parallel", "stage_dense"),
         "engine": ("reproject",)}
# the CUDA runtime calls that launch device work (kernels, copies, sets,
# graph replays): a device op's correlation id names one of them
RUNTIME = ("cuda", "cu")
SHORT_GAP_S = 50e-6     # idle gaps below this are summed as one entry
TOP = 10


def short_name(name: str) -> str:
    """"void ns::foo<...>(...)" -> "ns::foo", at most 60 characters."""
    return re.split(r"[<(]", name.replace("(anonymous namespace)::", "")
                    .removeprefix("void "))[0].strip()[:60]


def install_spans(served) -> Dict[str, List[float]]:
    """Wrap the layer methods of the stereo engine that the served object
    is, or holds as .engine (instance attributes shadow the class's);
    returns span name -> list of host seconds, filled as they run (threads
    append to their own list entry; list.append is atomic).  A served
    object with no such engine gets no spans."""
    import torch
    engine = served if hasattr(served, "elas") else \
        getattr(served, "engine", None)
    spans: Dict[str, List[float]] = {}
    if engine is None:
        return spans
    for owner, names in (("elas", SPANS["elas"]), ("engine", SPANS["engine"])):
        obj = engine.elas if owner == "elas" else engine
        for name in names:
            fn = getattr(obj, name)
            spans[name] = []

            def wrapped(*a, _fn=fn, _out=spans[name], _tag="depthbench."
                        + name, **k):
                t = time.perf_counter()
                with torch.profiler.record_function(_tag):
                    r = _fn(*a, **k)
                _out.append(time.perf_counter() - t)
                return r
            setattr(obj, name, functools.wraps(fn)(wrapped))
    return spans


class Tracer:
    """Profiles frames [start, start + count) of a window: frame(i) is
    called before frame i is sent (or after frame i is emitted); the
    device is synchronised at both ends.  warm() starts and stops the
    profiler once in set-up: its first start initialises CUPTI, which
    took ~9 s on an H100 host."""

    def __init__(self, enabled: bool, cuda: bool, start: int, count: int):
        self.enabled, self.cuda = enabled, cuda
        self.start, self.stop_at = start, start + count
        self.prof = None
        self.frames = 0
        self.wall_s = None

    def frame(self, i: int) -> None:
        if not self.enabled:
            return
        if i == self.start and self.prof is None:
            self._begin()
        elif i >= self.stop_at and self.prof is not None and \
                self.wall_s is None:
            self._end(i)

    def close(self, i: int) -> None:
        """End the trace at frame i if it is still on."""
        if self.prof is not None and self.wall_s is None:
            self._end(i)

    def warm(self) -> None:
        if self.enabled:
            from torch.profiler import profile
            with profile(activities=self._activities()):
                pass

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def _begin(self):
        from torch.profiler import profile
        self._sync()
        self.prof = profile(activities=self._activities())
        self.prof.start()
        self.t0 = time.perf_counter()

    def _end(self, i: int):
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.frames = i - self.start

    def summary(self) -> dict:
        """The trace's reading (empty where nothing was traced)."""
        if self.prof is None or self.wall_s is None:
            return {}
        return summarize(self.prof.events(), self.wall_s, self.frames)


def summarize(events, wall_s: float, frames: int) -> dict:
    """busy_s (union of device intervals), kernels (K1-K4 -> [calls,
    device seconds]), launch_calls, device_s_by_name (every device op's
    seconds by short name), device_ops and idle_gaps (the ten largest,
    [name, seconds]), stage_device_s and ops_linked (stage_device_s()),
    frames and window_s."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    launches = 0
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not _annotation(e):
                dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            if "Launch" in e.name:
                launches += 1
            cpu.append((tr.start, tr.end, e.name))
    by_stage, linked, n_ops = stage_device_s(events)
    out = {"frames": frames, "window_s": wall_s, "launch_calls": launches,
           "stage_device_s": by_stage, "ops_linked": [linked, n_ops],
           "device_s_by_name": {}}
    if not dev:
        return out
    dev.sort()
    busy, end, by_name = 0.0, float("-inf"), out["device_s_by_name"]
    kernels = {k: [0, 0.0] for k in KERNEL_NAMES}
    intervals = []
    for s, e, name in dev:
        if s > end:
            intervals.append([s, e])
        elif e > intervals[-1][1]:
            intervals[-1][1] = e
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        short = short_name(name)
        by_name[short] = by_name.get(short, 0.0) + (e - s) / 1e6
        base = short.rsplit("::", 1)[-1]
        for k, names in KERNEL_NAMES.items():
            if base in names:
                kernels[k][1] += (e - s) / 1e6
                if base == CALL_KERNEL[k]:
                    kernels[k][0] += 1
    out.update(busy_s=busy / 1e6,
               kernels={k: v for k, v in kernels.items() if v[0]},
               device_ops=[[n, s] for n, s in sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:TOP]],
               idle_gaps=idle_gaps(intervals, cpu))
    return out


def _annotation(e) -> bool:
    """A device-side copy of a record_function range (the benchmark's
    "depthbench.*" spans, the program's "svtt.*"): no work."""
    return getattr(e, "is_user_annotation", False) or \
        e.name.startswith(("depthbench.", "svtt."))


def stage_device_s(events) -> Tuple[Dict[str, float], int, int]:
    """Device seconds by program span: each device op (kernels and copies;
    not the device copies of record_function ranges) goes to the innermost
    "svtt.*" CPU event covering the runtime call that launched it, found by
    correlation id, on that call's thread; an op with no such call goes to
    the innermost span covering its own start.  "" holds the ops under no
    span.  -> (seconds by span, ops linked to their call, all ops)."""
    from torch.autograd import DeviceType
    spans, calls, ops = [], {}, []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.name.startswith("svtt."):
                spans.append((tr.start, tr.end, e.name, e.thread))
            elif e.name.startswith(RUNTIME):
                calls[e.id] = (tr.start, e.thread)
        elif e.device_type == DeviceType.CUDA and not _annotation(e):
            ops.append(e)
    s0 = np.asarray([x[0] for x in spans], np.float64)
    s1 = np.asarray([x[1] for x in spans], np.float64)
    th = np.asarray([x[3] for x in spans], np.int64)
    out: Dict[str, float] = {}
    linked = 0
    for e in ops:
        call = calls.get(e.id) or calls.get(
            getattr(e, "linked_correlation_id", 0))
        linked += call is not None
        at, thread = call if call is not None else (e.time_range.start, None)
        cover = (s0 <= at) & (at <= s1)
        if thread is not None:
            cover &= th == thread
        idx = np.nonzero(cover)[0]
        # the innermost: the shortest, the first of equals
        name = spans[idx[np.argmin((s1 - s0)[idx])]][2] if idx.size else ""
        out[name] = out.get(name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e6
    return out, linked, len(ops)


def idle_gaps(intervals, cpu) -> list:
    """Idle time between the device's busy intervals, summed by what the
    host was doing: the shortest CPU event (an op or one of the benchmark's
    spans) that covers the gap's middle; gaps under SHORT_GAP_S are one
    entry.  The ten largest sums, [name, seconds]."""
    if len(intervals) < 2:
        return []
    iv = np.asarray(intervals, np.float64)
    g0, g1 = iv[:-1, 1], iv[1:, 0]
    length = g1 - g0
    sums = {}
    small = length < SHORT_GAP_S * 1e6
    if small.any():
        sums["gaps under %d us" % int(SHORT_GAP_S * 1e6)] = float(
            length[small].sum()) / 1e6
    if cpu:
        cs = np.asarray([c[0] for c in cpu], np.float64)
        ce = np.asarray([c[1] for c in cpu], np.float64)
        cd = ce - cs
        names = [short_name(c[2]) for c in cpu]
    for a, b in zip(g0[~small], g1[~small]):
        mid = 0.5 * (a + b)
        name = "host: no traced event"
        if cpu:
            cover = np.nonzero((cs <= mid) & (ce >= mid))[0]
            if cover.size:
                name = "host: " + names[cover[np.argmin(cd[cover])]]
        sums[name] = sums.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(sums.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
