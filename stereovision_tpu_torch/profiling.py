"""Stage-level profiling: the reference's Timer
(src/common_includes/elas/timer.{h,cpp}: named sections, grouped report)
plus a device trace through torch.profiler (counterpart of
stereovision_tpu/profiling.py, name for name).

A CUDA call returns before the card has run it, so `sync()` waits for the
card (torch.cuda.synchronize) before a section's clock stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

import torch


def sync(x):
    """Wait until the card has computed x (a tensor, or tuples, lists and
    dicts of them); nothing to wait for on the CPU.  Returns x."""
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
