#!/usr/bin/env python3
"""Run one cell as run.py does, with the program's own spans recorded
(stereovision_tpu_torch/profiling.py), and print what they read.

    python3 depthbench/program_spans.py --workload kitti_full.live \
        --seed 7 --seconds 51 --trace 1

The run is run.py's, line for line, except that the program's spans are
turned on (profiling.trace_start()) where the warm-up ends and drained when
the run ends.  One more JSON line follows run.py's result line:
{"program": ...} with the host middle's split (filters, Delaunay, raster,
span coding: ms a frame), every span's mean ms a frame, the host middle's
counts, how much of each svtt.frame its children cover and, with --trace 1,
the device seconds of each program stage in the profiled frames
(stage_device_s) and the share of the device's busy time they hold.  With
--trace 0 the program's spans are recorded but no profiler runs: its
frame_ms against run.py's is the cost of recording.

harness.py does not call trace_start() and trace.py's summarize() does not
attribute device time to spans yet; this script adds both from outside
(Tracer.warm and trace.summarize wrapped at run time).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Dict, Iterator, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the host middle's split: span name -> reading's name
HOST_PARTS = {"svtt.host_mid.filters": "host_filters_ms",
              "svtt.host_mid.delaunay": "host_delaunay_ms",
              "svtt.host_mid.raster": "host_raster_ms",
              "svtt.host_mid.span_code": "host_span_code_ms"}
# the CUDA runtime calls that launch device work (kernels, copies, sets,
# graph replays): a device op's correlation id names one of them
RUNTIME = ("cuda", "cu")


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
        elif e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("svtt.", "depthbench."))):
                ops.append(e)
    out: Dict[str, float] = {}
    linked = 0
    for e in ops:
        call = calls.get(e.id) or calls.get(
            getattr(e, "linked_correlation_id", 0))
        linked += call is not None
        at, thread = call if call is not None else (e.time_range.start, None)
        best = None
        for s0, s1, name, th in spans:
            if s0 <= at <= s1 and (thread is None or th == thread) and (
                    best is None or s1 - s0 < best[1] - best[0]):
                best = (s0, s1, name)
        name = best[2] if best else ""
        out[name] = out.get(name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e6
    return out, linked, len(ops)


def readings(spans: List, frames_profiled: int, by_stage: Dict[str, float],
             busy_s: float, links: Tuple[int, int] = (0, 0)) -> dict:
    """The program's readings from its drained spans (profiling.Span
    fields) and, where a profiler ran, the device seconds by stage (links:
    the device ops linked to their launching call, of all)."""
    from stereovision_tpu_torch.profiling import Span
    spans = [Span(*s) for s in spans]
    frames = {s.frame_id for s in spans if s.name == "svtt.frame"}
    n = max(len(frames), 1)
    ms: Dict[str, float] = {}
    for s in spans:
        ms[s.name] = ms.get(s.name, 0.0) + (s.t1_ns - s.t0_ns) / 1e6
    out = {"frames": len(frames),
           "span_ms": {k: v / n for k, v in sorted(ms.items())}}
    for name, key in HOST_PARTS.items():
        out[key] = ms.get(name, 0.0) / n
    out["host_mid_ms"] = ms.get("svtt.host_mid", 0.0) / n
    hm = [s.counts for s in spans if s.name == "svtt.host_mid"]
    out["host_mid_counts"] = {k: sorted({c[k] for c in hm})
                              for k in (hm[0] if hm else {})}
    # the share of each frame that its direct children cover
    kids: Dict[int, float] = {}
    for s in spans:
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0) + s.t1_ns - s.t0_ns
    cover = [kids.get(s.id, 0) / max(s.t1_ns - s.t0_ns, 1) for s in spans
             if s.name == "svtt.frame"]
    if cover:
        out["frame_cover"] = [min(cover), sum(cover) / len(cover)]
    if by_stage and frames_profiled:
        out["stage_device_s"] = by_stage
        out["stage_a_device_ms"] = \
            1e3 * by_stage.get("svtt.stage_a", 0.0) / frames_profiled
        out["stage_b_device_ms"] = 1e3 * (
            by_stage.get("svtt.stage_b", 0.0)
            + by_stage.get("svtt.reproject", 0.0)) / frames_profiled
        staged = sum(v for k, v in by_stage.items()
                     if k in ("svtt.stage_a", "svtt.stage_b",
                              "svtt.reproject")
                     or k.startswith("svtt.fetch_"))
        out["device_ops_s"] = sum(by_stage.values())
        out["busy_s"] = busy_s
        out["staged_share_of_ops"] = staged / max(out["device_ops_s"], 1e-12)
        out["ops_linked"] = list(links)
    return out


@contextlib.contextmanager
def recorded() -> Iterator[dict]:
    """For the runs of run_cell inside the block: the program's spans on
    from the end of the warm-up, and the profiled frames' device seconds
    by stage.  Yields a dict that gets "program" (readings()) at the
    end."""
    from depthbench import trace
    from stereovision_tpu_torch import profiling as P

    box = {}
    warm, summarize = trace.Tracer.warm, trace.summarize

    def warm_then_record(self):
        warm(self)
        P.trace_drain()
        P.trace_start()

    def summarize_by_stage(events, wall_s, frames):
        out = summarize(events, wall_s, frames)
        by_stage, linked, ops = stage_device_s(events)
        box.update(by_stage=by_stage, links=(linked, ops), frames=frames,
                   busy_s=out.get("busy_s", 0.0))
        return out

    trace.Tracer.warm = warm_then_record
    trace.summarize = summarize_by_stage
    try:
        yield box
    finally:
        trace.Tracer.warm, trace.summarize = warm, summarize
        P.trace_stop()
    box["program"] = readings(P.trace_drain()["spans"], box.get("frames", 0),
                              box.get("by_stage", {}), box.get("busy_s", 0.0),
                              box.get("links", (0, 0)))


def main(argv=None) -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from depthbench import run
    with recorded() as box:
        rc = run.main(argv)
    if rc == 0:
        print(json.dumps({"program": box["program"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
