#!/usr/bin/env python3
"""Run one cell as run.py does, with the program's own spans recorded
(stereovision_tpu_torch/profiling.py) also with --trace 0, and print what
they read.

    python3 depthbench/program_spans.py --workload kitti_full.live \
        --seed 7 --seconds 51 --trace 1

The run is run.py's, line for line: the harness turns the program's spans
on where the warm-up ends and drains them after the window (with --trace 1
it does so in every run; this script asks for it with --trace 0 too).  One
more JSON line follows run.py's result line: {"program": ...} with the
host middle's split (filters, Delaunay, raster, span coding: ms a frame),
every span's mean ms a frame, the host middle's counts, how much of each
svtt.frame its children cover and, with --trace 1, the device seconds of
each program stage in the profiled frames (stage_device_s) and the share
of the device's busy time they hold.  With --trace 0 no profiler runs: its
frame_ms against run.py's is the cost of recording.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the metric files printed, each under its name less ".live": the host
# middle's split, then device time by stage (with --trace 1)
READERS = ("host_filters_ms.live", "host_delaunay_ms.live",
           "host_raster_ms.live", "host_span_code_ms.live",
           "stage_a_device_ms.live", "stage_b_device_ms.live")


def readings(rec: dict) -> dict:
    """The program's readings from a run's record: the metric files of
    READERS, and from its drained spans (rec["program"]) and, where a
    profiler ran, the device seconds by stage (rec["trace"]) what only
    this script prints."""
    from depthbench import lookup, program
    prog = rec["program"]
    spans = prog["spans"]
    ms = program.ms_by_name(prog)
    out = {"frames": len(program.frames(prog)),
           "span_ms": dict(sorted(ms.items()))}
    for name in READERS:
        v = lookup.load_module("metrics", name).read(rec)
        if v is not None:
            out[name[:-len(".live")]] = v
    out["host_mid_ms"] = ms.get("svtt.host_mid", 0.0)
    hm = [s.counts for s in spans if s.name == "svtt.host_mid"]
    out["host_mid_counts"] = {k: sorted({c[k] for c in hm})
                              for k in (hm[0] if hm else {})}
    # the share of each frame that its direct children cover
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0) + s.t1_ns - s.t0_ns
    cover = [kids.get(s.id, 0) / max(s.t1_ns - s.t0_ns, 1) for s in spans
             if s.name == "svtt.frame"]
    if cover:
        out["frame_cover"] = [min(cover), sum(cover) / len(cover)]
    t = rec.get("trace") or {}
    by_stage = t.get("stage_device_s")
    if by_stage and t.get("frames"):
        out["stage_device_s"] = by_stage
        staged = sum(v for k, v in by_stage.items()
                     if k in ("svtt.stage_a", "svtt.stage_b",
                              "svtt.reproject")
                     or k.startswith("svtt.fetch_"))
        out["device_ops_s"] = sum(by_stage.values())
        out["busy_s"] = t.get("busy_s", 0.0)
        out["staged_share_of_ops"] = staged / max(out["device_ops_s"], 1e-12)
        out["ops_linked"] = t.get("ops_linked", [0, 0])
    return out


def main(argv=None) -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from depthbench import run
    box = {}
    rc = run.main(argv, program=True, on_record=lambda rec: box.update(
        program=readings(rec)))
    if rc == 0:
        print(json.dumps({"program": box["program"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
