"""Readings of the program's own spans (stereovision_tpu_torch/profiling.py,
"svtt.*") as a run records them: rec["program"] (the window's spans, in a
traced run) and, from the profiler, rec["trace"]["stage_device_s"] (device
seconds by the innermost span).  Metric files and program_spans.py read
them through these functions."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set


def frames(program: dict) -> Set[int]:
    """The ids of the window's frames: those with a root "svtt.frame".
    Where the program's ring filled, its oldest frame may have lost spans
    and is left out."""
    ids = {s.frame_id for s in program["spans"] if s.name == "svtt.frame"}
    if program.get("full") and ids:
        ids.discard(min(ids))
    return ids


def ms_by_name(program: dict) -> Dict[str, float]:
    """Each span name's ms a frame over frames(): the sum of its spans'
    durations in those frames over their number."""
    ids = frames(program)
    ms: Dict[str, float] = {}
    for s in program["spans"]:
        if s.frame_id in ids:
            ms[s.name] = ms.get(s.name, 0.0) + (s.t1_ns - s.t0_ns) / 1e6
    return {k: v / max(len(ids), 1) for k, v in ms.items()}


def span_ms(rec: dict, name: str) -> Optional[float]:
    """ms a frame of the spans `name` (0 where a frame has none), or None
    where the run recorded no program spans or no frame."""
    program = rec.get("program")
    if not program or not frames(program):
        return None
    return ms_by_name(program).get(name, 0.0)


def stage_device_ms(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Device ms a profiled frame under the spans `names` and their
    children ("<name>.*"), or None where no device op fell under them."""
    t = rec.get("trace") or {}
    by_stage, n = t.get("stage_device_s") or {}, t.get("frames")
    names = tuple(names)
    hit = [v for k, v in by_stage.items()
           if k in names or k.startswith(tuple(x + "." for x in names))]
    if not hit or not n:
        return None
    return 1e3 * sum(hit) / n
