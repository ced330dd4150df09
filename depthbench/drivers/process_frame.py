"""A closed loop with one caller: each pair through
StereoEngine.process_frame, the next sent when the last returns (the
path of the CLI, StereoVision.generatePointCloud and the C ABI)."""

from __future__ import annotations

import time


def warm(engine, pairs, traffic, config) -> None:
    """Every pair once: builds the kernels and fills the allocator."""
    for left, right in pairs:
        engine.process_frame(left, right, fetch=traffic["fetch"])


def window(engine, pairs, schedule, traffic, config, seconds, keep,
           tracer) -> dict:
    """Send frames until `seconds` have passed since the first was sent.
    Each frame's latency runs from its send to its return; the window from
    the first send to the last return."""
    fetch = traffic["fetch"]
    lat, pc_t = [], []
    t0 = time.perf_counter()
    t_end, last, i = t0 + seconds, t0, 0
    while i == 0 or last < t_end:
        k = schedule[i]
        left, right = pairs[k]
        tracer.frame(i)
        sent = time.perf_counter()
        out = engine.process_frame(left, right, fetch=fetch)
        last = time.perf_counter()
        lat.append(last - sent)
        pc_t.append(out["timings"]["pc_t"])
        keep(k, out)
        i += 1
    tracer.close(i)
    return {"frames": i, "attempted": i, "emitted": i, "batch": 1,
            "window_s": last - t0, "latencies_s": lat, "pc_t_s": pc_t}
