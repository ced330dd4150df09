"""Offline processing of a recorded drive: frames through
StereoEngine.stream_batched in batches, with the mix's pipeline depth and
host-middle workers, for as long as the window lasts."""

from __future__ import annotations

import time


def _kwargs(traffic, config) -> dict:
    return dict(batch=int(traffic.get("batch") or config["stream_batch"]),
                fetch=traffic["fetch"],
                pipeline_depth=int(traffic["pipeline_depth"]),
                host_workers=traffic["host_workers"])


def warm(engine, pairs, traffic, config) -> None:
    """A few whole batches: builds the kernels, starts the threads and the
    host middle's process pool (both kept by the engine)."""
    kw = _kwargs(traffic, config)
    n = kw["batch"] * int(traffic["warmup_batches"])
    for _ in engine.stream_batched([pairs[i % len(pairs)]
                                    for i in range(n)], **kw):
        pass


def window(engine, pairs, schedule, traffic, config, seconds, keep,
           tracer) -> dict:
    """One stream_batched call over the pairs in turn.  The caller stops
    the frames' source once `seconds` have passed since the call began;
    frames emitted by then are the window's, and the frames still in the
    pipeline are drained and checked after it."""
    kw = _kwargs(traffic, config)
    state = {"stop": False, "pulled": 0}

    def source():
        while not state["stop"]:
            yield pairs[schedule[state["pulled"]]]
            state["pulled"] += 1

    t0 = time.perf_counter()
    t_end = t0 + seconds
    in_window = emitted = 0
    times = []
    for out in engine.stream_batched(source(), **kw):
        t = time.perf_counter()
        if t <= t_end:
            in_window += 1
            times.append(t - t0)
        else:
            state["stop"] = True
        keep(schedule[emitted], out)
        emitted += 1
        tracer.frame(emitted)
    tracer.close(emitted)
    return {"frames": in_window, "attempted": state["pulled"],
            "emitted": emitted, "window_s": seconds,
            "batch": kw["batch"], "host_mode": engine.host_mode,
            "emitted_at_s": times}
