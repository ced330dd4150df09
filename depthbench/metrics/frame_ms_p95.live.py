"""Closed loop, traced runs: the 95th percentile (linear between order
statistics) of the window's frame latencies, each from its send to its
return, in ms, leaving out the frames that torch.profiler traced (from the
mix's trace_start, as many as the trace holds), which its recording slows.
A per-layer reading and not an end-to-end one: on the host's clock its
runs spread wider than the largest bound allows (PERF.md, section 2)."""
import numpy as np

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "entry points", "frame_ms"


def read(rec):
    lat = list(rec.get("latencies_s") or ())
    traced = (rec.get("trace") or {}).get("frames", 0)
    if traced:
        start = int(rec["traffic"]["trace_start"])
        del lat[start:start + traced]
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
