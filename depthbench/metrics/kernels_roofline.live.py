"""Kernels (csrc/*.cu, K1-K4): their least time on the H100 (roofline.py,
from the reference's plane maps and grid masks) over their device time in
the traced stretch, in %."""
from depthbench import roofline

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "frame_ms"


def read(rec):
    t = rec["trace"]
    if "latencies_s" not in rec or not t.get("kernels") or "bounds" not in rec:
        return None
    return roofline.share(rec["bounds"], t["kernels"])
