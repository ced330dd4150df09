"""Kernels (csrc/*.cu, K1-K4): their least time on the H100 (roofline.py,
from the reference's plane maps and grid masks) over their device time in
the traced stretch, in %."""
from depthbench import roofline

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "stream_fps"


def read(rec):
    t = rec["trace"]
    if "host_mode" not in rec or not t.get("kernels") or "bounds" not in rec:
        return None
    return roofline.share(rec["bounds"], t["kernels"])
