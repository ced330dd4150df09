"""Torch ops and kernel wrappers (ops/, ops/cuda/): the runtime's launch
calls (CPU events named *Launch*) in the traced frames, a frame."""
UNIT, SOURCE = "launches/frame", "device_trace"
LAYER, MOVES = "torch ops and kernel wrappers", "frame_ms"


def read(rec):
    t = rec["trace"]
    if "latencies_s" not in rec or not t.get("frames") or \
            not t.get("launch_calls"):
        return None
    return t["launch_calls"] / t["frames"]
