"""Device: 1 - the union of the device's busy intervals over the traced
stretch's wall time (torch.profiler), in %."""
UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "frame_ms"


def read(rec):
    t = rec["trace"]
    if "latencies_s" not in rec or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
