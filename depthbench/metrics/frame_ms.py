"""Closed loop: the whole window over the frames completed in it (the
reference's AVG_FPS inverted), in ms."""
UNIT, SOURCE = "ms", "host_clock"


def read(rec):
    if "latencies_s" not in rec or not rec["frames"]:
        return None
    return 1e3 * rec["window_s"] / rec["frames"]
