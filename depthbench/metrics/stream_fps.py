"""Streaming: all frames emitted in the window over the window, frames/s."""
UNIT, SOURCE = "frames/s", "host_clock"


def read(rec):
    if "host_mode" not in rec or not rec["window_s"]:
        return None
    return rec["frames"] / rec["window_s"]
