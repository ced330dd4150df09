"""Detector: device ms a profiled frame of the ops launched under the
program's span svtt.detect and its children (the resize's upload and /255,
the forward, the rows' fetch)."""
from depthbench import program

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "detector", "frame_ms"


def read(rec):
    return program.stage_device_ms(rec, ["svtt.detect"])
