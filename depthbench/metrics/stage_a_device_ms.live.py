"""Torch ops and kernel wrappers: device ms a profiled frame of the ops
launched under the program's span svtt.stage_a (stage A: descriptors and
the support scan) and its children."""
from depthbench import program

UNIT, SOURCE = "ms", "device_trace"
LAYER, MOVES = "torch ops and kernel wrappers", "frame_ms"


def read(rec):
    if "latencies_s" not in rec:
        return None
    return program.stage_device_ms(rec, ["svtt.stage_a"])
