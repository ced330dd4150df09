"""Torch ops and kernel wrappers: device ms a profiled frame of the ops
launched under the program's spans svtt.stage_b (stage B: dense matching,
the L/R check and post-processing) and svtt.reproject (the frame tail:
display disparity and cloud), and their children."""
from depthbench import program

UNIT, SOURCE = "ms", "device_trace"
LAYER, MOVES = "torch ops and kernel wrappers", "frame_ms"


def read(rec):
    if "latencies_s" not in rec:
        return None
    return program.stage_device_ms(rec, ["svtt.stage_b", "svtt.reproject"])
