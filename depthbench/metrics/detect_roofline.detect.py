"""Detector: the forward's convolutions' least time on the H100
(roofline_darknet.py, from the configuration's cfg) over the device time a
profiled frame of the ops launched under the program's span
svtt.detect.forward (convolutions and everything else the forward runs),
in %."""
import os

from depthbench import program, roofline_darknet
from depthbench.reference.darknet import parse_cfg

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "detector", "frame_ms"


def read(rec):
    cfg = rec["config"].get("yolo_cfg")
    dev_ms = program.stage_device_ms(rec, ["svtt.detect.forward"])
    if not cfg or not dev_ms:
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    work = roofline_darknet.work(parse_cfg(os.path.join(root, cfg)))
    return 100.0 * work["bound_ms"] / dev_ms
