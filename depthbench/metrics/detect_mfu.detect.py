"""Device: the detector's convolution operations a frame
(roofline_darknet.py) over what the H100 could do in the window's mean
frame time at 67 T float32 operations a second, in %: the model's share of
the whole step's peak."""
import os

from depthbench import roofline, roofline_darknet
from depthbench.reference.darknet import parse_cfg

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "device", "frame_ms"


def read(rec):
    cfg = rec["config"].get("yolo_cfg")
    if not cfg or "latencies_s" not in rec or not rec["frames"]:
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ops = roofline_darknet.work(parse_cfg(os.path.join(root, cfg)))["ops"]
    frame_s = rec["window_s"] / rec["frames"]
    return 100.0 * ops / (frame_s * roofline.OPS_PER_S)
