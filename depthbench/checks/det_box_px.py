"""det_box_px: the largest |served - reference| of the detector's box
columns (centre x, y, width, height) scaled to the frame's pixels, over the
kept frames' rows, against the plain darknet reference (reference/
darknet.py, float32, TF32 off) on each pair's left frame.  Rows of another
shape, or a difference that is not finite, read inf.  The driver hands on the
rows of a pair's first two frames (drivers/stereo_vision.py)."""

from depthbench import detector

keep = detector.keep_rows


def read(kept, refs, pairs, config, device):
    return detector.worst_rows(kept, pairs, config, device, slice(0, 4),
                               pixels=True)


def control(pairs, config, device):
    """The reference with TF32 on in the program's place."""
    return detector.control_rows(pairs, config, device)
