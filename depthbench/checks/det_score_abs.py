"""det_score_abs: the largest |served - reference| of the detector's
objectness and class-score columns (4 on) over the kept frames' rows,
against the plain darknet reference (reference/darknet.py, float32, TF32
off) on each pair's left frame.  Rows of another shape, or a difference
that is not finite, read inf.  The driver hands on the rows of a pair's first
two frames (drivers/stereo_vision.py)."""

from depthbench import detector

keep = detector.keep_rows


def read(kept, refs, pairs, config, device):
    return detector.worst_rows(kept, pairs, config, device, slice(4, None),
                               pixels=False)


def control(pairs, config, device):
    """The reference with TF32 on in the program's place."""
    return detector.control_rows(pairs, config, device)
