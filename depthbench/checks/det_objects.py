"""det_objects: the most objects of one served frame (StereoVision's
last["objects"]: the detections, then the tracker's predicted boxes) that
differ from the plain reference's, over the window's frames in the order
served.  Where the driver handed on the frame's rows (a pair's first two
frames, drivers/stereo_vision.py), the detections against the threshold
and suppression of reference/darknet.py on those rows, equal scores in
either order; on every frame, the predicted boxes against
reference/tracker.py's, which starts from the served tracker's state
before the window and is given the served detections frame by frame.  An
object differs where its name, box or conf does; a frame counts the
positions that differ and the difference in length.  Decisions are exact:
the limit is 0."""

from depthbench import detector


def keep(out, cloud):
    return {n: out.get(n) for n in ("frame", "objects", "rows", "tracker")}


def read(kept, refs, pairs, config, device):
    return detector.worst_objects(kept, pairs, config)


def control(pairs, config, device):
    """The reference's objects with the detections' boxes rounded in place
    of cut (detector.control_objects)."""
    return detector.control_objects(pairs, config, device)
