"""Detector (models/yolo.py through StereoVision): the program's spans
svtt.detect, each frame's pre-processing, forward, rows' fetch and decode;
mean ms a frame over the window's svtt.frame roots."""
from depthbench import detector

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "detector", "frame_ms"


def read(rec):
    return detector.span_ms(rec, ["svtt.detect"])
