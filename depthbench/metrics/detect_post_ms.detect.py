"""Detector: the program's spans svtt.detect.fetch (the rows to the host),
svtt.detect.decode (threshold and NMS in NumPy) and svtt.track (the
Bayesian tracker), summed; mean ms a frame over the window's svtt.frame
roots."""
from depthbench import detector

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "detector", "frame_ms"


def read(rec):
    return detector.span_ms(rec, ["svtt.detect.fetch", "svtt.detect.decode",
                                  "svtt.track"])
