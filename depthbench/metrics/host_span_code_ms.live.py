"""Host middle (hostlib/geometry.py): the program's spans
svtt.host_mid.span_code, the triangle-id span codes (C++), left and
right summed; mean ms a frame over the window's svtt.frame roots."""
from depthbench import program

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "host middle", "frame_ms"


def read(rec):
    if "latencies_s" not in rec:
        return None
    return program.span_ms(rec, "svtt.host_mid.span_code")
