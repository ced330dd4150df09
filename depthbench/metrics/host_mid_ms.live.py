"""Host middle (models/elas.py ElasEngine.host_mid, hostlib/): the
benchmark's span around the engine's host_mid, mean ms a frame."""
UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "host middle", "frame_ms"


def read(rec):
    spans = rec["spans"].get("host_mid")
    if "latencies_s" not in rec or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
