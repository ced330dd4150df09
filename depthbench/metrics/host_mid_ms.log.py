"""Host middle in the process pool (ElasEngine.host_mid_parallel): the
benchmark's span around it, mean ms a batch (the pool's mode is on an
earlier line of standard error)."""
UNIT, SOURCE, LAYER, MOVES = ("ms/batch", "program_span", "host middle",
                              "stream_fps")


def read(rec):
    spans = rec["spans"].get("host_mid_parallel")
    if "host_mode" not in rec or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
