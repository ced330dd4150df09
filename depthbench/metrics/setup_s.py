"""From the process's start to the first timed frame: imports, frames,
the engine, the kernels' build (first run in a checkout) and the
warm-up, in s."""
UNIT, SOURCE = "s", "host_clock"


def read(rec):
    return rec["setup_s"]
