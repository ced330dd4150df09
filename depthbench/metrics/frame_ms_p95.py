"""Closed loop: the 95th percentile (linear between order statistics) of
every frame's latency in the window, from its send to its return, in ms."""
import numpy as np

UNIT, SOURCE = "ms", "host_clock"


def read(rec):
    lat = rec.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
