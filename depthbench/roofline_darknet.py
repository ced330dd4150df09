"""The least time an H100 could take for a darknet detector's
convolutions, from the cfg's sections at its [net] size.

Each convolution's operations are 2 k^2 c_in c_out H' W' (H' x W' its
output) and its bytes its input, weights and output once each in float32;
the bound is the larger of all operations over 67 T float32 operations a
second (no tensor cores: TF32 is off) and all bytes over 3.35 TB/s
(roofline.py's published peaks).  YOLOv4 at 608: 128.39 G operations,
1.236 GB, 1.916 ms, set by the operations.
"""

from __future__ import annotations

from typing import Dict, List

from .reference.darknet import layer_shapes
from .roofline import HBM_BYTES_PER_S, OPS_PER_S, bound_s


def conv_work(sections) -> List[Dict[str, float]]:
    """{"layer", "ops", "bytes"} of each convolution."""
    shapes = layer_shapes(sections)
    c_in, h, w = (int(sections[0].get("channels", 3)),
                  int(sections[0]["height"]), int(sections[0]["width"]))
    out = []
    for i, l in enumerate(sections[1:]):
        c, ho, wo = shapes[i]
        if l["type"] == "convolutional":
            k = int(l["size"])
            weights = k * k * c_in * c
            out.append({"layer": i, "ops": 2.0 * weights * ho * wo,
                        "bytes": 4.0 * (c_in * h * w + weights + c * ho * wo)})
        c_in, h, w = c, ho, wo
    return out


def work(sections) -> Dict[str, float]:
    """The convolutions' operations and bytes summed, and their bound in
    ms."""
    convs = conv_work(sections)
    ops = sum(x["ops"] for x in convs)
    nbytes = sum(x["bytes"] for x in convs)
    return {"ops": ops, "bytes": nbytes,
            "bound_ms": 1e3 * bound_s(nbytes, ops),
            "by": "operations" if ops / OPS_PER_S >= nbytes / HBM_BYTES_PER_S
            else "bytes"}
