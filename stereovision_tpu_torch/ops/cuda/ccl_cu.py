"""K3 wrapper: speckle removal by union-find CCL (csrc/ccl.cu), counterpart
of stereovision_tpu/ops/pallas/ccl_pl.py.

On CUDA tensors remove_small_segments launches the kernel; on CPU tensors
it runs the plain version ops.postprocess.remove_small_segments.
`launches` counts launches of this wrapper's kernel sequence (init, merge,
resolve, apply), one per call.  The size threshold is
ops.postprocess.speckle_threshold, which the plain version reads too.
"""

from __future__ import annotations

import torch

from ...params import ElasParams
from .. import postprocess as plain
from . import _lib

launches = 0


def remove_small_segments(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """(H, W) float32 -> D with small segments and invalid pixels -10."""
    global launches
    if D.device.type == "cpu":
        return plain.remove_small_segments(D, p)
    H, W = D.shape
    _lib.expect(D, "D", torch.float32, (H, W))
    labels = torch.empty((H, W), dtype=torch.int32, device=D.device)
    sizes = torch.zeros((H, W), dtype=torch.int32, device=D.device)
    out = torch.empty_like(D)
    err = _lib.kernels().svtt_speckle(
        _lib.ptr(D), H, W, float(p.speckle_sim_threshold),
        plain.speckle_threshold(p),
        _lib.ptr(labels), _lib.ptr(sizes), _lib.ptr(out), _lib.stream())
    _lib.check(err, "remove_small_segments")
    launches += 1
    return out
