"""K3 wrapper: speckle removal by block-local union-find CCL (csrc/ccl.cu),
counterpart of stereovision_tpu/ops/pallas/ccl_pl.py.

On CUDA tensors remove_small_segments launches the kernel; on CPU tensors
it runs the plain version ops.postprocess.remove_small_segments.
`launches` counts launches of this wrapper's kernel sequence (local,
border, count, apply), one per call.  The size threshold is
ops.postprocess.speckle_threshold, which the plain version reads too.  The
map may carry a leading batch dimension: a batch is one launch sequence
over one label buffer, whose components never cross frames.
"""

from __future__ import annotations

import torch

from ...params import ElasParams
from .. import postprocess as plain
from . import _lib

launches = 0


def remove_small_segments(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """(..., H, W) float32 -> D with small segments and invalid pixels
    -10."""
    if D.device.type == "cpu":
        return plain.remove_small_segments(D, p)
    n = _lib.frames(D, 2)
    _lib.expect(D, "D", torch.float32, D.shape)
    H, W = D.shape[-2:]
    if n * H * W >= 2 ** 31:
        raise ValueError("%d maps of %dx%d overflow the int32 labels"
                         % (n, H, W))
    labels = torch.empty(D.shape, dtype=torch.int32, device=D.device)
    sizes = torch.empty(D.shape, dtype=torch.int32, device=D.device)
    out = torch.empty_like(D)
    err = _lib.kernels().svtt_speckle(
        _lib.ptr(D), n, H, W, float(p.speckle_sim_threshold),
        plain.speckle_threshold(p),
        _lib.ptr(labels), _lib.ptr(sizes), _lib.ptr(out), _lib.stream())
    _lib.check(err, "remove_small_segments")
    _lib.count(globals())
    return out
