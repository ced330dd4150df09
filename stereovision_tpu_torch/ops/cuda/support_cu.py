"""K2 wrapper: the support scan (csrc/support.cu), counterpart of
stereovision_tpu/ops/pallas/support_pl.py.

On a CUDA tensor support_scan lays the candidate rows out for the kernel
(layout) and launches it (launch); on a CPU tensor it runs the plain version
ops.support.support_scan.  `launches` counts kernel launches.  Every
function takes one frame or a batch of frames (a leading batch dimension):
a batch is one launch.
"""

from __future__ import annotations

import torch

from ...params import ElasParams
from .. import support as plain
from . import _lib

launches = 0


def layout(desc: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """(..., 16, H, W) descriptors -> (..., Hc, W, 32) candidate-row
    stacks: one column's 32 bytes are two 16-byte vector loads."""
    return plain.candidate_rows(desc, p).transpose(-1, -2).contiguous()


def launch(A: torch.Tensor, B: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Launch the kernel on layout()'s tensors; returns the (..., 8, Hc, W)
    int32 scan minima."""
    n = _lib.frames(A, 3)
    lead = tuple(A.shape[:-3])
    Hc, W, _ = A.shape[-3:]
    _lib.expect(A, "A", torch.uint8, lead + (Hc, W, 32))
    _lib.expect(B, "B", torch.uint8, lead + (Hc, W, 32))
    out = torch.empty(lead + (8, Hc, W), dtype=torch.int32, device=A.device)
    err = _lib.kernels().svtt_support_scan(
        _lib.ptr(A), _lib.ptr(B), n, Hc, W, max(p.disp_min, 0), p.disp_max,
        _lib.ptr(out), _lib.stream())
    _lib.check(err, "support_scan")
    _lib.count(globals())
    return out


def support_scan(desc1: torch.Tensor, desc2: torch.Tensor,
                 p: ElasParams) -> torch.Tensor:
    """(..., 16, H, W) uint8 descriptors -> (..., 8, Hc, W) int32 scan
    minima."""
    if desc1.device.type == "cpu":
        return plain.support_scan(desc1, desc2, p)
    return launch(layout(desc1, p), layout(desc2, p), p)


def support_matches(desc1: torch.Tensor, desc2: torch.Tensor,
                    p: ElasParams, apply_filters: bool = True) -> torch.Tensor:
    """ops.support.support_matches through this wrapper's scan."""
    return plain.support_matches(desc1, desc2, p, apply_filters,
                                 scan=support_scan)
