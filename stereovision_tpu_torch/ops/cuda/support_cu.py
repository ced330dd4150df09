"""K2 wrapper: the support scan (csrc/support.cu), counterpart of
stereovision_tpu/ops/pallas/support_pl.py.

On a CUDA tensor support_scan launches the kernel on the descriptor planes
themselves (launch: the kernel gathers its candidate rows); on a CPU tensor
it runs the plain version ops.support.support_scan.  `launches` counts
kernel launches.  Every function takes one frame or a batch of frames (a
leading batch dimension): a batch is one launch.
"""

from __future__ import annotations

import ctypes

import torch

from ...params import ElasParams
from .. import support as plain
from . import _lib

launches = 0


def max_span() -> int:
    """The largest min(disp_max, W - 5) whose shared-memory window fits a
    block on the current device (2160 on an H100)."""
    d_top = ctypes.c_int()
    _lib.check(_lib.kernels().svtt_support_max_span(ctypes.byref(d_top)),
               "support_scan")
    return d_top.value


def launch(desc1: torch.Tensor, desc2: torch.Tensor,
           p: ElasParams) -> torch.Tensor:
    """Launch the kernel on (..., 16, H, W) uint8 descriptors; returns the
    (..., 8, Hc, W) int32 scan minima.  Raises ValueError when
    min(disp_max, W - 5) exceeds max_span()."""
    n = _lib.frames(desc1, 3)
    shape = tuple(desc1.shape)
    _lib.expect(desc1, "desc1", torch.uint8, shape)
    _lib.expect(desc2, "desc2", torch.uint8, shape)
    if shape[-3] != 16:
        raise ValueError("descriptors must have 16 planes, got shape %s"
                         % (shape,))
    H, W = shape[-2:]
    span, limit = min(p.disp_max, W - 5), max_span()
    if span > limit:
        raise ValueError("support scan: min(disp_max, W - 5) = %d exceeds "
                         "the %d that one block's shared memory holds on "
                         "this device" % (span, limit))
    Hc = -(-H // p.step)
    out = torch.empty(shape[:-3] + (8, Hc, W), dtype=torch.int32,
                      device=desc1.device)
    err = _lib.kernels().svtt_support_scan(
        _lib.ptr(desc1), _lib.ptr(desc2), n, H, W, p.step,
        max(p.disp_min, 0), p.disp_max, _lib.ptr(out),
        _lib.stream())
    _lib.check(err, "support_scan")
    _lib.count(globals())
    return out


def support_scan(desc1: torch.Tensor, desc2: torch.Tensor,
                 p: ElasParams) -> torch.Tensor:
    """(..., 16, H, W) uint8 descriptors -> (..., 8, Hc, W) int32 scan
    minima."""
    if desc1.device.type == "cpu":
        return plain.support_scan(desc1, desc2, p)
    return launch(desc1, desc2, p)


def support_matches(desc1: torch.Tensor, desc2: torch.Tensor,
                    p: ElasParams, apply_filters: bool = True) -> torch.Tensor:
    """ops.support.support_matches through this wrapper's scan."""
    return plain.support_matches(desc1, desc2, p, apply_filters,
                                 scan=support_scan)
