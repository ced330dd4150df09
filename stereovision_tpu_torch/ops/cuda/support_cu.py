"""K2 wrapper: the support scan (csrc/support.cu), counterpart of
stereovision_tpu/ops/pallas/support_pl.py.

On a CUDA tensor support_scan launches the kernel on the descriptor planes
themselves (launch: the kernel gathers its candidate rows); on a CPU tensor
it runs the plain version ops.support.support_scan.  `launches` counts
kernel launches.  Every function takes one frame or a batch of frames (a
leading batch dimension): a batch is one launch.

Under a mesh with more than one device (parallel/ctx.py) the scan runs in
candidate-row stripes over 'tile' and frames over 'stream'
(support_pl.py:146-190, :244): one launch per shard, each on the slab of
descriptor rows its candidate rows read (ops.support.slab_rows), a view
where the shard's device is the frame's; on CPU tensors the same split
runs the plain version per shard.
"""

from __future__ import annotations

import ctypes

import torch

from ...parallel import ctx
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


def launch(desc1: torch.Tensor, desc2: torch.Tensor, p: ElasParams,
           height: int = 0, row0: int = 0, first: int = 0,
           count: int = None) -> torch.Tensor:
    """Launch the kernel on (..., 16, H, W) uint8 descriptors; returns the
    (..., 8, Hc, W) int32 scan minima.  A stripe: the candidate rows
    [first, first + count) of a frame of `height` rows, from descriptors
    that hold its rows [row0, row0 + H) (a view of whole rows will do).
    Raises ValueError when min(disp_max, W - 5) exceeds max_span()."""
    n = _lib.frames(desc1, 3)
    shape = tuple(desc1.shape)
    fstride, plane = _lib.layout(desc1, "desc1", torch.uint8, shape, True)
    if _lib.layout(desc2, "desc2", torch.uint8, shape, True) != (fstride,
                                                                 plane):
        raise ValueError("desc1 and desc2 must have the same layout")
    if shape[-3] != 16:
        raise ValueError("descriptors must have 16 planes, got shape %s"
                         % (shape,))
    Hs, W = shape[-2:]
    H = height or Hs
    if count is None:
        count = plain.candidate_count(p, H) - first
    lo, hi = plain.slab_rows(p, H, first, count)
    if count > 0 and (lo < row0 or hi > row0 + Hs):
        raise ValueError("rows [%d, %d) do not hold the rows [%d, %d) that "
                         "candidate rows [%d, %d) read"
                         % (row0, row0 + Hs, lo, hi, first, first + count))
    span, limit = min(p.disp_max, W - 5), max_span()
    if span > limit:
        raise ValueError("support scan: min(disp_max, W - 5) = %d exceeds "
                         "the %d that one block's shared memory holds on "
                         "this device" % (span, limit))
    out = torch.empty(shape[:-3] + (8, count, W), dtype=torch.int32,
                      device=desc1.device)
    err = _lib.kernels().svtt_support_scan(
        _lib.ptr(desc1), _lib.ptr(desc2), n, fstride, plane, H, row0, first,
        count, W, p.step, max(p.disp_min, 0), p.disp_max, _lib.ptr(out),
        _lib.stream())
    _lib.check(err, "support_scan")
    _lib.count(globals())
    return out


def support_scan(desc1: torch.Tensor, desc2: torch.Tensor, p: ElasParams,
                 height: int = 0) -> torch.Tensor:
    """(..., 16, H, W) uint8 descriptors -> (..., 8, Hc, W) int32 scan
    minima; height: the frame's true rows (default H)."""
    if ctx.active():
        return scan_stripes(desc1, desc2, p, height or desc1.shape[-2])
    if desc1.device.type == "cpu":
        return plain.support_scan(desc1, desc2, p, height=height)
    return launch(desc1, desc2, p, height=height)


def scan_stripes(desc1: torch.Tensor, desc2: torch.Tensor, p: ElasParams,
                 height: int) -> torch.Tensor:
    """The scan in candidate-row stripes, one launch per shard of the
    active mesh (ctx.shard_kernel)."""
    ranges = ctx.row_ranges(plain.candidate_count(p, height))
    slabs = [plain.slab_rows(p, height, lo, hi - lo) for lo, hi in ranges]

    def one(shard, d1, d2):
        (first, end), (row0, _) = ranges[shard.tile], slabs[shard.tile]
        rows = dict(height=height, row0=row0, first=first, count=end - first)
        if d1.device.type == "cpu":
            return plain.support_scan(d1, d2, p, **rows)
        return launch(d1, d2, p, **rows)

    lead = ("stream",) * (desc1.dim() - 3)
    spec = ctx.P(*lead, None, ctx.Stripes(slabs), None)
    return ctx.shard_kernel(one, (spec, spec), ctx.P(*lead, None, "tile",
                                                     None), desc1, desc2)


def support_matches(desc1: torch.Tensor, desc2: torch.Tensor,
                    p: ElasParams, apply_filters: bool = True,
                    true_height: int = 0) -> torch.Tensor:
    """ops.support.support_matches through this wrapper's scan."""
    return plain.support_matches(desc1, desc2, p, apply_filters,
                                 scan=support_scan, true_height=true_height)
