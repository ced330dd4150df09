"""K3 wrapper: speckle removal by block-local union-find CCL (csrc/ccl.cu),
counterpart of stereovision_tpu/ops/pallas/ccl_pl.py.

On CUDA tensors remove_small_segments launches the kernel; on CPU tensors
it runs the plain version ops.postprocess.remove_small_segments.
`launches` counts launches of this wrapper's kernel sequence (local,
border, count, apply), one per call.  The size threshold is
ops.postprocess.speckle_threshold, which the plain version reads too.  The
map may carry a leading batch dimension: a batch is one launch sequence
over one label buffer, whose components never cross frames.

Under a mesh with more than one 'tile' shard (parallel/ctx.py) the filter
always runs banded, one band per shard (ccl_pl.py:260-381, :423-475):
each shard labels its own row stripe (launch_stripe: local and border on
the stripe, labels in the frame's global indices; one count in
`launches` a shard), then on the device of the map one merge unites the
components across stripe edges and counts and applies over the whole
frame (launch_merge; one count in `merges`).  On CPU tensors the same
split runs the plain version (ops.postprocess.stripe_labels per shard,
merge_stripes).  Under a mesh of one 'tile' shard and several 'stream'
shards, each stream shard filters its frames whole.
"""

from __future__ import annotations

import torch

from ...parallel import ctx
from ...params import ElasParams
from .. import postprocess as plain
from . import _lib

launches = 0
merges = 0


def _check_labels(n: int, H: int, W: int) -> None:
    if n * H * W >= 2 ** 31:
        raise ValueError("%d maps of %dx%d overflow the int32 labels"
                         % (n, H, W))


def remove_small_segments(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """(..., H, W) float32 -> D with small segments and invalid pixels
    -10."""
    if ctx.active():
        if ctx.row_multiple() > 1:
            return banded(D, p)
        spec = ctx.P(*("stream",) * (D.dim() - 2), None, None)
        return ctx.shard_kernel(lambda shard, d: whole_frame(d, p), (spec,),
                                spec, D)
    return whole_frame(D, p)


def whole_frame(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """The filter on whole frames: one launch sequence (the plain version
    on the CPU)."""
    if D.device.type == "cpu":
        return plain.remove_small_segments(D, p)
    n = _lib.frames(D, 2)
    _dense(D, "D", torch.float32)
    H, W = D.shape[-2:]
    _check_labels(n, H, W)
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


def _dense(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape
    (the whole-frame passes take no strides)."""
    _lib.layout(t, name, dtype, t.shape if shape is None else shape)
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def launch_stripe(D: torch.Tensor, p: ElasParams, height: int, row0: int,
                  frame0: int = 0, frames: int = 0) -> torch.Tensor:
    """Label a row stripe (..., Hs, W) float32 (a view of whole rows will
    do): rows [row0, row0 + Hs) of frames of `height` rows, which are
    frames from frame0 of a batch of `frames` (default: D's).  Returns its
    forest, (..., Hs, W) int32 parents in the batch's global linear
    indices (see csrc/ccl.cu)."""
    n = _lib.frames(D, 2)
    fstride = _lib.layout(D, "D", torch.float32, D.shape)[0]
    Hs, W = D.shape[-2:]
    if row0 < 0 or row0 + Hs > height:
        raise ValueError("rows [%d, %d) of a frame of %d"
                         % (row0, row0 + Hs, height))
    _check_labels(max(frames, frame0 + n), height, W)
    labels = torch.empty(D.shape, dtype=torch.int32, device=D.device)
    err = _lib.kernels().svtt_speckle_stripe(
        _lib.ptr(D), n, Hs, W, fstride, float(p.speckle_sim_threshold),
        height, row0, frame0, _lib.ptr(labels), _lib.stream())
    _lib.check(err, "remove_small_segments (stripe)")
    _lib.count(globals())
    return labels


def launch_merge(D: torch.Tensor, labels: torch.Tensor, p: ElasParams,
                 rows: int) -> torch.Tensor:
    """Unite the stripes' forests `labels` ((..., H, W) int32, side by
    side, stripes of `rows` rows) across the stripe edges of D (..., H, W)
    float32, then count and apply: the filtered map."""
    n = _lib.frames(D, 2)
    _dense(D, "D", torch.float32)
    _dense(labels, "labels", torch.int32, D.shape)
    H, W = D.shape[-2:]
    _check_labels(n, H, W)
    sizes = torch.empty(D.shape, dtype=torch.int32, device=D.device)
    out = torch.empty_like(D)
    err = _lib.kernels().svtt_speckle_merge(
        _lib.ptr(D), n, H, W, rows, float(p.speckle_sim_threshold),
        plain.speckle_threshold(p), _lib.ptr(labels), _lib.ptr(sizes),
        _lib.ptr(out), _lib.stream())
    _lib.check(err, "remove_small_segments (merge)")
    _lib.count(globals(), "merges")
    return out


def banded(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """The filter banded over the active mesh's 'tile' shards: one stripe
    labelling a shard (ctx.shard_kernel), one merge on D's device."""
    H = D.shape[-2]
    ranges = ctx.row_ranges(H)
    rows = ranges[0][1] - ranges[0][0]
    n = _lib.frames(D, 2)
    per = ctx.batch_split(n) if D.dim() == 3 else 1

    def one(shard, d):
        row0 = ranges[shard.tile][0]
        if d.device.type == "cpu":
            return plain.stripe_labels(d, p, H, row0)
        return launch_stripe(d, p, H, row0, shard.stream * per, n)

    spec = ctx.P(*("stream",) * (D.dim() - 2), "tile", None)
    labels = ctx.shard_kernel(one, (spec,), spec, D)
    if D.device.type == "cpu":
        return plain.drop_merged(D, labels, p, rows)
    return launch_merge(D, labels, p, rows)
