"""K1 wrapper: dense matching keys (csrc/matching.cu), counterpart of
stereovision_tpu/ops/pallas/matching_pl.py.

On CUDA tensors match_keys launches the kernel (launch) on the inputs the
engine already holds: the (..., 16, H, W) descriptor planes of both images,
the four plane maps of ops.matching.plane_maps, the (..., D, gh, gw) bool
grid mask of ops.grid.build_grid_mask, and the resident prior table
(prior_table).  The kernel finds each output row's matching row and the
lattice's columns itself and packs the mask's candidate words in shared
memory, so no torch op runs between plane_maps and the launch but the
output's allocation.  On CPU tensors match_keys runs the plain version
ops.matching.match_keys.  `launches` counts kernel launches.  Every
function takes one frame or a batch of frames (a leading batch dimension
on every input): a batch is one launch.

Under a mesh with more than one device (parallel/ctx.py) the key scan
runs in output-row stripes over 'tile' and frames over 'stream'
(matching_pl.py:242-293, :385): one launch per shard, each on the slabs of
descriptor rows and cell rows its output rows read
(ops.matching.stripe_rows) and its rows of the maps, views where the
shard's device is the frame's; on CPU tensors the same split runs the
plain version per shard.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ...parallel import ctx
from ...params import ElasParams
from .. import matching as plain
from . import _lib

launches = 0
_priors = {}
_priors_lock = threading.Lock()


def prior_table(p: ElasParams, device: torch.device) -> torch.Tensor:
    """The (D,) int32 prior table, resident on `device`: made once per
    device and parameter set, shared by every launch (single-frame and
    batched) from any thread."""
    key = (p, device)
    with _priors_lock:
        t = _priors.get(key)
        if t is None:
            t = torch.as_tensor(p.prior_table(), device=device)
            if t.device.type == "cuda":
                # a pageable copy may still be in flight when it returns;
                # other threads' streams read the table without waiting
                torch.cuda.current_stream(t.device).synchronize()
            _priors[key] = t
    return t


@functools.lru_cache(maxsize=None)
def _max_span(device: torch.device, step: int, gs: int, nwords: int) -> int:
    d_top = ctypes.c_int()
    with torch.cuda.device(device):
        _lib.check(_lib.kernels().svtt_match_max_span(
            step, gs, nwords, ctypes.byref(d_top)), "match_keys")
    return d_top.value


def max_span(p: ElasParams, device: torch.device = None) -> int:
    """The largest min(disp_max, W - 3) whose shared-memory window fits a
    block on `device` (the current CUDA device by default) at p's lattice
    step, cell size and disparity count; asked once per device and
    shape."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _max_span(device, plain.lattice_step(p), p.grid_size,
                     -(-p.disp_num // 32))


def launch(desc_self: torch.Tensor, desc_other: torch.Tensor,
           d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
           pvalid: torch.Tensor, grid_mask: torch.Tensor,
           prior: torch.Tensor, p: ElasParams, right_image: bool,
           height: int = 0, row0: int = 0, y0: int = 0,
           g0: int = 0) -> torch.Tensor:
    """Launch the kernel on the (..., 16, H, W) uint8 descriptor planes,
    the (..., Ho, Wo) int32 plane maps, the (..., D, gh, gw) bool grid mask
    and the (D,) int32 prior table; returns the (..., Ho, Wo) int32 keys.
    A stripe: the maps' rows are output rows [y0, y0 + Ho) of a frame of
    `height` rows, the planes hold its rows from row0 and the mask its cell
    rows from g0 (views of whole rows will do).  Raises ValueError when
    min(disp_max, W - 3) exceeds max_span(p)."""
    n = _lib.frames(desc_self, 3)
    lead = tuple(desc_self.shape[:-3])
    Hs, W = desc_self.shape[-2:]
    H = height or Hs
    Ho, Wo = d_lo.shape[-2:]
    s = plain.lattice_step(p)
    D = p.disp_num
    ghs, gw = grid_mask.shape[-2:]
    # the kernel reads the planes and the mask by bytes, the rest by words
    dfs, dps = _lib.layout(desc_self, "desc_self", torch.uint8,
                           lead + (16, Hs, W), True)
    if _lib.layout(desc_other, "desc_other", torch.uint8, lead + (16, Hs, W),
                   True) != (dfs, dps):
        raise ValueError("desc_self and desc_other must have the same layout")
    mfs, mps = _lib.layout(grid_mask, "grid_mask", torch.bool,
                           lead + (D, ghs, gw), True)
    pfs = None
    for name, t in (("d_lo", d_lo), ("d_hi", d_hi), ("d_plane", d_plane),
                    ("pvalid", pvalid)):
        f = _lib.layout(t, name, torch.int32, lead + (Ho, Wo))[0]
        if pfs not in (None, f):
            raise ValueError("the maps must have the same layout")
        pfs = f
    _lib.layout(prior, "prior", torch.int32, (D,))
    if H < 3:
        raise ValueError("descriptor planes of %d rows: the matching row "
                         "clip(v, 2, H - 3) needs 3" % H)
    if Wo != p.out_shape(W, H)[1]:
        raise ValueError("maps of %d columns for a %d-wide frame" % (Wo, W))
    (lo, hi), (glo, ghi) = plain.stripe_rows(p, H, y0, y0 + Ho)
    if Ho and (lo < row0 or hi > row0 + Hs):
        raise ValueError("planes of rows [%d, %d) do not hold the rows [%d, "
                         "%d) that output rows [%d, %d) read"
                         % (row0, row0 + Hs, lo, hi, y0, y0 + Ho))
    if Ho and (glo < g0 or ghi > g0 + ghs
               or gw * p.grid_size <= s * (Wo - 1)):
        raise ValueError("a %s grid mask from cell row %d does not cover "
                         "output rows [%d, %d) of a lattice %d wide, step %d"
                         % (tuple(grid_mask.shape), g0, y0, y0 + Ho, Wo, s))
    span, limit = min(p.disp_max, W - 3), max_span(p, desc_self.device)
    if span > limit:
        raise ValueError("match_keys: min(disp_max, W - 3) = %d exceeds the "
                         "%d that one block's shared memory holds on this "
                         "device" % (span, limit))
    key = torch.empty(lead + (Ho, Wo), dtype=torch.int32,
                      device=desc_self.device)
    err = _lib.kernels().svtt_match_keys(
        _lib.ptr(desc_self), _lib.ptr(desc_other), _lib.ptr(grid_mask),
        _lib.ptr(d_lo), _lib.ptr(d_hi), _lib.ptr(d_plane), _lib.ptr(pvalid),
        _lib.ptr(prior), n, dfs, dps, row0, mfs, mps, g0, pfs, H, W, y0, Ho,
        Wo, s, D, p.grid_size, gw, plain.prior_offset(p), int(right_image),
        _lib.ptr(key), _lib.stream())
    _lib.check(err, "match_keys")
    _lib.count(globals())
    return key


def match_keys(desc_self: torch.Tensor, desc_other: torch.Tensor,
               d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
               pvalid: torch.Tensor, grid_mask: torch.Tensor, p: ElasParams,
               right_image: bool, height: int = 0) -> torch.Tensor:
    """Minimum matching key per output pixel, (..., Ho, Wo) int32 (see
    ops.matching); height: the frame's true rows (default the planes')."""
    args = (desc_self, desc_other, d_lo, d_hi, d_plane, pvalid, grid_mask)
    if ctx.active():
        return keys_stripes(*args, p, right_image,
                            height or desc_self.shape[-2])
    if desc_self.device.type == "cpu":
        return plain.match_keys(*args, p, right_image, height=height)
    return launch(*args, prior_table(p, desc_self.device), p, right_image,
                  height=height)


def keys_stripes(desc_self, desc_other, d_lo, d_hi, d_plane, pvalid,
                 grid_mask, p: ElasParams, right_image: bool,
                 height: int) -> torch.Tensor:
    """The key scan in output-row stripes, one launch per shard of the
    active mesh (ctx.shard_kernel)."""
    ranges = ctx.row_ranges(d_lo.shape[-2])
    slabs = [plain.stripe_rows(p, height, lo, hi) for lo, hi in ranges]

    def one(shard, ds, do, lo, hi, dp, pv, gm):
        (y0, _), ((row0, _), (g0, _)) = ranges[shard.tile], slabs[shard.tile]
        rows = dict(height=height, row0=row0, y0=y0, g0=g0)
        if ds.device.type == "cpu":
            return plain.match_keys(ds, do, lo, hi, dp, pv, gm, p,
                                    right_image, **rows)
        return launch(ds, do, lo, hi, dp, pv, gm,
                      prior_table(p, ds.device), p, right_image, **rows)

    lead = ("stream",) * (desc_self.dim() - 3)
    desc = ctx.P(*lead, None, ctx.Stripes([r for r, _ in slabs]), None)
    maps = ctx.P(*lead, ctx.Stripes(ranges), None)
    mask = ctx.P(*lead, None, ctx.Stripes([g for _, g in slabs]), None)
    return ctx.shard_kernel(
        one, (desc, desc) + (maps,) * 4 + (mask,), ctx.P(*lead, "tile", None),
        desc_self, desc_other, d_lo, d_hi, d_plane, pvalid, grid_mask)


def compute_disparity(desc_self: torch.Tensor, desc_other: torch.Tensor,
                      tri_id: torch.Tensor, planes: torch.Tensor,
                      grid_mask: torch.Tensor, p: ElasParams,
                      right_image: bool, true_height: int = 0,
                      pad_out_rows: int = 0) -> torch.Tensor:
    """ops.matching.compute_disparity through this wrapper's key scan."""
    return plain.compute_disparity(desc_self, desc_other, tri_id, planes,
                                   grid_mask, p, right_image, keys=match_keys,
                                   true_height=true_height,
                                   pad_out_rows=pad_out_rows)
