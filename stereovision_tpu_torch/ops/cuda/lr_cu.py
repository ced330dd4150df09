"""K4 wrapper: the L/R consistency check (csrc/lr.cu), counterpart of
stereovision_tpu/ops/pallas/lr_pl.py.

On CUDA tensors lr_consistency_check launches the kernel (launch); on CPU
tensors it runs the plain version ops.postprocess.lr_consistency_check.
`launches` counts kernel launches.  On the half lattice the kernel takes
the half warp (ops.postprocess.lr_warp_scale).  The maps may carry a
leading batch dimension: a batch is one launch.

Under a mesh with more than one device (parallel/ctx.py) the check runs in
row stripes over 'tile' and frames over 'stream' (lr_pl.py:122-165, :127):
one launch per shard on its rows, a view where the shard's device is the
frame's; on CPU tensors the same split runs the plain version per shard.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...parallel import ctx
from ...params import ElasParams
from .. import postprocess as plain
from . import _lib

launches = 0


@functools.lru_cache(maxsize=None)
def _max_width(device: torch.device) -> int:
    W = ctypes.c_int()
    with torch.cuda.device(device):
        _lib.check(_lib.kernels().svtt_lr_max_width(ctypes.byref(W)),
                   "lr_consistency_check")
    return W.value


def max_width(device: torch.device = None) -> int:
    """The widest row whose two maps fit one block's shared memory on
    `device` (the current CUDA device by default); asked once per
    device."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _max_width(device)


def launch(D1: torch.Tensor, D2: torch.Tensor, p: ElasParams):
    """Launch the kernel on (..., H, W) float32 D1, D2 (views of whole rows
    will do, such as a row stripe); returns the checked (D1, D2),
    contiguous.  Raises ValueError when W exceeds max_width()."""
    n = _lib.frames(D1, 2)
    # the kernel reads and writes single floats
    fstride = _lib.layout(D1, "D1", torch.float32, D1.shape)[0]
    if _lib.layout(D2, "D2", torch.float32, D1.shape)[0] != fstride:
        raise ValueError("D1 and D2 must have the same layout")
    H, W = D1.shape[-2:]
    limit = max_width(D1.device)
    if W > limit:
        raise ValueError("lr_consistency_check: rows of %d columns exceed "
                         "the %d that one block's shared memory holds on "
                         "this device" % (W, limit))
    O1 = torch.empty(D1.shape, dtype=D1.dtype, device=D1.device)
    O2 = torch.empty(D2.shape, dtype=D2.dtype, device=D2.device)
    err = _lib.kernels().svtt_lr_check(
        _lib.ptr(D1), _lib.ptr(D2), n, H, W, fstride, plain.lr_warp_scale(p),
        float(p.lr_threshold),
        _lib.ptr(O1), _lib.ptr(O2), _lib.stream())
    _lib.check(err, "lr_consistency_check")
    _lib.count(globals())
    return O1, O2


def lr_consistency_check(D1: torch.Tensor, D2: torch.Tensor, p: ElasParams):
    """(..., H, W) float32 D1, D2 -> checked (D1, D2)."""
    if ctx.active():
        return check_stripes(D1, D2, p)
    if D1.device.type == "cpu":
        return plain.lr_consistency_check(D1, D2, p)
    return launch(D1, D2, p)


def check_stripes(D1: torch.Tensor, D2: torch.Tensor, p: ElasParams):
    """The check in row stripes, one launch per shard of the active mesh
    (ctx.shard_kernel)."""
    def one(shard, a, b):
        if a.device.type == "cpu":
            return plain.lr_consistency_check(a, b, p)
        return launch(a, b, p)

    spec = ctx.P(*("stream",) * (D1.dim() - 2), "tile", None)
    return ctx.shard_kernel(one, (spec, spec), (spec, spec), D1, D2)
