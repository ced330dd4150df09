"""Sparse support-point matching as a dense disparity scan (counterpart of
stereovision_tpu/ops/support.py:43-246).

Reference semantics (src/serial_includes/elas/elas.cpp:266-440): for every
point on a `step`-pixel grid, scan all disparities; the cost is the SAD of
the four 16-byte descriptors at (u±2, v±2); keep the best if it is unique
(best < thr * second best), the texture is high enough, and the backward
match at u - d agrees within lr_threshold.

support_scan is the plain PyTorch version of the CUDA kernel in
ops/cuda/support_cu.py (csrc/support.cu): for each candidate row and every
column u it returns the best and second-best (energy, d) forward and
backward.  With F(x) = SAD32(A(x), B(x - d)) over the 32 bytes of rows
v-2 and v+2, where a column outside [0, W) reads as zero bytes:

    forward   Fg(u)   = F(u-2) + F(u+2)          valid iff u >= d + 5
    backward  Fg(u+d) = F(u+d-2) + F(u+d+2)      valid iff u <= W - d - 5

with the strict-`<` two-minimum update of the JAX scan.  The zero columns
only reach positions that finalize_support masks, so the support grid is
the JAX package's bit for bit.

Every function takes one frame or a batch (a leading batch dimension on
each input) and gives each frame its single-frame result; the plain scan
loops over the frames of a batch.

Row padding and stripes (the row-sharded pipeline, parallel/shard.py):
`height` is the frame's true height, to which every row clamps, so
padding rows at the bottom of the descriptors are never read and the
support grid equals the unpadded one (support.py:43-64).  The scan may
cover the candidate rows [first, first + count) only, from a slab of the
descriptors whose row 0 is frame row row0 (slab_rows gives the rows a
stripe reads): the kernel's stripe mode, support_pl.py:146-190.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import ElasParams
from .descriptor import texture_sum
from .filters import _pad_roll

_BIG = 2 ** 30


def candidate_count(p: ElasParams, height: int) -> int:
    """Candidate rows of a frame of `height` rows."""
    return -(-height // p.step)


def slab_rows(p: ElasParams, height: int, first: int, count: int):
    """(lo, hi): the descriptor rows that the candidate rows [first,
    first + count) of a frame of `height` rows read (rows v -/+ 2,
    clipped); (lo, lo) for no rows."""
    if count <= 0:
        return (0, 0)
    lo = min(max(first * p.step - 2, 0), height - 1)
    hi = min(max((first + count - 1) * p.step + 2, 0), height - 1) + 1
    return (lo, hi)


def candidate_rows(desc: torch.Tensor, p: ElasParams, height: int = 0,
                   row0: int = 0, first: int = 0,
                   count: int = None) -> torch.Tensor:
    """(..., 16, Hs, W) -> (..., count, 32, W): rows v-2 and v+2 (clipped
    to [0, height)) of the candidate rows v = vc * step, vc in [first,
    first + count), stacked into 32 byte planes; desc holds frame rows
    [row0, row0 + Hs)."""
    lead = desc.shape[:-3]
    W = desc.shape[-1]
    H = height or desc.shape[-2]
    if count is None:
        count = candidate_count(p, H) - first
    vc = (first + np.arange(count)) * p.step
    rows = np.stack([np.clip(vc - 2, 0, H - 1), np.clip(vc + 2, 0, H - 1)])
    idx = torch.as_tensor(rows.T.reshape(-1) - row0, device=desc.device)
    return desc[..., idx, :].reshape(*lead, 16, count, 2, W) \
        .movedim(-4, -2).reshape(*lead, count, 32, W)


def support_scan(desc1: torch.Tensor, desc2: torch.Tensor, p: ElasParams,
                 height: int = 0, row0: int = 0, first: int = 0,
                 count: int = None) -> torch.Tensor:
    """Plain version of the support kernel (K2).

    desc1, desc2: (16, H, W) uint8.  Returns (8, Hc, W) int32 planes
    f1e, f1d, f2e, f2d (forward) and b1e, b1d, b2e, b2d (backward); a
    batch (B, 16, H, W) gives (B, 8, Hc, W), one frame at a time.  With
    height, row0, first and count (see candidate_rows): the scan of those
    candidate rows, (..., 8, count, W)."""
    rows = dict(height=height, row0=row0, first=first, count=count)
    if desc1.dim() == 4:
        return torch.stack([support_scan(a, b, p, **rows)
                            for a, b in zip(desc1, desc2)])
    W = desc1.shape[2]
    d_lo, d_hi = max(p.disp_min, 0), p.disp_max
    A = candidate_rows(desc1, p, **rows).to(torch.int16)
    B = candidate_rows(desc2, p, **rows).to(torch.int16)
    Hc = A.shape[0]
    dev = desc1.device
    # F is evaluated at x in [-2, W + d_hi + 2): index xi = x + 2.  A is
    # zero outside [0, W); B is indexed at x - d, zero outside [0, W).
    X = W + d_hi + 4
    A_ext = torch.nn.functional.pad(A, (2, X - W - 2))
    Bpad = torch.nn.functional.pad(B, (d_hi + 2, d_hi + 2))
    u = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    big = torch.full((Hc, W), _BIG, dtype=torch.int32, device=dev)
    neg = torch.full((Hc, W), -1, dtype=torch.int32, device=dev)
    f1e, f2e, b1e, b2e = big, big.clone(), big.clone(), big.clone()
    f1d, f2d, b1d, b2d = neg, neg.clone(), neg.clone(), neg.clone()

    def update(e1, d1, e2, d2, cost, d):
        better1 = cost < e1
        better2 = ~better1 & (cost < e2)
        e2 = torch.where(better1, e1, torch.where(better2, cost, e2))
        d2 = torch.where(better1, d1, torch.where(better2, d, d2))
        e1 = torch.where(better1, cost, e1)
        d1 = torch.where(better1, d, d1)
        return e1, d1, e2, d2

    for d in range(d_lo, d_hi + 1):
        Bd = Bpad[:, :, d_hi - d:d_hi - d + X]
        F = torch.sum(torch.abs(A_ext - Bd), dim=1, dtype=torch.int32)
        Fg = F[:, 0:W] + F[:, 4:W + 4]
        G = F[:, d:d + W] + F[:, d + 4:d + 4 + W]
        dt = torch.tensor(d, dtype=torch.int32, device=dev)
        f1e, f1d, f2e, f2d = update(f1e, f1d, f2e, f2d,
                                    torch.where(u >= d + 5, Fg, big), dt)
        b1e, b1d, b2e, b2d = update(b1e, b1d, b2e, b2d,
                                    torch.where(u <= W - d - 5, G, big), dt)
    return torch.stack([f1e, f1d, f2e, f2d, b1e, b1d, b2e, b2d])


def finalize_support(scan: torch.Tensor, desc1: torch.Tensor,
                     desc2: torch.Tensor, p: ElasParams,
                     height: int = 0) -> torch.Tensor:
    """Scan minima (..., 8, Hc, W) -> validated support grid (..., Hc, Wc)
    int16, -1 where invalid: the validity masks, uniqueness ratios and L/R
    consistency of reference elas.cpp:266-440 (counterpart of
    ops/support.py:142), at the true height `height` (default: the
    descriptors')."""
    W = desc1.shape[-1]
    H = height or desc1.shape[-2]
    dev = desc1.device
    step = p.step
    dmax = p.disp_max
    d_min = max(p.disp_min, 0)
    # every index and mask is made on the device (a CUDA graph capture
    # copies nothing from the host)
    vc = torch.arange(-(-H // step), device=dev) * step
    gcols = torch.arange(-(-W // step), device=dev) * step
    f1e, f1d, f2e, f2d = (scan[..., k, :, :][..., gcols] for k in range(4))
    b1e, b1d, b2e, b2d = (scan[..., k, :, :] for k in range(4, 8))

    tex1 = texture_sum(desc1)
    tex2 = texture_sum(desc2)
    vc_clip = torch.clamp(vc, 0, H - 1)

    u_g = gcols[None, :]
    v_g = vc[:, None]
    border_ok_g = (u_g >= 5) & (u_g <= W - 6) & (v_g >= 5) & (v_g <= H - 6)
    range_ok_left = torch.clamp(u_g - 5, max=dmax) - d_min >= 10
    tex_ok_left = tex1[..., vc_clip, :][..., gcols] >= p.support_texture

    thr = torch.full((), p.support_threshold, dtype=torch.float32,
                     device=dev)
    uniq_f = ((f1d >= 0) & (f2d >= 0)
              & (f1e.to(torch.float32) < thr * f2e.to(torch.float32)))
    d_fwd = torch.where(uniq_f & border_ok_g & range_ok_left & tex_ok_left,
                        f1d, -1)

    u_full = torch.arange(W, device=dev)[None, :]
    border_ok_b = (u_full >= 5) & (u_full <= W - 6)
    range_ok_right = torch.clamp(W - u_full - 5, max=dmax) - d_min >= 10
    tex_ok_right = tex2[..., vc_clip, :] >= p.support_texture
    v_ok = ((vc >= 5) & (vc <= H - 6))[:, None]
    uniq_b = ((b1d >= 0) & (b2d >= 0)
              & (b1e.to(torch.float32) < thr * b2e.to(torch.float32)))
    d_bwd = torch.where(uniq_b & border_ok_b & range_ok_right & v_ok
                        & tex_ok_right, b1d, -1)

    u2 = torch.clamp(gcols - d_fwd, 0, W - 1)
    d2 = torch.gather(d_bwd, -1, u2.to(torch.int64))
    ok = (d_fwd >= 0) & (d2 >= 0) & (torch.abs(d_fwd - d2) <= p.lr_threshold)
    d_can = torch.where(ok, d_fwd, -1).to(torch.int16)
    # grid row/col 0 are never candidates (reference elas.cpp:394-396)
    d_can[..., 0, :] = -1
    d_can[..., :, 0] = -1
    return d_can


def support_matches(desc1: torch.Tensor, desc2: torch.Tensor,
                    p: ElasParams, apply_filters: bool = True,
                    scan=support_scan, true_height: int = 0) -> torch.Tensor:
    """Dense support-point disparity grid (Hc, Wc) int16, -1 = invalid.

    apply_filters=True runs the snapshot (data-parallel) support filters;
    the engine passes False and applies the reference-exact sequential
    filters on the host (hostlib.raster.filter_support_sequential).
    `scan` is the scan to run: this module's plain version, or the kernel
    wrapper ops.cuda.support_cu.support_scan.  true_height: the frame's
    rows when the descriptors carry bottom padding rows (the grid is the
    unpadded one)."""
    d_can = finalize_support(scan(desc1, desc2, p, height=true_height),
                             desc1, desc2, p, height=true_height)
    if apply_filters:
        d_can = remove_inconsistent(d_can, p)
        d_can = remove_redundant(d_can, p, vertical=True)
        d_can = remove_redundant(d_can, p, vertical=False)
    return d_can


def remove_inconsistent(d_can: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Drop support points with fewer than incon_min_support neighbours
    (self included) of similar disparity in a +/-incon_window_size window
    (reference elas.cpp:152-176, snapshot semantics)."""
    w = p.incon_window_size
    d = d_can.to(torch.int32)
    supp = torch.zeros_like(d)
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            nb = _pad_roll(d, dy, dx, -1)
            supp += ((nb >= 0) & (torch.abs(d - nb) <= p.incon_threshold)
                     ).to(torch.int32)
    keep = (d < 0) | (supp >= p.incon_min_support)
    return torch.where(keep, d_can, -1).to(torch.int16)


def remove_redundant(d_can: torch.Tensor, p: ElasParams, vertical: bool,
                     redun_max_dist: int = 5,
                     redun_threshold: int = 1) -> torch.Tensor:
    """Drop support points that have a similar-disparity neighbour within
    redun_max_dist cells in BOTH directions along an axis (reference
    elas.cpp:178-233, snapshot semantics)."""
    d = d_can.to(torch.int32)
    found = []
    for sgn in (-1, 1):
        f = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        for j in range(1, redun_max_dist + 1):
            dy, dx = (sgn * j, 0) if vertical else (0, sgn * j)
            nb = _pad_roll(d, dy, dx, -1)
            f |= (nb >= 0) & (torch.abs(d - nb) <= redun_threshold)
        found.append(f)
    redundant = (d >= 0) & found[0] & found[1]
    return torch.where(redundant, -1, d_can).to(torch.int16)
