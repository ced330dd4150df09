"""Disparity post-processing (counterpart of
stereovision_tpu/ops/postprocess.py:32-381): L/R consistency, speckle
removal, gap interpolation, adaptive mean, separable median.

  leftRightConsistencyCheck  src/serial_includes/elas/elas.cpp:946-1011
  removeSmallSegments        elas.cpp:1013-1124
  gapInterpolation           elas.cpp:1126-1294
  adaptiveMean               elas.cpp:1297-1494
  median                     elas.cpp:1496-1559

lr_consistency_check and remove_small_segments are the plain PyTorch
versions of the CUDA kernels in ops/cuda/lr_cu.py and ops/cuda/ccl_cu.py.
Under subsampling every stage runs on the (H//2, W//2) output lattice with
the reference's half-lattice rules: the L/R warp u -/+ d/2, the speckle
threshold int(2 sqrt(speckle_size)), the gap ipol_gap_width // 2 + 1 and
the 4-tap adaptive mean.  Every stage takes one map or a batch (B, H, W)
and gives each frame its single-frame result; the plain speckle filter
loops over the frames of a batch.

The row-sharded pipeline (parallel/shard.py) runs the speckle filter
banded: remove_small_segments_banded labels each row stripe on its own
and unites the components across stripe edges (ccl_pl.py:260-381), the
plain version of K3's banded mode; adaptive_mean and median_filter take
the true shape of a map that carries -10 padding rows (postprocess.py:311,
:365).
"""

from __future__ import annotations

import math

import torch

from ..params import ElasParams
from .filters import _pad_roll
from .fma import fma32

_INVALID = -10.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """x as a float32 scalar tensor on like's device, made there (a CUDA
    graph capture copies nothing from the host)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_warp_scale(p: ElasParams) -> float:
    """Column warp per unit of disparity in the L/R check: the half-lattice
    map holds full-resolution disparities (elas.cpp:957-966)."""
    return 0.5 if p.subsampling else 1.0


def speckle_threshold(p: ElasParams) -> int:
    """Smallest segment the speckle filter keeps: speckle_size, or
    int(sqrt(speckle_size) * 2) on the half lattice (removeSmallSegments,
    elas.cpp:1013-1124)."""
    if p.subsampling:
        return int(math.sqrt(float(p.speckle_size)) * 2)
    return p.speckle_size


# ---------------------------------------------------------------------------
# L/R consistency check


def lr_consistency_check(D1: torch.Tensor, D2: torch.Tensor, p: ElasParams):
    """Plain version of the L/R kernel (K4): a D1 pixel stays iff
    |D2[trunc(u - s d)] - d| <= lr_threshold, a D2 pixel iff
    |D1[trunc(u + s d)] - d| <= lr_threshold, with s = lr_warp_scale(p);
    otherwise (or when the warp leaves the row) -10."""
    W = D1.shape[-1]
    u = torch.arange(W, dtype=torch.float32, device=D1.device)
    scale = lr_warp_scale(p)

    def check(Da, Db, sign):
        uw = u + sign * Da * scale
        in_img = (Da >= 0) & (uw >= 0) & (uw < W)
        idx = torch.clamp(uw.to(torch.int64), 0, W - 1)
        db = torch.gather(Db, -1, idx)
        bad = torch.abs(db - Da) > p.lr_threshold
        return torch.where(in_img & ~bad, Da, _INVALID)

    return check(D1, D2, -1.0), check(D2, D1, 1.0)


# ---------------------------------------------------------------------------
# Speckle removal


def connectivity(D: torch.Tensor, p: ElasParams, dy: int, dx: int):
    """(H, W) bool: pixel connected to its (dy, dx) neighbour — both valid
    and |ΔD| <= speckle_sim_threshold in float32."""
    valid = D >= 0
    nb = _pad_roll(D, dy, dx, -1e9)
    nb_valid = _pad_roll(valid, dy, dx, False)
    return valid & nb_valid & (torch.abs(D - nb)
                               <= _f32(p.speckle_sim_threshold, D))


def remove_small_segments(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Plain version of the speckle kernel (K3): 4-connected components of
    valid pixels with |ΔD| <= speckle_sim_threshold; components under
    speckle_threshold(p) pixels, and every invalid pixel, become -10.
    A batch is filtered one frame at a time."""
    if D.dim() == 3:
        return torch.stack([remove_small_segments(x, p) for x in D])
    return _drop_small(D, component_labels(D, p), p)


def _drop_small(D: torch.Tensor, lab: torch.Tensor, p: ElasParams):
    """-10 where the component of a pixel (its label in lab, a linear index
    of the frame) has fewer than speckle_threshold(p) pixels."""
    sizes = torch.bincount(lab.reshape(-1), minlength=D.numel())
    seg_size = sizes[lab.to(torch.int64)]
    return torch.where(seg_size < speckle_threshold(p), _INVALID, D)


def component_labels(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """(H, W) -> (H, W) int32: each pixel's component label, the minimum
    linear index of its component (connectivity), from segmented min-scans
    (torch.cummin over re-keyed values, the JAX XLA formulation) iterated
    to the fixpoint."""
    H, W = D.shape
    n = H * W
    # the re-keyed labels (label - (n + 1) * segment) fit int32 up to
    # n * (max(H, W) + 1) < 2**31 (2070x625 exceeds it); past it they are
    # int64, where the JAX XLA path scans without re-keying
    # (stereovision_tpu/ops/postprocess.py:78-96, :138): the same fixpoint
    # either way
    key = torch.int32 if n * (max(H, W) + 1) < 2 ** 31 else torch.int64
    stride = n + 1

    def seg_offset(connp, dim, reverse):
        c = torch.flip(connp, (dim,)) if reverse else connp
        return torch.cumsum((~c).to(key), dim=dim, dtype=key) * stride

    scans = [(seg_offset(connectivity(D, p, dy, dx), dim, rev), dim, rev)
             for dy, dx, dim, rev in ((0, -1, 1, False), (0, 1, 1, True),
                                      (-1, 0, 0, False), (1, 0, 0, True))]

    def scan_dir(lab, off, dim, reverse):
        x = torch.flip(lab, (dim,)) if reverse else lab
        out = torch.cummin(x - off, dim=dim).values + off
        return torch.flip(out, (dim,)) if reverse else out

    lab = torch.arange(n, dtype=key, device=D.device).reshape(H, W)
    while True:
        m = lab
        for off, dim, rev in scans:
            m = scan_dir(m, off, dim, rev)
        if torch.equal(m, lab):
            return lab.to(torch.int32)
        lab = m


def stripe_labels(D: torch.Tensor, p: ElasParams, height: int,
                  row0: int) -> torch.Tensor:
    """(..., Hs, W) rows [row0, row0 + Hs) of frames of `height` rows ->
    (..., Hs, W) int64: each pixel's component within the stripe, labelled
    by the frame's linear index of the component's first pixel (as
    _banded_labels adds band * Hb * Wp)."""
    if D.dim() == 3:
        return torch.stack([stripe_labels(x, p, height, row0) for x in D])
    W = D.shape[-1]
    lab = component_labels(D, p).to(torch.int64)
    return (lab // W + row0) * W + lab % W


def merge_stripes(D: torch.Tensor, labels: torch.Tensor, p: ElasParams,
                  rows: int) -> torch.Tensor:
    """Unite stripe components across stripe edges (ccl_pl.py:342-381).
    D: (H, W); labels: (H, W) int64 stripe_labels of its stripes of `rows`
    rows (the last may be shorter), side by side.  A table T over the
    labels (identity at first) is relaxed with scatter-mins over the pairs
    of connected pixels across each edge, and path halving T[l] <- T[T[l]],
    until it stops changing: values only decrease and stay inside one
    component, so at the fixpoint T is constant over each component of the
    whole frame.  Returns T[labels]: the whole-frame partition."""
    H, W = D.shape
    edges = torch.arange(rows, H, rows, device=D.device)
    if edges.numel() == 0:
        return labels
    TL = labels[edges].reshape(-1)
    BL = labels[edges - 1].reshape(-1)
    up = connectivity(D, p, -1, 0)[edges].reshape(-1)
    T = torch.arange(H * W, dtype=torch.int64, device=D.device)
    big = torch.full_like(TL, H * W)
    while True:
        a, b = T[TL], T[BL]
        m = torch.where(up, torch.minimum(a, b), big)
        T = T.scatter_reduce(0, TL, m, "amin")
        T = T.scatter_reduce(0, BL, m, "amin")
        T = T.scatter_reduce(0, TL, T[T[TL]], "amin")
        T = T.scatter_reduce(0, BL, T[T[BL]], "amin")
        if torch.equal(T[TL], a) and torch.equal(T[BL], b):
            return T[labels]


def remove_small_segments_banded(D: torch.Tensor, p: ElasParams,
                                 rows: int) -> torch.Tensor:
    """The speckle filter run banded (the plain version of K3's banded
    mode): stripes of `rows` rows labelled on their own (stripe_labels),
    united across their edges (merge_stripes), then the size threshold.
    Equals remove_small_segments.  A batch is filtered one frame at a
    time."""
    if D.dim() == 3:
        return torch.stack([remove_small_segments_banded(x, p, rows)
                            for x in D])
    H = D.shape[0]
    labels = torch.cat([stripe_labels(D[lo:lo + rows], p, H, lo)
                        for lo in range(0, H, rows)])
    return drop_merged(D, labels, p, rows)


def drop_merged(D: torch.Tensor, labels: torch.Tensor, p: ElasParams,
                rows: int) -> torch.Tensor:
    """The filtered map from its stripes' labels (stripe_labels of stripes
    of `rows` rows, side by side): merge_stripes, then the size threshold.
    A batch is filtered one frame at a time."""
    if D.dim() == 3:
        return torch.stack([drop_merged(d, lab, p, rows)
                            for d, lab in zip(D, labels)])
    return _drop_small(D, merge_stripes(D, labels, p, rows), p)


# ---------------------------------------------------------------------------
# Gap interpolation


def _gap_pass_rows(D: torch.Tensor, gap: int, add_corners: bool):
    """One row-direction pass of gapInterpolation (reference
    elas.cpp:1144-1216), vectorized over rows."""
    H, W = D.shape
    valid = D >= 0
    idx = torch.arange(W, device=D.device)[None, :].expand(H, W)
    prev = torch.cummax(torch.where(valid, idx, -1), dim=1).values
    nxt_rev = torch.cummax(torch.flip(torch.where(valid, W - 1 - idx, -1),
                                      (1,)), dim=1).values
    nxt_rev = torch.flip(nxt_rev, (1,))
    nxt = torch.where(nxt_rev >= 0, W - 1 - nxt_rev, W)

    count = nxt - prev - 1
    can_fill = (~valid) & (prev >= 0) & (nxt < W) & (count >= 1) \
        & (count <= gap)
    # value at the nearest valid position at-or-before / at-or-after each
    # pixel, or the pixel's own value where there is none
    d1 = torch.where(prev >= 0, torch.gather(D, 1, prev.clamp(min=0)), D)
    d2 = torch.where(nxt < W, torch.gather(D, 1, nxt.clamp(max=W - 1)), D)
    fill = torch.where(torch.abs(d1 - d2) < 3.0, 0.5 * (d1 + d2),
                       torch.minimum(d1, d2))
    out = torch.where(can_fill, fill, D)

    if add_corners:
        first = torch.where(valid, idx, W).min(dim=1, keepdim=True).values
        last = torch.where(valid, idx, -1).max(dim=1, keepdim=True).values
        d_first = d2[:, :1]
        d_last = d1[:, -1:]
        left = (idx < first) & (idx >= first - gap) & (first < W)
        right = (idx > last) & (idx <= last + gap) & (last >= 0)
        out = torch.where(left, d_first, out)
        out = torch.where(right, d_last, out)
    return out


def gap_interpolation(D: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Row pass then column pass (reference elas.cpp:1126-1294), filling
    gaps of up to ipol_gap_width pixels, ipol_gap_width // 2 + 1 on the
    half lattice."""
    gap = p.ipol_gap_width // 2 + 1 if p.subsampling else p.ipol_gap_width
    H, W = D.shape[-2:]
    out = _gap_pass_rows(D.reshape(-1, W), gap, p.add_corners)
    cols = out.reshape(D.shape).transpose(-1, -2).reshape(-1, H)
    out = _gap_pass_rows(cols, gap, p.add_corners)
    return out.reshape(*D.shape[:-2], W, H).transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# Adaptive mean (approximated bilateral)


def _adaptive_pass(x: torch.Tensor, offsets, dim: int, centre_lo: int,
                   centre_hi_excl: int, ortho_lo: int, ortho_hi_excl: int):
    """One directional pass (taps at `offsets` along `dim`) writing only
    where the result is >= 0 inside the centre/ortho region (reference
    elas.cpp:1332-1485).

    The weighted sum is taken in tap order with the JAX reference's
    XLA:CPU contraction: fsum = fma(w0, t0, w1*t1), then
    fsum = fma(w_k, t_k, fsum) for k >= 2."""
    H, W = x.shape[-2:]
    wsum = None
    taps, wgts = [], []
    zero, four = _f32(0.0, x), _f32(4.0, x)
    for j in offsets:
        tap = _pad_roll(x, j, 0, _INVALID) if dim == 0 else \
            _pad_roll(x, 0, j, _INVALID)
        wgt = torch.maximum(zero, four - torch.abs(tap - x))
        wsum = wgt if wsum is None else wsum + wgt
        taps.append(tap)
        wgts.append(wgt)
    fsum = fma32(wgts[0], taps[0], wgts[1] * taps[1])
    for wgt, tap in zip(wgts[2:], taps[2:]):
        fsum = fma32(wgt, tap, fsum)
    d = fsum / torch.maximum(wsum, _f32(1e-20, x))
    write = (wsum > 0) & (d >= 0)

    ci = torch.arange(H if dim == 0 else W, device=x.device)
    oi = torch.arange(W if dim == 0 else H, device=x.device)
    c_ok = (ci >= centre_lo) & (ci < centre_hi_excl)
    o_ok = (oi >= ortho_lo) & (oi < ortho_hi_excl)
    region = (c_ok[:, None] & o_ok[None, :]) if dim == 0 \
        else (o_ok[:, None] & c_ok[None, :])
    written = region & write
    return torch.where(written, d, x), written


def adaptive_mean(D: torch.Tensor, p: ElasParams,
                  true_shape=None) -> torch.Tensor:
    """Separable approximated bilateral filter (reference
    elas.cpp:1297-1494): 8 taps at offsets -4..+3; the horizontal pass
    writes centres u in [4, W-4], rows v in [3, H-4]; the vertical pass
    consumes its result over centres v in [4, H-4], columns u in [3, W-4].
    On the half lattice: 4 taps at -2..+1, centres from 2 to n-2.
    Unwritten positions keep D.  true_shape=(Ho, Wo): the write regions of
    a map with padding rows below (padding rows untouched, real rows
    those of the unpadded map)."""
    H, W = true_shape or D.shape[-2:]
    Dc = torch.where(D < 0, _INVALID, D)
    lo, hi = (2, 1) if p.subsampling else (4, 3)
    offsets = range(-lo, lo)
    tmp, _ = _adaptive_pass(Dc, offsets, 1, lo, W - hi, 3, H - 3)
    val, written = _adaptive_pass(tmp, offsets, 0, lo, H - hi, 3, W - 3)
    return torch.where(written, val, D)


# ---------------------------------------------------------------------------
# Separable median


def _median_taps(x: torch.Tensor, dim: int) -> torch.Tensor:
    taps = [_pad_roll(x, j, 0, 0.0) if dim == 0 else _pad_roll(x, 0, j, 0.0)
            for j in range(-3, 4)]
    return torch.sort(torch.stack(taps), dim=0).values[3]


def median_filter(D: torch.Tensor, p: ElasParams,
                  true_shape=None) -> torch.Tensor:
    """Two-pass 7-tap separable median (reference elas.cpp:1496-1559):
    horizontal medians of D into a zero temp (only where D >= 0, only for
    u, v in [3, n-4]), then vertical medians of the temp back into D under
    the same conditions.  true_shape: as adaptive_mean's."""
    H, W = true_shape or D.shape[-2:]
    ui = torch.arange(D.shape[-1], device=D.device)[None, :]
    vi = torch.arange(D.shape[-2], device=D.device)[:, None]
    region = (ui >= 3) & (ui < W - 3) & (vi >= 3) & (vi < H - 3)
    med_h = _median_taps(D, 1)
    tmp = torch.where(region, torch.where(D >= 0, med_h, D), 0.0)
    med_v = _median_taps(tmp, 0)
    return torch.where(region & (D >= 0), med_v, D)
