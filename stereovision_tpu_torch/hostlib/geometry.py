"""The host middle of the pipeline, in NumPy, SciPy and the C++ helpers:
support grid -> support points, Delaunay triangles, triangle-id maps and
their span codes (counterparts of stereovision_tpu/ops/planes.py:34-122,
stereovision_tpu/ops/spans.py:37 and stereovision_tpu/models/elas.py:40-109).

Native where the host library loads (hostlib.raster.get_lib): the support
filters, the rasterizer and the span coding (tri_span_code: one C++ pass a
map, which masks ids >= t_max and reads the output lattice in place).  In
NumPy and SciPy always: the support list, the corners and the padding, and
the Delaunay triangulation (Qhull).  Where the library is unavailable, each
native step runs its NumPy version (the span coding: np.where, the lattice
slice and encode_tri_spans, the native coder's oracle, equal byte for byte).

This module imports no torch: the host-geometry process pool's spawned
workers and the side worker import it (and hostlib.raster, params,
profiling) and nothing else of the package.

Spans (profiling.py; recorded only while tracing is on): host_mid opens
"svtt.host_mid" with the counts support (points after the filters, corners
included), thinned (the points found where more than the cap were, else
0), tris_l, tris_r, runs_max (the span code's longest row, against s_max),
native (1 where the C++ library loaded, 0 on the NumPy fallbacks) and
side (1 where the right image's half ran in a side worker, 0 where it ran
in this process); its children are "svtt.host_mid.filters", then
"svtt.host_mid.delaunay", "svtt.host_mid.raster" and
"svtt.host_mid.span_code" an image each (host_side: the left's, then the
right's), the last with the counts runs (its longest row) and native (1
where the C++ coder ran, 0 on encode_tri_spans).  Under side 1 the right
image's three come from the side worker's process, overlapping the
left's, and "svtt.host_mid.join" is the wait for them (hostlib/side.py).
A pool worker records them when the call asks (_pool_host_mid) and hands
them back under "spans".

Reference equivalents:
  computeDelaunayTriangulation  src/serial_includes/elas/elas.cpp:442-501
  addCornerSupportPoints        elas.cpp:235-264

The span code (decoded on the device by ops.spans.expand_tri_spans) is
(H, S, 3) uint8 of [gap, id_lo, id_hi], 3 bytes a run: gap is the column
delta from the previous run's start (0 for the first run of a row), gaps
over 255 are split into filler runs that repeat the previous id, and the
id is a little-endian uint16 with 0xFFFF for -1.  Rows are padded with
repeat-fillers.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay

from .. import profiling as P
from ..params import ElasParams
from .raster import filter_support_sequential, get_lib, rasterize


def _warn(msg: str, notes: Optional[List[str]]) -> None:
    """Append msg to notes, or warn with it where there is no list."""
    if notes is None:
        warnings.warn(msg)
    else:
        notes.append(msg)


def support_points_from_grid(d_can: np.ndarray, step: int) -> np.ndarray:
    """Dense candidate grid -> (N, 3) int32 [u, v, d] support points, in the
    reference's u-major emission order (elas.cpp:424-428)."""
    Hc, Wc = d_can.shape
    uc_idx, vc_idx = np.meshgrid(np.arange(Wc), np.arange(Hc), indexing="ij")
    dT = np.asarray(d_can).T  # (Wc, Hc) so iteration order matches u-major
    mask = dT >= 0
    us = (uc_idx[mask] * step).astype(np.int32)
    vs = (vc_idx[mask] * step).astype(np.int32)
    ds = dT[mask].astype(np.int32)
    return np.stack([us, vs, ds], axis=1).astype(np.int32)


def add_corner_support_points(pts: np.ndarray, width: int,
                              height: int) -> np.ndarray:
    """Append 6 border points with nearest-neighbour disparities
    (reference elas.cpp:235-264)."""
    border = np.array(
        [[0, 0, 0], [0, height - 1, 0], [width - 1, 0, 0],
         [width - 1, height - 1, 0]], dtype=np.int64)
    if len(pts):
        for i in range(4):
            du = border[i, 0] - pts[:, 0].astype(np.int64)
            dv = border[i, 1] - pts[:, 1].astype(np.int64)
            j = np.argmin(du * du + dv * dv)
            border[i, 2] = pts[j, 2]
    extra = np.array(
        [[border[2, 0] + border[2, 2], border[2, 1], border[2, 2]],
         [border[3, 0] + border[3, 2], border[3, 1], border[3, 2]]],
        dtype=np.int64)
    allb = np.concatenate([border, extra], axis=0).astype(np.int32)
    return np.concatenate([pts, allb], axis=0) if len(pts) else allb


def triangulate(pts: np.ndarray, right_image: bool) -> np.ndarray:
    """Delaunay triangulation of support points; for the right image the
    points are projected to (u - d, v) (reference elas.cpp:451-461).
    Returns (T, 3) int32 corner indices (SciPy's Qhull, as in the JAX
    package)."""
    if right_image:
        xy = np.stack([pts[:, 0] - pts[:, 2], pts[:, 1]], 1).astype(np.float64)
    else:
        xy = pts[:, :2].astype(np.float64)
    if len(xy) < 3:
        return np.zeros((0, 3), np.int32)
    try:
        tri = Delaunay(xy)
    except Exception:   # Qhull rejects degenerate (e.g. collinear) sets
        return np.zeros((0, 3), np.int32)
    return tri.simplices.astype(np.int32)


def support_points(d_can: np.ndarray, p: ElasParams, width: int,
                   height: int, n_cap: Optional[int] = None,
                   notes: Optional[List[str]] = None) -> np.ndarray:
    """Support grid -> the final (N, 3) int32 support points that both
    images triangulate: the grid's points, thinned UNIFORMLY where there
    are more than n_cap (the engine's pad size) less the corner slots, so
    that triangle indices stay consistent with the shipped point list,
    then the corner points.  notes: a list that takes the thinning's
    warning in place of the warnings module."""
    pts = support_points_from_grid(np.asarray(d_can), p.step)
    margin = 6 if p.add_corners else 0   # corner slots only when appended
    if n_cap is not None and len(pts) > n_cap - margin:
        keep = n_cap - margin
        P.count(thinned=len(pts))
        _warn("support points thinned: %d -> %d (n_max=%d)"
              % (len(pts), keep, n_cap), notes)
        pts = pts[np.arange(keep) * len(pts) // keep]
    if p.add_corners:
        pts = add_corner_support_points(pts, width, height)
    return pts


def _tri_ids(pts: np.ndarray, right: bool, width: int, height: int,
             rasterize=rasterize) -> Tuple[np.ndarray, np.ndarray]:
    """One image's Delaunay triangles (T, 3) int32 and its (H, W) int32
    triangle-id map."""
    with P.span("svtt.host_mid.delaunay"):
        tris = triangulate(pts, right)
    with P.span("svtt.host_mid.raster"):
        return tris, rasterize(pts, tris, right, width, height)


def host_geometry(d_can: np.ndarray, p: ElasParams, width: int, height: int,
                  rasterize, n_cap: Optional[int] = None,
                  notes: Optional[List[str]] = None):
    """Host middle stage: support grid -> support points, triangles and
    triangle-id maps (the JAX host_geometry without its f64 oracle planes,
    which the engine never reads).  n_cap and notes: support_points'.

    Returns dict with pts (N, 3) int32, tris_l/r (T, 3) int32 and
    tri_id_l/r (H, W) int32."""
    out = {"pts": support_points(d_can, p, width, height, n_cap, notes)}
    for right, tag in ((False, "l"), (True, "r")):
        out["tris_" + tag], out["tri_id_" + tag] = _tri_ids(
            out["pts"], right, width, height, rasterize)
    return out


def _check_ids(tri: np.ndarray) -> None:
    """Raise where an id of the (masked) map does not fit the codec."""
    if tri.max(initial=-1) >= 0xFFFF:
        raise ValueError("triangle id %d overflows the uint16 span codec"
                         % int(tri.max()))


def _count_runs(runs: int, s_max: int, notes: Optional[List[str]]) -> None:
    """Count the longest row's runs; warn where they overflow s_max."""
    P.count(runs=runs)
    if runs > s_max:
        _warn("tri-span overflow: row has %d runs > s_max=%d; tail runs "
              "dropped (approximate)" % (runs, s_max), notes)


def encode_tri_spans(tri: np.ndarray, s_max: int,
                     notes: Optional[List[str]] = None) -> np.ndarray:
    """Dense (H, W) int triangle-id map -> (H, s_max, 3) uint8 packed spans.
    Rows with more than s_max runs keep their first s_max (the previous id
    then persists over the dropped tail) and a warning is emitted (into
    notes, where it is given)."""
    tri = np.asarray(tri)
    _check_ids(tri)
    H, W = tri.shape
    change = np.empty((H, W), dtype=bool)
    change[:, 0] = True
    np.not_equal(tri[:, 1:], tri[:, :-1], out=change[:, 1:])
    counts = change.sum(axis=1)
    rows, cols = np.nonzero(change)           # row-major order
    offsets = np.cumsum(counts) - counts
    k = np.arange(rows.size) - offsets[rows]  # run index within row
    ids = tri[rows, cols].astype(np.int64)

    gaps = np.empty_like(cols)
    first = k == 0
    gaps[first] = cols[first]                 # == 0 by construction
    gaps[~first] = cols[~first] - cols[np.nonzero(~first)[0] - 1]
    # split gaps > 255 into repeat-fillers that precede their run
    n_ins = np.maximum(0, (gaps + 254) // 255 - 1)
    ins_incl = np.cumsum(n_ins)
    ins_excl = ins_incl - n_ins
    row_base = ins_excl[offsets[rows]] if rows.size else ins_excl
    k_new = k + (ins_incl - row_base)
    gaps_real = gaps - 255 * n_ins            # in [0, 255]

    new_counts = np.zeros(H, np.int64)
    if rows.size:
        np.add.at(new_counts, rows, 1 + n_ins)
    _count_runs(int(new_counts.max(initial=0)), s_max, notes)

    # every slot starts as a filler repeating the row's last run id; real
    # runs and the mid-row fillers of >255-column gaps are scattered in
    out_gap = np.full((H, s_max), 255, np.uint8)
    out_id = np.broadcast_to(tri[:, -1:].astype(np.int64),
                             (H, s_max)).copy()
    sel = k_new < s_max
    out_gap[rows[sel], k_new[sel]] = gaps_real[sel]
    out_id[rows[sel], k_new[sel]] = ids[sel]
    big = np.nonzero(n_ins > 0)[0]            # flat run indices (never k=0)
    if big.size:
        n = n_ins[big]
        rep = np.repeat(big, n)
        offs = np.arange(rep.size) - np.repeat(np.cumsum(n) - n, n)
        kf = np.repeat(k_new[big] - n, n) + offs
        fsel = kf < s_max
        out_gap[np.repeat(rows[big], n)[fsel], kf[fsel]] = 255
        out_id[np.repeat(rows[big], n)[fsel], kf[fsel]] = ids[rep[fsel] - 1]

    u16 = (out_id & 0xFFFF).astype(np.uint16)  # -1 -> 0xFFFF
    packed = np.empty((H, s_max, 3), np.uint8)
    packed[..., 0] = out_gap
    packed[..., 1] = u16 & 0xFF
    packed[..., 2] = u16 >> 8
    return packed


def tri_span_code(tri_id: np.ndarray, t_max: int, s_max: int,
                  shape: Tuple[int, int], step: int,
                  notes: Optional[List[str]] = None) -> np.ndarray:
    """A rasterized (H, W) int32 triangle-id map -> the span code of its
    output lattice tri_id[::step, ::step][:Ho, :Wo] (shape = (Ho, Wo)),
    ids >= t_max read as -1: encode_tri_spans of that lattice, byte for
    byte, with its count and warning, in one native pass that reads the
    map in place.  Where the library is unavailable, the lattice is masked
    and sliced in NumPy and encode_tri_spans codes it; the count native
    says which ran."""
    lib = get_lib()
    P.count(native=int(lib is not None))
    Ho, Wo = shape
    if lib is None:
        tri = np.where(tri_id >= t_max, -1, tri_id)
        return encode_tri_spans(tri[::step, ::step][:Ho, :Wo], s_max, notes)
    tri_id = np.ascontiguousarray(tri_id, dtype=np.int32)
    H, W = tri_id.shape
    if not (0 < Ho <= -(-H // step) and 0 < Wo <= -(-W // step)):
        raise ValueError("lattice %dx%d at step %d outside a %dx%d map"
                         % (Wo, Ho, step, W, H))
    out = np.empty((Ho, s_max, 3), np.uint8)
    runs = lib.sv_encode_tri_spans(tri_id, Ho, Wo, step * W, step,
                                   min(t_max, np.iinfo(np.int32).max),
                                   s_max, out)
    if runs < 0:    # an id >= 0xFFFF survived the mask
        _check_ids(np.where(tri_id >= t_max, -1,
                            tri_id)[::step, ::step][:Ho, :Wo])
    _count_runs(runs, s_max, notes)
    return out


def host_side(pts: np.ndarray, right: bool, params: ElasParams, width: int,
              height: int, t_max: int, s_max: int,
              notes: Optional[List[str]] = None
              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """One image's half of the host middle on the final support points
    (support_points): Delaunay, the triangle-id raster and its span code
    on the output lattice.  -> (tris (T, 3) int32, span code (Ho, s_max,
    3) uint8, runs: the code's longest row, 0 while recording is off).
    notes, where given, takes the span overflow's warning."""
    tris, tri_id = _tri_ids(pts, right, width, height)
    step = 2 if params.subsampling else 1
    with P.span("svtt.host_mid.span_code") as sc:
        code = tri_span_code(tri_id, t_max, s_max,
                             params.out_shape(width, height), step, notes)
    return tris, code, sc.counts.get("runs", 0)


def host_mid(d_can: np.ndarray, params: ElasParams, width: int, height: int,
             n_max: int, t_max: int, s_max: int, host_filters: bool = True,
             notes: Optional[List[str]] = None,
             side=None) -> Dict[str, np.ndarray]:
    """Support grid -> padded geometry arrays (fixed shapes): pts (n_max, 3)
    int16, tris_l/r (t_max, 3) int16 and the triangle-id maps on the output
    lattice as span codes tri_l/r (Ho, s_max, 3) uint8.  host_filters=True
    applies the reference's sequential support filters first; notes, where
    given, takes the warnings.

    side: a hostlib.side.SideWorker, or None.  Where the worker takes the
    right image's half (SideWorker.submit), it computes it while this call
    computes the left's; else, and where the worker fails, the right half
    runs here after the left.  The arrays and the warnings, in their
    order, are the same either way."""
    with P.span("svtt.host_mid", thinned=0) as hm:
        d_can = np.asarray(d_can)
        if host_filters:
            with P.span("svtt.host_mid.filters"):
                d_can = filter_support_sequential(d_can, params)
        points = support_points(d_can, params, width, height, n_max, notes)
        args = (params, width, height, t_max, s_max)
        handed = side is not None and side.submit(points, P.recording())
        try:
            left = host_side(points, False, *args, notes)
        finally:
            if handed:
                with P.span("svtt.host_mid.join"):
                    right = side.result()
        took = int(handed and right is not None)
        if took:
            *right, msgs, spans = right
            P.ingest(spans, P.current_frame())
            for msg in msgs:
                _warn(msg, notes)
        else:
            right = host_side(points, True, *args, notes)
        pts = np.full((n_max, 3), -1, np.int16)
        n = min(len(points), n_max)
        pts[:n] = points[:n]
        out = {"pts": pts}
        tris, runs = {}, 0
        for tag, (tri, code, r) in zip("lr", (left, right)):
            tr = np.full((t_max, 3), -1, np.int16)
            tris[tag] = t = min(len(tri), t_max)
            tr[:t] = tri[:t]
            out["tris_" + tag], out["tri_" + tag] = tr, code
            runs = max(runs, r)
        hm.add(support=n, tris_l=tris["l"], tris_r=tris["r"],
               runs_max=runs, native=int(get_lib() is not None), side=took)
    return out


def host_mid_standalone(d_can: np.ndarray, params: ElasParams, width: int,
                        height: int, n_max: int, t_max: int, s_max: int,
                        host_filters: bool = True) -> Dict[str, np.ndarray]:
    """host_mid plus a "warnings" entry (picklable; what the process pool
    and the host threads run).  Its warnings (support thinning, span
    overflow: the silent-accuracy channels) would vanish inside a pool's
    worker, so they are collected as strings, to be re-emitted on the
    parent's side.  They are collected without the warnings module, whose
    catch_warnings is not safe under threads."""
    notes: List[str] = []
    out = host_mid(d_can, params, width, height, n_max, t_max, s_max,
                   host_filters, notes)
    out["warnings"] = notes
    return out


_POOL_CFG = {}


def _pool_init(params, width, height, n_max, t_max, s_max, host_filters):
    _POOL_CFG.update(params=params, width=width, height=height,
                     n_max=n_max, t_max=t_max, s_max=s_max,
                     host_filters=host_filters)


def _pool_host_mid(d_can, trace: bool = False):
    """host_mid_standalone in a pool worker; trace=True records its spans
    and returns them under "spans" (profiling.Span)."""
    c = _POOL_CFG
    if trace:
        P.trace_start()
    try:
        out = host_mid_standalone(d_can, c["params"], c["width"],
                                  c["height"], c["n_max"], c["t_max"],
                                  c["s_max"], c["host_filters"])
    finally:
        if trace:
            P.trace_stop()
    if trace:
        out["spans"] = P.trace_drain()["spans"]
    return out
