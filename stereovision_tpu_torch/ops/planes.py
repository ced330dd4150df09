"""Host-side geometry (support points, Delaunay, triangle-id rasterization)
and the device-side plane fit (counterpart of
stereovision_tpu/ops/planes.py:34-267).

The host parts are NumPy/SciPy copies of the JAX package's; the plane fit
runs in PyTorch on the stage-B device.

Reference equivalents:
  computeDelaunayTriangulation  src/serial_includes/elas/elas.cpp:442-501
  computeDisparityPlanes        elas.cpp:503-575
  addCornerSupportPoints        elas.cpp:235-264
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
from scipy.spatial import Delaunay

from ..params import ElasParams
from .fma import fma32


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


def host_geometry(d_can: np.ndarray, p: ElasParams, width: int, height: int,
                  rasterize, n_cap: Optional[int] = None):
    """Host middle stage: support grid -> support points, triangles and
    triangle-id maps (the JAX host_geometry without its f64 oracle planes,
    which the engine never reads).

    n_cap: hard cap on support points (the engine's pad size); overflow is
    thinned UNIFORMLY before triangulation so triangle indices stay
    consistent with the shipped point list.

    Returns dict with pts (N, 3) int32, tris_l/r (T, 3) int32 and
    tri_id_l/r (H, W) int32."""
    pts = support_points_from_grid(np.asarray(d_can), p.step)
    margin = 6 if p.add_corners else 0   # corner slots only when appended
    if n_cap is not None and len(pts) > n_cap - margin:
        keep = n_cap - margin
        warnings.warn("support points thinned: %d -> %d (n_max=%d)"
                      % (len(pts), keep, n_cap))
        pts = pts[np.arange(keep) * len(pts) // keep]
    if p.add_corners:
        pts = add_corner_support_points(pts, width, height)
    out = {"pts": pts}
    for right, tag in ((False, "l"), (True, "r")):
        tris = triangulate(pts, right)
        out["tris_" + tag] = tris
        out["tri_id_" + tag] = rasterize(pts, tris, right, width, height)
    return out


def fit_plane_tables(pts: torch.Tensor, tris: torch.Tensor):
    """(N, 3) int support points [u, v, d] + (T, 3) int triangle vertex
    indices -> (T, 4) f32 tables [a, b, c, a_other] for the left and the
    right image (counterpart of ops/planes.py:124).

    Exact integer Cramer solve in vertex-0-translated coordinates, then f32
    ratios; c = d0 - a*u0 - b*v0 is evaluated as
    fma(-b, v0, fma(-a, u0, d0)), the form the JAX reference's XLA:CPU
    path computes.  Negative index rows (padding) give all-zero planes."""
    tris = tris.to(torch.int64)
    P = pts.to(torch.int32)[torch.clamp(tris, min=0)]
    u, v, d = P[..., 0], P[..., 1], P[..., 2]

    def solve2(uc):
        u1, u2 = uc[..., 1] - uc[..., 0], uc[..., 2] - uc[..., 0]
        v1, v2 = v[..., 1] - v[..., 0], v[..., 2] - v[..., 0]
        d1, d2 = d[..., 1] - d[..., 0], d[..., 2] - d[..., 0]
        det = u1 * v2 - u2 * v1                     # exact int32
        ok = det != 0
        detf = torch.where(ok, det, 1).to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=pts.device)
        a = torch.where(ok, (d1 * v2 - d2 * v1).to(torch.float32) / detf, zero)
        b = torch.where(ok, (u1 * d2 - u2 * d1).to(torch.float32) / detf, zero)
        c = fma32(-b, v[..., 0].to(torch.float32),
                  fma32(-a, uc[..., 0].to(torch.float32),
                        d[..., 0].to(torch.float32)))
        return a, b, torch.where(ok, c, zero)

    al, bl, cl = solve2(u)
    ar, br, cr = solve2(u - d)
    valid = (tris[..., 0] >= 0).to(torch.float32)[..., None]
    left = torch.stack([al, bl, cl, ar], dim=-1) * valid
    right = torch.stack([ar, br, cr, al], dim=-1) * valid
    return left, right
