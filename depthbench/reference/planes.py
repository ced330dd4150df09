"""The device-side plane fit (counterpart of
stereovision_tpu/ops/planes.py:124-267); the host geometry it reads
(support points, Delaunay, triangle-id maps) is hostlib/geometry.py.

Reference equivalent: computeDisparityPlanes, elas.cpp:503-575.
"""

from __future__ import annotations

import torch

from .fma import fma32


def fit_plane_tables(pts: torch.Tensor, tris: torch.Tensor):
    """(N, 3) int support points [u, v, d] + (T, 3) int triangle vertex
    indices -> (T, 4) f32 tables [a, b, c, a_other] for the left and the
    right image (counterpart of ops/planes.py:124).

    Exact integer Cramer solve in vertex-0-translated coordinates, then f32
    ratios; c = d0 - a*u0 - b*v0 is evaluated as
    fma(-b, v0, fma(-a, u0, d0)), the form the JAX reference's XLA:CPU
    path computes.  Negative index rows (padding) give all-zero planes.
    A batch, (B, N, 3) points and (B, T, 3) triangles, gives (B, T, 4)
    tables, each frame's from its own points."""
    tris = tris.to(torch.int64)
    if tris.dim() == 2:
        P = pts.to(torch.int32)[torch.clamp(tris, min=0)]
    else:
        b = torch.arange(tris.shape[0], device=tris.device)[:, None, None]
        P = pts.to(torch.int32)[b, torch.clamp(tris, min=0)]
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
