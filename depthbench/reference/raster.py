"""The host middle's support filters and triangle rasterizer, in NumPy.

filter_support_sequential is the port's `_filter_support_np` as frozen
(the reference's sequential in-place filters, elas.cpp:152-233).

rasterize is the reference's scanline rasterizer (elas.cpp:839-941) as the
port's native helper computes it: that helper is C++ built with -O3
-march=native, where g++ contracts `A_v - a * A_u` and `a * u + b` into
fused multiply-adds.  Here each fused step is one float64 sum of an exact
float32 product, rounded once to float32.  The pixels of a column that a
triangle covers are painted in triangle order, so the last triangle wins:
each pixel takes the largest id among the triangles that cover it.
"""

from __future__ import annotations

import numpy as np


def filter_support_sequential(d_can: np.ndarray, p) -> np.ndarray:
    """(Hc, Wc) int16 support grid -> a filtered copy: the inconsistency
    filter, then the redundancy filter vertically and horizontally (the
    native call's distance 5 and threshold 1)."""
    D = np.ascontiguousarray(d_can, dtype=np.int16).copy()
    hc, wc = D.shape
    w, thr, mins = p.incon_window_size, p.incon_threshold, p.incon_min_support
    for u in range(wc):
        for v in range(hc):
            d = D[v, u]
            if d < 0:
                continue
            win = D[max(0, v - w):v + w + 1, max(0, u - w):u + w + 1]
            supp = int(((win >= 0) & (np.abs(win - d) <= thr)).sum())
            if supp < mins:
                D[v, u] = -1
    for vertical in (True, False):
        dirs = ((-1, 0), (1, 0)) if vertical else ((0, -1), (0, 1))
        for u in range(wc):
            for v in range(hc):
                d = D[v, u]
                if d < 0:
                    continue
                red = True
                for dv, du in dirs:
                    found = False
                    vv, uu = v, u
                    for _ in range(5):
                        vv += dv
                        uu += du
                        if not (0 <= vv < hc and 0 <= uu < wc):
                            break
                        if D[vv, uu] >= 0 and abs(int(d) - int(D[vv, uu])) <= 1:
                            found = True
                            break
                    if not found:
                        red = False
                        break
                if red:
                    D[v, u] = -1
    return D


def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding (a, b, c float32)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def rasterize(pts: np.ndarray, tris: np.ndarray, right_image: bool,
              width: int, height: int) -> np.ndarray:
    """Triangle ids -> (height, width) int32 map, -1 where no triangle."""
    tri_id = np.full((height, width), -1, np.int32)
    T = len(tris)
    if T == 0:
        return tri_id
    u_all = pts[:, 0].astype(np.float32)
    if right_image:
        u_all = u_all - pts[:, 2].astype(np.float32)
    v_all = pts[:, 1].astype(np.float32)
    tris = np.asarray(tris, np.int64)
    tu, tv = u_all[tris], v_all[tris]                   # (T, 3) float32
    # corners in ascending u, ties kept in their order (stable)
    order = np.argsort(tu, axis=1, kind="stable")
    tu = np.take_along_axis(tu, order, 1)
    tv = np.take_along_axis(tv, order, 1)
    iu = tu.astype(np.int32)                           # C's (int) casts

    def slope(i, j):
        ok = iu[:, i] != iu[:, j]
        du = np.where(ok, tu[:, i] - tu[:, j], np.float32(1))
        return np.where(ok, (tv[:, i] - tv[:, j]) / du,
                        np.float32(0)).astype(np.float32)

    ab_a, ac_a, bc_a = slope(0, 1), slope(0, 2), slope(1, 2)
    ab_b = _fma(-ab_a, tu[:, 0], tv[:, 0])
    ac_b = _fma(-ac_a, tu[:, 0], tv[:, 0])
    bc_b = _fma(-bc_a, tu[:, 1], tv[:, 1])
    ids, cols, lo, hi = [], [], [], []
    for k, (a2, b2) in enumerate(((ab_a, ab_b), (bc_a, bc_b))):
        u0 = np.maximum(iu[:, k], 0)
        u1 = np.minimum(iu[:, k + 1], width)
        n = np.where(iu[:, k] != iu[:, k + 1], np.maximum(u1 - u0, 0), 0)
        t = np.repeat(np.arange(T), n)
        u = (np.repeat(u0, n) + np.arange(n.sum())
             - np.repeat(np.cumsum(n) - n, n))
        uf = u.astype(np.float32)
        v1 = _fma(ac_a[t], uf, ac_b[t]).astype(np.int32)
        v2 = _fma(a2[t], uf, b2[t]).astype(np.int32)
        ids.append(t)
        cols.append(u)
        lo.append(np.maximum(np.minimum(v1, v2), 0))
        hi.append(np.minimum(np.maximum(v1, v2), height))
    t, u, lo, hi = (np.concatenate(x) for x in (ids, cols, lo, hi))
    n = np.maximum(hi - lo, 0)
    t, u, lo = np.repeat(t, n), np.repeat(u, n), np.repeat(lo, n)
    v = lo + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    flat = tri_id.reshape(-1)
    np.maximum.at(flat, v.astype(np.int64) * width + u, t.astype(np.int32))
    return tri_id
