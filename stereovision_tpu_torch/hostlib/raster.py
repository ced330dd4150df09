"""ctypes bindings for the native host helpers (csrc/svtpu_host.cpp: the
filters and rasterizer of stereovision_tpu/csrc/svtpu_host.cpp, copied, and
the port's own span coder), with NumPy fallbacks (counterpart of
stereovision_tpu/hostlib/raster.py).

The library is built with g++ at first use into build/stereovision_tpu_torch/
(see stereovision_tpu_torch.native), with the same flags as the JAX
package's build, so both packages run the same filters and rasterizer.
Where it cannot be built or loaded (no g++, a failed compile, a failed
load) get_lib() returns None, once and for good, and the native steps run
their NumPy versions, as the JAX package's do: filter_support_sequential
runs _filter_support_np (equal to the native filters), rasterize runs
rasterize_tri_ids, and hostlib.geometry.tri_span_code (sv_encode_tri_spans;
the JAX package codes spans in NumPy only) runs encode_tri_spans (equal
byte for byte).  The native rasterizer is built with -O3 -march=native,
which lets g++ contract its v = a * u + b into a fused multiply-add where
the CPU has one, so the two rasterizers may give some pixels to a
neighbouring triangle; each equals its JAX counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from .. import native

_SRC = os.path.join(native.CSRC_DIR, "svtpu_host.cpp")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


@functools.cache
def get_lib() -> Optional[ctypes.CDLL]:
    """Load the native host library, building it first if needed; None
    where it cannot be built or loaded (remembered: no later call tries
    again until get_lib.cache_clear())."""
    try:
        path = native.build_library(
            "svtt_host", [_SRC], _FLAGS,
            lambda tmp: [[["g++", *_FLAGS, _SRC, "-o", "out.so"]]])
        lib = ctypes.CDLL(path)
    except (RuntimeError, OSError):
        # RuntimeError: g++ failed; OSError: no g++ (FileNotFoundError) or
        # the load failed
        return None
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ci = ctypes.c_int
    lib.sv_filter_support.argtypes = [i16p, ci, ci, ci, ci, ci, ci, ci]
    lib.sv_filter_support.restype = None
    lib.sv_rasterize.argtypes = [i32p, ci, f32p, f32p, ci, ci, i32p]
    lib.sv_rasterize.restype = None
    lib.sv_encode_tri_spans.argtypes = [
        i32p, ci, ci, ctypes.c_long, ctypes.c_long, ctypes.c_int32, ci,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.sv_encode_tri_spans.restype = ci
    return lib


def filter_support_sequential(d_can: np.ndarray, p) -> np.ndarray:
    """Reference-exact sequential support filters (in-place scan-order
    semantics of elas.cpp:152-233).  d_can: (Hc, Wc) int16 -> filtered copy."""
    d = np.ascontiguousarray(d_can, dtype=np.int16).copy()
    hc, wc = d.shape
    lib = get_lib()
    if lib is None:
        return _filter_support_np(d, p)
    lib.sv_filter_support(d, hc, wc, p.incon_window_size,
                          p.incon_threshold, p.incon_min_support, 5, 1)
    return d


def _filter_support_np(D: np.ndarray, p) -> np.ndarray:
    """The native filters in Python, loop for loop (the JAX package's
    _filter_support_np, hostlib/raster.py:79-117): the inconsistency
    filter, then the redundancy filter vertically and horizontally, with
    the native call's redundancy distance 5 and threshold 1.  Filters D
    in place and returns it."""
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


def rasterize_tri_ids(pts: np.ndarray, tris: np.ndarray, right_image: bool,
                      width: int, height: int) -> np.ndarray:
    """Scanline-rasterize triangle ids into a dense (H, W) int32 map
    (-1 = no triangle), matching the reference's pixel-visit semantics
    (elas.cpp:854-941): corners sorted by ascending u; for each integer u
    in [corner0.u, corner2.u), v spans between the AC line and the AB/BC
    line, lower bound inclusive, upper exclusive; later triangles overwrite.

    The NumPy rasterizer of the JAX package (ops/planes.py:167-219), its
    float32 arithmetic kept as it is there: the product and the sum of
    v = a * u + b rounded apart, where the native rasterizer may fuse
    them.  rasterize runs it where the native library is unavailable.
    """
    tri_id = np.full((height, width), -1, np.int32)
    if len(tris) == 0:
        return tri_id
    u_all = pts[:, 0].astype(np.float32)
    if right_image:
        u_all = u_all - pts[:, 2].astype(np.float32)
    v_all = pts[:, 1].astype(np.float32)

    for i, (c1, c2, c3) in enumerate(tris):
        tu = np.array([u_all[c1], u_all[c2], u_all[c3]])
        tv = np.array([v_all[c1], v_all[c2], v_all[c3]])
        order = np.argsort(tu, kind="stable")
        tu, tv = tu[order], tv[order]
        A_u, B_u, C_u = tu
        A_v, B_v, C_v = tv
        AB_a = (A_v - B_v) / (A_u - B_u) if int(A_u) != int(B_u) else 0.0
        AC_a = (A_v - C_v) / (A_u - C_u) if int(A_u) != int(C_u) else 0.0
        BC_a = (B_v - C_v) / (B_u - C_u) if int(B_u) != int(C_u) else 0.0
        AB_b = A_v - AB_a * A_u
        AC_b = A_v - AC_a * A_u
        BC_b = B_v - BC_a * B_u

        for (lo, hi, a2, b2) in ((A_u, B_u, AB_a, AB_b),
                                 (B_u, C_u, BC_a, BC_b)):
            if int(lo) == int(hi):
                continue
            u0 = max(int(lo), 0)
            u1 = min(int(hi), width)
            if u1 <= u0:
                continue
            us = np.arange(u0, u1, dtype=np.float32)
            v1 = (AC_a * us + AC_b).astype(np.int32)
            v2 = (a2 * us + b2).astype(np.int32)
            vlo = np.minimum(v1, v2)
            vhi = np.maximum(v1, v2)
            for k, u in enumerate(range(u0, u1)):
                a, b = int(vlo[k]), int(vhi[k])
                a = max(a, 0)
                b = min(b, height)
                if b > a:
                    tri_id[a:b, u] = i
    return tri_id


def rasterize(pts: np.ndarray, tris: np.ndarray, right_image: bool,
              width: int, height: int) -> np.ndarray:
    """Scanline triangle-id rasterizer -> (height, width) int32 (-1 = no
    triangle); reference pixel-visit semantics, elas.cpp:839-941.  The
    native one, or rasterize_tri_ids where the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return rasterize_tri_ids(pts, tris, right_image, width, height)
    tri_id = np.empty((height, width), np.int32)
    if len(tris) == 0:
        tri_id.fill(-1)
        return tri_id
    pu = pts[:, 0].astype(np.float32)
    if right_image:
        pu = pu - pts[:, 2].astype(np.float32)
    pv = pts[:, 1].astype(np.float32)
    tris32 = np.ascontiguousarray(tris, dtype=np.int32)
    lib.sv_rasterize(tris32, len(tris32), np.ascontiguousarray(pu),
                     np.ascontiguousarray(pv), width, height, tri_id)
    return tri_id
