"""ctypes bindings for the native host helpers (csrc/svtpu_host.cpp, a copy
of stereovision_tpu/csrc/svtpu_host.cpp).

The library is built with g++ at first use into build/stereovision_tpu_torch/
(see stereovision_tpu_torch.native), with the same flags as the JAX
package's build, so both packages run the same host code.  There is no
NumPy fallback: the sequential support filters are load-bearing (the
snapshot formulation keeps far fewer support points), so a missing
compiler is an error.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..native import CSRC_DIR, build_library

_SRC = os.path.join(CSRC_DIR, "svtpu_host.cpp")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


@functools.cache
def get_lib() -> ctypes.CDLL:
    """Load the native host library, building it first if needed."""
    path = build_library(
        "svtt_host", [_SRC], _FLAGS,
        lambda tmp: [[["g++", *_FLAGS, _SRC, "-o", "out.so"]]])
    lib = ctypes.CDLL(path)
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ci = ctypes.c_int
    lib.sv_filter_support.argtypes = [i16p, ci, ci, ci, ci, ci, ci, ci]
    lib.sv_filter_support.restype = None
    lib.sv_rasterize.argtypes = [i32p, ci, f32p, f32p, ci, ci, i32p]
    lib.sv_rasterize.restype = None
    return lib


def filter_support_sequential(d_can: np.ndarray, p) -> np.ndarray:
    """Reference-exact sequential support filters (in-place scan-order
    semantics of elas.cpp:152-233).  d_can: (Hc, Wc) int16 -> filtered copy."""
    d = np.ascontiguousarray(d_can, dtype=np.int16).copy()
    hc, wc = d.shape
    get_lib().sv_filter_support(d, hc, wc, p.incon_window_size,
                                p.incon_threshold, p.incon_min_support, 5, 1)
    return d


def rasterize(pts: np.ndarray, tris: np.ndarray, right_image: bool,
              width: int, height: int) -> np.ndarray:
    """Scanline triangle-id rasterizer -> (height, width) int32 (-1 = no
    triangle); reference pixel-visit semantics, elas.cpp:839-941."""
    tri_id = np.empty((height, width), np.int32)
    if len(tris) == 0:
        tri_id.fill(-1)
        return tri_id
    pu = pts[:, 0].astype(np.float32)
    if right_image:
        pu = pu - pts[:, 2].astype(np.float32)
    pv = pts[:, 1].astype(np.float32)
    tris32 = np.ascontiguousarray(tris, dtype=np.int32)
    get_lib().sv_rasterize(tris32, len(tris32), np.ascontiguousarray(pu),
                           np.ascontiguousarray(pv), width, height, tri_id)
    return tri_id
