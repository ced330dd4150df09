"""Python half of the embeddable C ABI (counterpart of
stereovision_tpu/capi.py).

The reference ships its whole pipeline as a shared library exporting
``extern "C" generatePointCloud(...)`` / ``getColor()`` / ``clean()``
(src/serial_includes/main/stereo_vision.cpp:565-628 and :106-114), which
its pip wrapper drives via ctypes (stereo_vision/sv.py:164-192) and any
C/C++ application can dlopen.  The port keeps that surface:
``csrc/svtpu_capi.cpp``, built by library_path(), embeds CPython (or joins
the running interpreter when loaded via ctypes), imports THIS module and
forwards the identical argument list here.  The functions below therefore
follow C calling conventions, not Python ones: raw pixel buffers in, a raw
``double*`` (as an address) out, with the module holding the array alive
until the next call — the same lifetime contract as the reference's static
``points`` buffer.

Frames arrive as the reference's CV_8UC4 layout: ``width*height*4``
bytes of BGRA (stereo_vision.cpp:587-588 wraps the pointers as
``Mat(Size(w, h), CV_8UC4, ptr)``).  The engine runs on the card; set
DEVICE = "cpu" before the first generate() to run it on the CPU.
"""

from __future__ import annotations

import os
import sysconfig

import numpy as np

from .native import CSRC_DIR, build_library

# where the engine runs: None is the card
DEVICE = None

_SRC = os.path.join(CSRC_DIR, "svtpu_capi.cpp")
_sv = None
_last = None
_last_colors = None


def library_path() -> str:
    """The C ABI's shared library, built with g++ at first use into
    build/stereovision_tpu_torch/ against the running interpreter's headers
    and libpython (sysconfig).  Load it with RTLD_GLOBAL, so that extension
    modules resolve libpython's symbols."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError("this interpreter has no shared libpython: the "
                           "C ABI cannot embed it")
    libdir = sysconfig.get_config_var("LIBDIR")
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17",
             "-I" + sysconfig.get_paths()["include"]]
    link = ["-L" + libdir, "-l:" + sysconfig.get_config_var("LDLIBRARY"),
            "-Wl,-rpath," + libdir]
    return build_library(
        "svtt_capi", [_SRC], flags + link,
        lambda tmp: [[["g++", *flags, _SRC, "-o", "out.so", *link]]])


def generate(left, right, calibration_yaml, width, height,
             kitti_calibration, object_tracking, graphics, display,
             scale, pc_extrapolation, yolo_cfg, yolo_weights, yolo_classes,
             remove_sky, subsampling):
    """One frame through the engine; returns the ADDRESS (int) of a
    C-contiguous (pc_w*pc_h, 3) float64 point-cloud array.

    left/right: buffer objects of width*height*4 BGRA bytes.  Engine
    construction happens on the first call and subsequent calls reuse it,
    mirroring the reference's ``static int init = externalInit(...)``
    (stereo_vision.cpp:582-584) — configuration arguments after the first
    call are ignored, like the reference.
    """
    global _sv, _last, _last_colors
    if _sv is None:
        from .engine import StereoVision
        _sv = StereoVision(
            width=width, height=height,
            defaultCalibFile=bool(kitti_calibration),
            objectTracking=bool(object_tracking),
            graphics=bool(graphics), display=bool(display),
            scale=scale, pc_extrapolation=pc_extrapolation,
            YOLO_CFG=yolo_cfg or None,
            YOLO_WEIGHTS=yolo_weights or None,
            YOLO_CLASSES=yolo_classes or None,
            CAMERA_CALIBRATION_YAML=calibration_yaml or None,
            subsampling=bool(subsampling), device=DEVICE)
        if remove_sky:
            _sv.engine.remove_sky = True

    n = width * height

    def as_img(buf):
        a = np.frombuffer(buf, dtype=np.uint8)
        if a.size == n * 4:
            return a.reshape(height, width, 4)
        if a.size == n * 3:          # tolerated: packed BGR
            return a.reshape(height, width, 3)
        return a.reshape(height, width)

    L = as_img(left)
    if L.ndim == 2:
        L4 = np.stack([L, L, L, np.full_like(L, 255)], axis=-1)
    elif L.shape[-1] == 3:
        L4 = np.concatenate(
            [L, np.full(L.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    else:
        L4 = L
    pts = np.ascontiguousarray(
        _sv.generatePointCloud(L, as_img(right)),
        dtype=np.float64)
    if _last is not None and _last.shape == pts.shape:
        # reference-static semantics (stereo_vision.cpp:565 returns the
        # same `points` buffer every call): the pointer handed to the
        # consumer stays valid across calls, refreshed in place
        np.copyto(_last, pts)
    else:
        _last = pts
    # the colours are copied into an array this module owns: L4 may be a
    # read-only view of the caller's buffer, which the caller may free or
    # reuse
    if _last_colors is not None and _last_colors.shape == L4.shape:
        np.copyto(_last_colors, L4)
    else:
        _last_colors = np.array(L4, copy=True)
    return int(_last.ctypes.data)


def get_color():
    """Reference ``getColor()`` (stereo_vision.cpp:626-628): the BGRA
    colours of the last processed frame's left image, at the input
    resolution (height, width, 4), as the JAX package returns them.
    Returns the address (int), or 0 before the first generate()."""
    return 0 if _last_colors is None else int(_last_colors.ctypes.data)


def clean():
    """Reference ``clean()`` (stereo_vision.cpp:106-114): release the
    engine's worker threads/processes and drop the cached cloud buffer.
    A later generate() call re-initializes from its arguments."""
    global _sv, _last, _last_colors
    if _sv is not None:
        _sv.close()
    _sv = None
    _last = None
    _last_colors = None
