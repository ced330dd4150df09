"""Stereo calibration: OpenCV-YAML reading and rectification geometry.

The reference reads K1,K2,D1,D2,R,T,XR,XT from an OpenCV FileStorage YAML
(src/serial_includes/main/stereo_vision.cpp:530-537, schema as in
data/calibration/kitti_2011_09_26.yml) and calls cv::stereoRectify +
cv::initUndistortRectifyMap once at startup (findRectificationMap,
stereo_vision.cpp:360-482); the per-frame remap is disabled in the
reference (stereo_vision.cpp:341), so only the Q matrix is consumed per
frame.  We therefore compute all rectification products on the host at
setup time — cv2 when available, otherwise a pure-NumPy implementation of
Bouguet's algorithm (the CALIB_ZERO_DISPARITY path of stereoRectify).

A copy of stereovision_tpu/io/calibration.py (NumPy only), kept in the port
so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# OpenCV-YAML parsing (FileStorage format; no cv2 needed to read it)

def _parse_opencv_yaml(text: str) -> Dict[str, np.ndarray]:
    """Minimal parser for the subset of OpenCV FileStorage YAML used by the
    calibration files: named !!opencv-matrix nodes and flat sequences."""
    out: Dict[str, np.ndarray] = {}
    # Matrices:  name: !!opencv-matrix \n rows..cols..dt..data: [ ... ]
    mat_re = re.compile(
        r"^(\w+):\s*!!opencv-matrix\s*\n"
        r"\s*rows:\s*(\d+)\s*\n"
        r"\s*cols:\s*(\d+)\s*\n"
        r"\s*dt:\s*\w+\s*\n"
        r"\s*data:\s*\[([^\]]*)\]",
        re.MULTILINE)
    for m in mat_re.finditer(text):
        name, rows, cols, data = m.group(1), int(m.group(2)), int(m.group(3)), m.group(4)
        vals = np.array([float(x) for x in data.replace("\n", " ").split(",")
                         if x.strip()], dtype=np.float64)
        out[name] = vals.reshape(rows, cols)
    # Flat sequences:  name: [ a, b, c ] — reshaped by size (9 -> 3x3,
    # 5 -> 1x5 distortion row, 3 -> vector).
    seq_re = re.compile(r"^(\w+):\s*\[([^\]]*)\]", re.MULTILINE)
    for m in seq_re.finditer(text):
        name = m.group(1)
        if name in out:
            continue
        vals = np.array([float(x) for x in m.group(2).replace("\n", " ").split(",")
                         if x.strip()], dtype=np.float64)
        if vals.size == 9:
            vals = vals.reshape(3, 3)
        elif vals.size == 5:
            vals = vals.reshape(1, 5)
        out[name] = vals
    return out


def load_calibration(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        return _parse_opencv_yaml(f.read())


# ---------------------------------------------------------------------------
# Rectification

@dataclasses.dataclass
class Rectification:
    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray
    lmap: Optional[np.ndarray] = None  # (H, W, 2) float32 sample coords
    rmap: Optional[np.ndarray] = None
    XR: Optional[np.ndarray] = None    # robot-frame rotation (calib YAML)
    XT: Optional[np.ndarray] = None    # robot-frame translation


def scale_intrinsics(K: np.ndarray, scale_factor: float) -> np.ndarray:
    """Divide the first two rows of K by scale_factor
    (reference findRectificationMap, stereo_vision.cpp:364-376)."""
    K = K.copy()
    K[0, :] /= scale_factor
    K[1, :] /= scale_factor
    return K


def stereo_rectify(K1, D1, K2, D2, image_size, R, T,
                   new_size=None, compute_maps: bool = False) -> Rectification:
    """cv::stereoRectify(CALIB_ZERO_DISPARITY, alpha=0) equivalent.

    image_size/new_size: (width, height).  Uses cv2 when importable (exact
    OpenCV numerics); otherwise a NumPy Bouguet implementation.
    """
    new_size = new_size or image_size
    try:
        import cv2
        R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
            K1, D1.reshape(1, -1), K2, D2.reshape(1, -1),
            tuple(image_size), R, np.asarray(T).reshape(3, 1),
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=0,
            newImageSize=tuple(new_size))
        rect = Rectification(R1, R2, P1, P2, Q)
        if compute_maps:
            lx, ly = cv2.initUndistortRectifyMap(
                K1, D1.reshape(1, -1), R1, P1, tuple(new_size), cv2.CV_32FC1)
            rx, ry = cv2.initUndistortRectifyMap(
                K2, D2.reshape(1, -1), R2, P2, tuple(new_size), cv2.CV_32FC1)
            rect.lmap = np.stack([lx, ly], axis=-1)
            rect.rmap = np.stack([rx, ry], axis=-1)
        return rect
    except ImportError:
        return _stereo_rectify_np(K1, D1, K2, D2, image_size, R, T,
                                  new_size, compute_maps)


def _stereo_rectify_np(K1, D1, K2, D2, image_size, R, T, new_size,
                       compute_maps) -> Rectification:
    """Pure-NumPy Bouguet rectification (CALIB_ZERO_DISPARITY, default
    scaling): split the inter-camera rotation, rotate both views so epipolar
    lines are horizontal, build P1/P2 with a common focal/principal point
    and Q for reprojectImageTo3D."""
    T = np.asarray(T, np.float64).reshape(3)
    # Split rotation: each camera rotated by half of R.
    w, _ = _rodrigues_inv(np.asarray(R, np.float64))
    r_half = _rodrigues(-w / 2.0)
    t = r_half @ T
    # Rotation taking baseline onto the x axis.
    e1 = t / np.linalg.norm(t)
    if t[0] < 0:
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    n = np.linalg.norm(e2)
    e2 = e2 / n if n > 1e-12 else np.array([0.0, 1.0, 0.0])
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3], axis=0)
    if t[0] < 0:
        Rw = np.diag([-1.0, -1.0, 1.0]) @ Rw
    R1 = Rw @ r_half.T
    R2 = Rw @ r_half
    tx = (R2 @ T)[0]

    f = (K1[1, 1] + K2[1, 1]) / 2.0
    nw, nh = new_size
    cx = (nw - 1) / 2.0
    cy = (nh - 1) / 2.0
    P1 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]], np.float64)
    P2 = np.array([[f, 0, cx, f * tx], [0, f, cy, 0], [0, 0, 1, 0]],
                  np.float64)
    Q = np.array([[1, 0, 0, -cx],
                  [0, 1, 0, -cy],
                  [0, 0, 0, f],
                  [0, 0, -1.0 / tx, 0]], np.float64)
    rect = Rectification(R1, R2, P1, P2, Q)
    if compute_maps:
        rect.lmap = _undistort_rectify_map(K1, D1, R1, P1, new_size)
        rect.rmap = _undistort_rectify_map(K2, D2, R2, P2, new_size)
    return rect


def _rodrigues(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _rodrigues_inv(R: np.ndarray):
    cos_t = np.clip((np.trace(R) - 1) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3), R
    w = (theta / (2 * np.sin(theta))) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w, R


def _undistort_rectify_map(K, D, Rr, P, size):
    """initUndistortRectifyMap equivalent: for each rectified pixel, the
    (x, y) source-image sample location."""
    w, h = size
    D = np.asarray(D, np.float64).reshape(-1)
    k = np.zeros(8)
    k[:len(D)] = D
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(Rr).T
    xp = pts[..., 0] / pts[..., 2]
    yp = pts[..., 1] / pts[..., 2]
    r2 = xp * xp + yp * yp
    radial = (1 + k[0] * r2 + k[1] * r2**2 + k[4] * r2**3) / \
             (1 + k[5] * r2 + k[6] * r2**2 + k[7] * r2**3)
    xd = xp * radial + 2 * k[2] * xp * yp + k[3] * (r2 + 2 * xp * xp)
    yd = yp * radial + k[2] * (r2 + 2 * yp * yp) + 2 * k[3] * xp * yp
    mx = K[0, 0] * xd + K[0, 2]
    my = K[1, 1] * yd + K[1, 2]
    return np.stack([mx, my], axis=-1).astype(np.float32)


def rectification_from_yaml(path: str, out_width: int, out_height: int,
                            scale_factor: float = 1.0,
                            compute_maps: bool = False) -> Rectification:
    """The reference's full setup path (externalInit + findRectificationMap):
    read the YAML, scale K by scale_factor, rectify at the output size."""
    c = load_calibration(path)
    K1 = scale_intrinsics(c["K1"], scale_factor)
    K2 = scale_intrinsics(c["K2"], scale_factor)
    size = (out_width, out_height)
    rect = stereo_rectify(K1, c["D1"], K2, c["D2"], size, c["R"], c["T"],
                          new_size=size, compute_maps=compute_maps)
    rect.XR = c.get("XR", np.eye(3))
    rect.XT = c.get("XT", np.zeros((3, 1)))
    return rect
