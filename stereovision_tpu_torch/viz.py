"""Offline visualization + export of pipeline outputs.

TPU-side replacement for the reference's OpenGL viewer thread
(src/common_includes/graphing.h — interactive freeglut point renderer on a
pthread): in a headless accelerator deployment the viewer becomes offline
artifacts — PLY/NPZ point-cloud dumps, disparity colorization, and the
LiDAR-style top view ported from stereo_vision/sv.py:87-134.

A copy of stereovision_tpu/viz.py (NumPy only), kept in the port so that it
never imports the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def normalize_depth(val, min_v, max_v):
    """Reference sv.py:87-92."""
    return (((max_v - val) / (max_v - min_v)) * 255).astype(np.uint8)


def points_to_top_view(points: np.ndarray,
                       x_range: Tuple[float, float] = (-20.0, 20.0),
                       y_range: Tuple[float, float] = (-20.0, 20.0),
                       z_range: Tuple[float, float] = (-3.0, 3.0),
                       scale: int = 10) -> np.ndarray:
    """Project a point cloud to a top-down depth image
    (reference points_2_top_view, sv.py:99-134)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dist = np.sqrt(x ** 2 + y ** 2)
    m = ((x > x_range[0]) & (x < x_range[1]) & (y > y_range[0])
         & (y < y_range[1]) & (z > z_range[0]) & (z < z_range[1]))
    x_lim, y_lim, dist_lim = x[m], y[m], dist[m]

    x_size = int(y_range[1] - y_range[0])
    y_size = int(x_range[1] - x_range[0])
    x_img = (-(y_lim * scale)).astype(np.int32) + int(np.trunc(
        y_range[1] * scale))
    y_img = (-(x_lim * scale)).astype(np.int32) + int(np.trunc(
        x_range[1] * scale))
    max_dist = np.sqrt(max(x_range) ** 2 + max(y_range) ** 2)
    dist_lim = normalize_depth(dist_lim, 0, max_dist)
    img = np.zeros([y_size * scale + 1, x_size * scale + 1], np.uint8)
    ok = ((x_img >= 0) & (x_img < img.shape[1])
          & (y_img >= 0) & (y_img < img.shape[0]))
    img[y_img[ok], x_img[ok]] = dist_lim[ok]
    return img


def colorize_disparity(dmap: np.ndarray) -> np.ndarray:
    """uint8 disparity -> BGR jet-like colormap (valid pixels only)."""
    try:
        import cv2
        color = cv2.applyColorMap(dmap, cv2.COLORMAP_JET)
        color[dmap == 0] = 0
        return color
    except ImportError:
        t = dmap.astype(np.float32) / 255.0
        r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
        out = (np.stack([b, g, r], -1) * 255).astype(np.uint8)
        out[dmap == 0] = 0
        return out


def save_ply(points: np.ndarray, path: str,
             colors: Optional[np.ndarray] = None,
             max_depth: Optional[float] = None) -> None:
    """ASCII PLY export of an (N, 3) cloud (+ optional (N, 3) uint8 RGB)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    mask = np.isfinite(pts).all(axis=1)
    if max_depth is not None:
        mask &= np.abs(pts[:, 2]) < max_depth
    pts = pts[mask]
    cols = colors.reshape(-1, 3)[mask] if colors is not None else None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if cols is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if cols is None:
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            for p, c in zip(pts, cols):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                        f"{c[0]} {c[1]} {c[2]}\n")


def save_npz(path: str, **arrays) -> None:
    np.savez_compressed(path, **arrays)
