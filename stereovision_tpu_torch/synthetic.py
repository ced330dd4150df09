"""Seeded synthetic stereo scenes with a known disparity.

A textured left image, a ground-like slanted disparity field below the
horizon, a fronto-parallel background above it and two fronto-parallel
boxes at different disparities; the right image is the left one warped by
the disparity (nearer surfaces drawn last, so they occlude), with fresh
texture where nothing lands.  The disparities scale with the width
(ground up to W/20), so the same scene works at test and at KITTI sizes.
"""

from __future__ import annotations

import numpy as np


def disparity_field(width: int, height: int) -> np.ndarray:
    """(H, W) int32 true disparity of the left image."""
    horizon = int(height * 0.4)
    far, near = max(2, width // 200), max(6, width // 20)
    v = np.arange(height)[:, None]
    ground = far + (near - far) * (v - horizon) / max(height - 1 - horizon, 1)
    d = np.where(v > horizon, np.rint(ground), far) * np.ones((1, width))
    d = d.astype(np.int32)
    boxes = ((0.15, 0.30, 0.25, 0.70, max(4, width // 40)),
             (0.55, 0.75, 0.30, 0.80, max(5, width // 28)))
    for x0, x1, y0, y1, db in boxes:
        d[int(y0 * height):int(y1 * height),
          int(x0 * width):int(x1 * width)] = db
    return d


def stereo_pair(width: int, height: int, seed: int):
    """-> (left, right, disparity): (H, W, 3) uint8 BGR frames (three equal
    channels, so their gray value is the texture) and the (H, W) int32 true
    disparity of the left frame."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (height // 4 + 1, width // 4 + 1))
    coarse = np.kron(coarse, np.ones((4, 4)))[:height, :width]
    fine = rng.integers(0, 256, (height, width))
    left = (0.5 * coarse + 0.5 * fine).astype(np.uint8)
    disp = disparity_field(width, height)
    right = rng.integers(0, 256, (height, width)).astype(np.uint8)
    # forward-warp left -> right, far to near, so nearer surfaces win
    for d in np.unique(disp):
        vs, us = np.nonzero(disp == d)
        x = us - d
        ok = x >= 0
        right[vs[ok], x[ok]] = left[vs[ok], us[ok]]
    bgr = lambda g: np.repeat(g[..., None], 3, axis=-1)  # noqa: E731
    return bgr(left), bgr(right), disp
