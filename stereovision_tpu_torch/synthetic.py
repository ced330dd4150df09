"""Seeded synthetic stereo scenes with a known disparity, the degenerate
frames of the robustness checks, and seeded synthetic darknet weights (the
repository holds no YOLO weights file).

A textured left image, a ground-like slanted disparity field below the
horizon, a fronto-parallel background above it and two fronto-parallel
boxes at different disparities; the right image is the left one warped by
the disparity (nearer surfaces drawn last, so they occlude), with fresh
texture where nothing lands.  The disparities scale with the width
(ground up to W/20), so the same scene works at test and at KITTI sizes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .params import ElasParams, app_params, robotics_params


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


def degenerate_frames() -> Dict[str, Tuple[ElasParams, np.ndarray,
                                           np.ndarray]]:
    """The degenerate frames of the JAX package's tests/test_robustness.py,
    at its sizes and seeds: name -> (parameters, left, right), (H, W)
    uint8 gray images.

      flat_*     a flat 96x64 pair (all 100): no support point; under the
                 robotics preset no triangle, under app_params() only its
                 6 corner points (planes at disparity 0);
      unrelated  a 96x64 pair of unrelated noise (default_rng(0));
      tiny_*     a 32x24 frame (default_rng(1)) and itself moved 3 columns
                 left, narrower than one block of K1 (128 columns) or of
                 K2 (256); under app_params() D = 256 is above the width.
    """
    flat = np.full((64, 96), 100, np.uint8)
    rng = np.random.default_rng(0)
    left = rng.integers(0, 255, (64, 96), dtype=np.uint8)
    right = rng.integers(0, 255, (64, 96), dtype=np.uint8)
    tiny = np.random.default_rng(1).integers(0, 255, (24, 32),
                                             dtype=np.uint8)
    both = robotics_params(disp_max=31, postprocess_only_left=False)
    return {
        "flat_robotics": (both, flat, flat),
        "flat_app": (app_params(), flat, flat),
        "flat_app_subsampled": (app_params(subsampling=True), flat, flat),
        "unrelated": (both, left, right),
        "tiny_robotics": (robotics_params(disp_max=15), tiny,
                          np.roll(tiny, -3, axis=1)),
        "tiny_app": (app_params(), tiny, np.roll(tiny, -3, axis=1)),
    }


# the default shift of the objectness bias of every yolo head of
# darknet_weights: as with trained weights, few rows of a frame then score
# above the 0.5 threshold (on the scenes of stereo_pair with seed 0 and the
# built-in yolov4-tiny cfg at 608x608, 32 candidate rows and 5 detections a
# KITTI-size frame; with no shift ~17,000 and ~3,700)
OBJECTNESS_SHIFT = -1.25


def darknet_weights(path: str, sections, seed: int,
                    objectness_shift: float = OBJECTNESS_SHIFT) -> None:
    """Write a darknet .weights file (version 0.2.5 header, then per conv
    layer [bn_b, bn_g, bn_mean, bn_var] or [bias], then OIHW weights) for
    the cfg sections, drawn from default_rng(seed): batch-norm shifts and
    means ~ N(0, 0.5), scales ~ N(1, 0.3), variances |N(1, 0.3)| + 0.25,
    weights ~ N(0, 1/sqrt(fan_in)), biases ~ N(0, 0.5), the heads'
    objectness biases moved by objectness_shift."""
    rng = np.random.default_rng(seed)
    chunks = [np.array([0, 2, 5], np.int32).tobytes(),
              np.array([0], np.int64).tobytes()]
    layers = sections[1:]
    c_in = int(sections[0].get("channels", 3))
    chans = []
    for i, l in enumerate(layers):
        t = l["type"]
        if t == "convolutional":
            k, f = int(l["size"]), int(l["filters"])
            if l.get("batch_normalize") == "1":
                chunks += [rng.normal(0, 0.5, f).astype(np.float32),
                           rng.normal(1, 0.3, f).astype(np.float32),
                           rng.normal(0, 0.5, f).astype(np.float32),
                           (np.abs(rng.normal(1, 0.3, f)) + 0.25)
                           .astype(np.float32)]
            else:
                bias = rng.normal(0, 0.5, f).astype(np.float32)
                head = layers[i + 1] if i + 1 < len(layers) else {}
                if head.get("type") == "yolo":
                    per = 5 + int(head.get("classes", 80))
                    bias[4::per] += np.float32(objectness_shift)
                chunks.append(bias)
            chunks.append(rng.normal(0, 1.0 / np.sqrt(k * k * c_in),
                                     (f, c_in, k, k)).astype(np.float32))
            c = f
        elif t == "route":
            refs = [int(x) for x in l["layers"].split(",")]
            refs = [r if r >= 0 else i + r for r in refs]
            c = sum(chans[r] for r in refs)
            if "groups" in l:
                c //= int(l["groups"])
        else:
            c = chans[i - 1] if i else c_in
        chans.append(c)
        c_in = c
    with open(path, "wb") as fh:
        fh.write(b"".join(np.asarray(c).tobytes() for c in chunks))
