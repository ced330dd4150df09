"""The reference's scale grid and the sweep's batch rule (counterpart of
stereovision_tpu/bench/sweep.py:29-44, :59-60 and :75-96), kept in the port
so that it never imports the JAX package.

The reference's benchmark log runs the KITTI frame at the scales 0.5, 0.6,
..., 3.0, each at full resolution and subsampled: 52 configurations.  At
scale s the frame is int(1242 / s) x int(375 / s) and the calibration's
intrinsics are divided by s (StereoEngine(scale=s), the CLI's -f, the C
ABI's scale), from 2484x750 down to 414x125.
"""

from __future__ import annotations

from typing import Tuple

from .params import app_params

KITTI_SIZE = (1242, 375)
SCALES = tuple(i / 10 for i in range(5, 31))


def frame_size(scale: float) -> Tuple[int, int]:
    """(width, height) of the KITTI frame at this scale, as the CLI's -f
    and the sweep compute it."""
    return int(KITTI_SIZE[0] / scale), int(KITTI_SIZE[1] / scale)


def sweep_batch(width: int, height: int, subsampling: bool) -> int:
    """The sweep's batch for a frame size: 8 (4 subsampled) at KITTI size,
    grown with the frame's area below it (at most 4x) and, above it, shrunk
    with the output lattice's area."""
    b0 = 4 if subsampling else 8
    ref_px = KITTI_SIZE[0] * KITTI_SIZE[1]
    b = max(1, min(4 * b0, b0 * ref_px // (width * height)))
    if width * height > ref_px:
        Ho, Wo = app_params(subsampling=subsampling).out_shape(width, height)
        b = max(1, min(b0, round(b0 * ref_px / (Ho * Wo))))
    return b
