"""StereoEngine: calibrated frames -> disparity + point cloud, with the
reference application's output conventions (counterpart of
stereovision_tpu/engine.py:36-225).

  generateDisparityMap  stereo_vision.cpp:296-318 (disparity stored as
                        uint8 = 4x true disparity)
  publishPointCloud     stereo_vision.cpp:222-280 (Q reprojection of the
                        *uint8* disparity)
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .io.calibration import Rectification, rectification_from_yaml
from .models.elas import ElasEngine
from .ops.reproject import (apply_robot_transform, linear_taps, reproject,
                            resize_linear)
from .params import ElasParams, app_params


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """BGR(A) -> grayscale uint8 with OpenCV's fixed-point BT.601 rounding
    (matches cvtColor(BGRA2GRAY), reference stereo_vision.cpp:338-339)."""
    if img.ndim == 2:
        return img
    b = img[..., 0].astype(np.uint32)
    g = img[..., 1].astype(np.uint32)
    r = img[..., 2].astype(np.uint32)
    y = (4899 * r + 9617 * g + 1868 * b + (1 << 13)) >> 14
    return y.astype(np.uint8)


class StereoEngine:
    """Stereo frames -> disparity map + 3-D point cloud, on the card unless
    device="cpu"."""

    def __init__(self,
                 calibration_yaml: str,
                 width: int,
                 height: int,
                 scale: float = 1.0,
                 pc_extrapolation: int = 1,
                 params: Optional[ElasParams] = None,
                 subsampling: bool = False,
                 true_scale_cloud: bool = False,
                 remove_sky: bool = False,
                 robot_frame: bool = False,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.p = params or app_params(subsampling=subsampling)
        self.remove_sky = remove_sky
        self.width = int(width)
        self.height = int(height)
        self.pc_w = self.width * pc_extrapolation
        self.pc_h = self.height * pc_extrapolation
        self.rect: Rectification = rectification_from_yaml(
            calibration_yaml, self.width, self.height, scale_factor=scale)
        self.elas = ElasEngine(self.p, self.width, self.height,
                               device=self.device)
        # The reference feeds the uint8 display disparity (4x true) into Q
        # (stereo_vision.cpp:316 + :234-242); true_scale_cloud=True divides
        # by 4 for metric clouds.  robot_frame=True applies the
        # calibration's XR/XT rigid transform (stereo_vision.cu:208-211).
        self.disp_display_scale = 4.0
        self.true_scale_cloud = true_scale_cloud
        self.robot_frame = robot_frame
        self.timings: Dict[str, float] = {}
        self._pc_taps: Dict[tuple, tuple] = {}

    def pc_taps(self, shape) -> tuple:
        """The resize's tap tables (rows, cols) from a dmap of this shape
        to the cloud's (pc_h, pc_w), None for an axis that keeps its size;
        made once a shape, on the engine's device."""
        if shape not in self._pc_taps:
            self._pc_taps[shape] = tuple(
                linear_taps(n, m, self.device) if n != m else None
                for n, m in zip(shape, (self.pc_h, self.pc_w)))
        return self._pc_taps[shape]

    def reproject(self, D1: torch.Tensor):
        """D1 -> (dmap (Ho, Wo) uint8 display disparity, points
        (pc_h, pc_w, 3) float32), both on D1's device."""
        dmap = torch.clamp(torch.round(D1 * self.disp_display_scale),
                           0, 255).to(torch.uint8)
        if self.remove_sky:
            # zero disparity above ~55% height (reference remove_sky,
            # stereo_vision.cpp:484-490: mask rows [0, H/2*1.1))
            dmap[:int(dmap.shape[0] // 2 * 1.1)] = 0
        d_for_q = resize_linear(dmap.to(torch.float32),
                                *self.pc_taps(tuple(dmap.shape)))
        if self.true_scale_cloud:
            d_for_q = d_for_q / self.disp_display_scale
        points = reproject(d_for_q, self.rect.Q)
        if self.robot_frame:
            points = apply_robot_transform(points, self.rect.XR, self.rect.XT)
        return dmap, points

    def process_frame(self, left: np.ndarray, right: np.ndarray,
                      fetch: str = "host") -> Dict:
        """left/right: (H, W[, C]) uint8 BGR(A)/gray frames at engine size.
        Returns dict with dmap (uint8 display disparity), disparity (D1
        tensor), points ((pc_h*pc_w, 3)) and stage timings.

        fetch: "host" copies dmap and points to NumPy; "dmap" copies only
        the display disparity and leaves the cloud on the device; "device"
        leaves everything on the device."""
        if fetch not in ("host", "dmap", "device"):
            raise ValueError("fetch must be 'host', 'dmap' or 'device'")
        t0 = time.perf_counter()
        desc1, desc2, d_can = self.elas.stage_support(bgr_to_gray(left),
                                                      bgr_to_gray(right))
        g = self.elas.host_mid(d_can.cpu().numpy())
        D1, _ = self.elas.stage_dense(desc1, desc2,
                                      *self.elas.geometry_to_device(g))
        dmap, points = self.reproject(D1)
        points = points.reshape(-1, 3)
        if fetch in ("host", "dmap"):
            dmap = dmap.cpu().numpy()
        tq = time.perf_counter()
        if fetch == "host":
            points = points.cpu().numpy()
        t1 = time.perf_counter()
        self.timings = {"t_t": t1 - t0, "dmap_t": tq - t0, "pc_t": t1 - tq}
        return {"dmap": dmap, "disparity": D1, "points": points,
                "timings": dict(self.timings)}
