"""The ELAS stereo pipeline in PyTorch (counterpart of
stereovision_tpu/models/elas.py:40-93,112-395).

Structure:
  stage A      descriptors + support scan (K2)          device
  host middle  sequential support filters, Delaunay,    host (NumPy/SciPy,
               rasterization, span coding               C++ helpers)
  stage B      plane fit, span expansion, grid masks,   device
               matching x2 (K1), L/R check (K4),
               speckle (K3), gap interpolation,
               adaptive mean, median

The engine runs on the card unless it is given device="cpu"; each kernel
wrapper picks the kernel or its plain version from the device its tensors
live on.  Under subsampling (params.subsampling) stage A is unchanged (full
resolution, candidate step forced even) and stage B runs on the
(H//2, W//2) output lattice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import geometry_to_torch
from ..device import resolve_device
from ..hostlib.raster import filter_support_sequential, rasterize
from ..ops import postprocess as post
from ..ops.cuda import ccl_cu, lr_cu, matching_cu, support_cu
from ..ops.descriptor import compute_descriptor
from ..ops.grid import build_grid_mask
from ..ops.planes import fit_plane_tables, host_geometry
from ..ops.spans import encode_tri_spans, expand_tri_spans
from ..params import ElasParams


class ElasEngine:
    """ELAS pipeline for one image size on one device."""

    def __init__(self, params: ElasParams, width: int, height: int,
                 device: Optional[str] = None):
        self.p = params
        self.device = resolve_device(device)
        self.width = int(width)
        self.height = int(height)
        step = params.step
        self.Hc = -(-self.height // step)
        self.Wc = -(-self.width // step)
        # static padding caps of the host geometry (as in the JAX engine)
        self.n_max = min(self.Hc * self.Wc + 6, 8192)
        self.t_max = 2 * self.n_max + 8
        self.Ho, self.Wo = params.out_shape(self.width, self.height)
        # runs per span-coded row are set by triangle-edge crossings, which
        # the half lattice keeps: the cap follows the full width
        self.s_max = max(64, min(self.width // 4, self.Wo))

    # ---- device stage A ---------------------------------------------------

    def stage_support(self, I1, I2):
        """(H, W) uint8 gray images (NumPy or tensors) -> (desc1, desc2,
        d_can) on the engine's device; d_can is the raw (Hc, Wc) int16
        support grid (the host applies the sequential filters)."""
        I1 = torch.as_tensor(I1, device=self.device)
        I2 = torch.as_tensor(I2, device=self.device)
        desc1 = compute_descriptor(I1)
        desc2 = compute_descriptor(I2)
        d_can = support_cu.support_matches(desc1, desc2, self.p,
                                           apply_filters=False)
        return desc1, desc2, d_can

    # ---- host middle ------------------------------------------------------

    def host_mid(self, d_can: np.ndarray) -> Dict[str, np.ndarray]:
        """Support grid -> padded geometry arrays (fixed shapes): pts
        (n_max, 3) int16, tris_l/r (t_max, 3) int16 and the triangle-id
        maps on the output lattice as span codes tri_l/r (Ho, s_max, 3)
        uint8."""
        d_can = filter_support_sequential(np.asarray(d_can), self.p)
        g = host_geometry(d_can, self.p, self.width, self.height,
                          rasterize=rasterize, n_cap=self.n_max)
        pts = np.full((self.n_max, 3), -1, np.int16)
        n = min(len(g["pts"]), self.n_max)
        pts[:n] = g["pts"][:n]
        out = {"pts": pts}
        for tag in ("l", "r"):
            tr = np.full((self.t_max, 3), -1, np.int16)
            t = min(len(g["tris_" + tag]), self.t_max)
            tr[:t] = g["tris_" + tag][:t]
            out["tris_" + tag] = tr
            tri = np.where(g["tri_id_" + tag] >= self.t_max, -1,
                           g["tri_id_" + tag])
            if self.p.subsampling:
                tri = tri[::2, ::2][:self.Ho, :self.Wo]
            out["tri_" + tag] = encode_tri_spans(tri, self.s_max)
        return out

    def geometry_to_device(self, g: Dict[str, np.ndarray]):
        """host_mid products -> (pts, tris_l, tris_r, tri_l, tri_r) tensors
        on the engine's device."""
        return tuple(geometry_to_torch(g, self.device).values())

    # ---- device stage B ---------------------------------------------------

    def dense_inputs(self, pts, tris_l, tris_r, tri_l, tri_r):
        """Geometry -> the matching passes' inputs: (tid, planes, grid
        mask) for the left and for the right image."""
        planes_l, _ = fit_plane_tables(pts, tris_l)
        _, planes_r = fit_plane_tables(pts, tris_r)
        tid_l = expand_tri_spans(tri_l, self.Wo)
        tid_r = expand_tri_spans(tri_r, self.Wo)
        grid_l = build_grid_mask(pts, self.p, self.width, self.height,
                                 right_image=False)
        grid_r = build_grid_mask(pts, self.p, self.width, self.height,
                                 right_image=True)
        return (tid_l, planes_l, grid_l), (tid_r, planes_r, grid_r)

    def stage_dense(self, desc1, desc2, pts, tris_l, tris_r, tri_l,
                    tri_r) -> Tuple[torch.Tensor, torch.Tensor]:
        """Descriptors + geometry tensors -> (D1, D2) float32 (Ho, Wo)
        maps of full-resolution disparities (-10 / -1 = invalid)."""
        p = self.p
        left, right = self.dense_inputs(pts, tris_l, tris_r, tri_l, tri_r)
        D1 = matching_cu.compute_disparity(desc1, desc2, *left, p,
                                           right_image=False)
        D2 = matching_cu.compute_disparity(desc2, desc1, *right, p,
                                           right_image=True)
        D1, D2 = lr_cu.lr_consistency_check(D1, D2, p)
        D1 = ccl_cu.remove_small_segments(D1, p)
        if not p.postprocess_only_left:
            D2 = ccl_cu.remove_small_segments(D2, p)
        D1 = post.gap_interpolation(D1, p)
        if not p.postprocess_only_left:
            D2 = post.gap_interpolation(D2, p)
        if p.filter_adaptive_mean:
            D1 = post.adaptive_mean(D1, p)
            if not p.postprocess_only_left:
                D2 = post.adaptive_mean(D2, p)
        if p.filter_median:
            D1 = post.median_filter(D1, p)
            if not p.postprocess_only_left:
                D2 = post.median_filter(D2, p)
        return D1, D2

    # ---- public entry point -----------------------------------------------

    def process(self, I1, I2) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocking single-frame processing.  I1, I2: (H, W) uint8
        grayscale.  Returns (D1, D2) float32 (Ho, Wo) tensors on the
        engine's device."""
        desc1, desc2, d_can = self.stage_support(I1, I2)
        g = self.host_mid(d_can.cpu().numpy())
        return self.stage_dense(desc1, desc2, *self.geometry_to_device(g))
