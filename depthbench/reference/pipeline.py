"""One frame through the plain pipeline: BGR pair -> display disparity
and point cloud, as StereoEngine.process_frame gives them with
pc_extrapolation=1 and no sky removal or robot transform.

  stage A      descriptors, support scan (plain K2), support grid
  host middle  sequential filters, Delaunay, rasterization, span coding
  stage B      plane tables, plane maps, grid masks, matching x2 (plain
               K1), L/R check (plain K4), speckle (plain K3), gap
               interpolation, adaptive mean, median
  reproject    dmap = clamp(round(4 D1)), resized to the cloud's size,
               through Q

Every step runs on the device the caller names; the host middle runs in
NumPy and SciPy.  lowp=True is the benchmark's control: the plane tables
and the reprojection in bfloat16 where the configuration states float32.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .calibration import rectification_from_yaml
from .descriptor import compute_descriptor
from .geometry import host_mid
from .grid import build_grid_mask
from .matching import compute_disparity, plane_maps
from .params import ElasParams, app_params
from .planes import fit_plane_tables
from .postprocess import (adaptive_mean, gap_interpolation,
                          lr_consistency_check, median_filter,
                          remove_small_segments)
from .reproject import linear_taps, reproject, resize_linear
from .spans import expand_tri_spans
from .support import support_matches


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """BGR(A) -> gray uint8, OpenCV's fixed-point BT.601 rounding."""
    if img.ndim == 2:
        return img
    b, g, r = (img[..., i].astype(np.uint32) for i in range(3))
    return ((4899 * r + 9617 * g + 1868 * b + (1 << 13)) >> 14).astype(
        np.uint8)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class Reference:
    """The plain pipeline for one frame size and parameter set."""

    def __init__(self, calibration_yaml: str, width: int, height: int,
                 subsampling: bool, device: str = "cpu",
                 lowp: bool = False):
        self.p: ElasParams = app_params(subsampling=subsampling)
        self.width, self.height = int(width), int(height)
        self.device = torch.device(device)
        self.lowp = lowp
        step = self.p.step
        hc, wc = -(-self.height // step), -(-self.width // step)
        # the port's padding caps of the host geometry
        self.n_max = min(hc * wc + 6, 8192)
        self.t_max = 2 * self.n_max + 8
        self.Ho, self.Wo = self.p.out_shape(self.width, self.height)
        self.s_max = max(64, min(self.width // 4, self.Wo))
        rect = rectification_from_yaml(calibration_yaml, self.width,
                                       self.height)
        self.Q = torch.as_tensor(np.asarray(rect.Q, np.float32),
                                 device=self.device)

    def frame(self, left: np.ndarray, right: np.ndarray,
              keep: bool = False) -> Dict:
        """-> {"dmap": (Ho, Wo) uint8, "points": (H*W, 3) float32} as NumPy,
        and "load": the host middle's support points (with the count found
        where more than the cap n_max were thinned, else 0) and triangles of
        each side; keep=True adds the
        matching passes' inputs ("passes": per pass (d_lo, d_hi, grid mask,
        right_image))."""
        p, dev = self.p, self.device
        I1 = torch.as_tensor(bgr_to_gray(left), device=dev)
        I2 = torch.as_tensor(bgr_to_gray(right), device=dev)
        desc1 = compute_descriptor(I1, 0)
        desc2 = compute_descriptor(I2, 0)
        d_can = support_matches(desc1, desc2, p, apply_filters=False)
        notes: List[str] = []
        g = host_mid(d_can.cpu().numpy(), p, self.width, self.height,
                     self.n_max, self.t_max, self.s_max, True, notes=notes)
        # "support points thinned: <found> -> <kept> (n_max=...)"
        thinned = [int(n.split()[3]) for n in notes
                   if n.startswith("support points thinned")]
        load = {"support": int((g["pts"][:, 2] >= 0).sum()),
                "thinned_from": thinned[0] if thinned else 0,
                "tris_l": int((g["tris_l"][:, 0] >= 0).sum()),
                "tris_r": int((g["tris_r"][:, 0] >= 0).sum())}
        pts = torch.as_tensor(g["pts"], device=dev)
        passes = []
        D = []
        for right, tag in ((False, "l"), (True, "r")):
            planes = fit_plane_tables(
                pts, torch.as_tensor(g["tris_" + tag], device=dev))[int(right)]
            if self.lowp:
                planes = _bf16(planes)
            tid = expand_tri_spans(torch.as_tensor(g["tri_" + tag],
                                                   device=dev), self.Wo)
            gm = build_grid_mask(pts, p, self.width, self.height,
                                 right_image=right)
            me, other = (desc2, desc1) if right else (desc1, desc2)
            D.append(compute_disparity(me, other, tid, planes, gm, p,
                                       right_image=right))
            if keep:
                lo, hi, _, _ = plane_maps(tid, planes, p)
                passes.append((lo, hi, gm, right))
        D1, D2 = lr_consistency_check(D[0], D[1], p)
        D1 = remove_small_segments(D1, p)
        if not p.postprocess_only_left:
            raise NotImplementedError("only the left map is post-processed")
        D1 = gap_interpolation(D1, p)
        if p.filter_adaptive_mean:
            D1 = adaptive_mean(D1, p)
        if p.filter_median:
            D1 = median_filter(D1, p)
        dmap = torch.clamp(torch.round(D1 * 4.0), 0, 255).to(torch.uint8)
        taps = [linear_taps(n, m, dev) if n != m else None
                for n, m in zip(dmap.shape, (self.height, self.width))]
        d_for_q = resize_linear(dmap.to(torch.float32), *taps)
        Q = self.Q
        if self.lowp:
            d_for_q, Q = _bf16(d_for_q), _bf16(Q)
        points = reproject(d_for_q, Q)
        if self.lowp:
            points = _bf16(points)
        out = {"dmap": dmap.cpu().numpy(),
               "points": points.reshape(-1, 3).cpu().numpy(), "load": load}
        if keep:
            out["passes"] = passes
        return out
