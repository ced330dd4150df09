"""Disparity -> 3-D point cloud through the Q matrix (counterpart of
stereovision_tpu/ops/reproject.py:18-41).

Per pixel [X, Y, Z, W]^T = Q @ [u, v, d, 1]^T, divided by W (reference
stereo_vision.cpp:222-280).
"""

from __future__ import annotations

import torch

from .fma import fma32


def reproject(dmap: torch.Tensor, Q) -> torch.Tensor:
    """dmap: (H, W) disparity (any dtype); Q: (4, 4).  Returns points
    (H, W, 3) float32.

    Each row of Q is evaluated as fma(q2, d, fma(q0, u, q1*v)) + q3 in
    float32, the form the JAX reference's XLA:CPU path computes."""
    H, W = dmap.shape
    dev = dmap.device
    Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    d = dmap.to(torch.float32)

    def row(i):
        return fma32(Q[i, 2], d, fma32(Q[i, 0], u, Q[i, 1] * v)) + Q[i, 3]

    inv_w = 1.0 / row(3)
    return torch.stack([row(0) * inv_w, row(1) * inv_w, row(2) * inv_w],
                       dim=-1)


def apply_robot_transform(points: torch.Tensor, XR, XT) -> torch.Tensor:
    """p' = XR @ p + XT (reference stereo_vision.cu:208-211)."""
    XR = torch.as_tensor(XR, dtype=torch.float32, device=points.device)
    XT = torch.as_tensor(XT, dtype=torch.float32,
                         device=points.device).reshape(3)
    return points @ XR.T + XT
