"""Disparity -> 3-D point cloud through the Q matrix (counterpart of
stereovision_tpu/ops/reproject.py:18-41), and the linear resize of the
display disparity to the cloud's size (counterpart of jax.image.resize(x,
shape, "linear") in stereovision_tpu/engine.py:172-174).

Per pixel [X, Y, Z, W]^T = Q @ [u, v, d, 1]^T, divided by W (reference
stereo_vision.cpp:222-280).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .fma import fma32

Taps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def linear_taps(n_in: int, n_out: int, device) -> Taps:
    """Upsampling weights of one axis as jax.image.resize "linear" computes
    them (jax._src.image.scale.compute_weight_mat): inv_scale = 1/scale in
    float64 rounded once to float32, sample = fma(i + 0.5, inv_scale, -0.5)
    in float32 (XLA:CPU contracts it), triangle weights max(0, 1 - |sample
    - j|) normalised by their column sum, zero where the sample lies
    outside [-0.5, n_in - 0.5].  Upsampling leaves at most two taps an
    output: returns (i0, i1, w0, w1), the taps in ascending input order on
    `device` (w1 = 0 where there is one)."""
    if n_out < n_in:
        raise ValueError("linear_taps upsamples only (%d -> %d)"
                         % (n_in, n_out))
    inv = np.float32(1.0 / (n_out / n_in))
    i = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    sample = (i.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
    j = np.arange(n_in, dtype=np.float32)
    w = np.maximum(np.float32(0), np.float32(1)
                   - np.abs(sample[None, :] - j[:, None]))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w,
                 np.float32(0)).astype(np.float32)
    cols = np.arange(n_out)
    i0 = np.argmax(w != 0, axis=0)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w0 = w[i0, cols]
    w1 = np.where(i1 != i0, w[i1, cols], np.float32(0))
    assert ((w != 0).sum(axis=0) <= 2).all()
    return tuple(torch.as_tensor(a, device=device) for a in
                 (i0, i1, w0, w1.astype(np.float32)))


def resize_linear(x: torch.Tensor, rows: Taps = None,
                  cols: Taps = None) -> torch.Tensor:
    """(..., h, w) float32 -> (..., H, W) through linear_taps tables of
    each axis (None: the axis keeps its size, as jax.image.resize skips
    it).

    Columns are contracted first, then rows, each output as fma(w1, x1,
    w0*x0) in float32: the order and rounding of the two dot products that
    jitted jax.image.resize runs on XLA:CPU.  Exact for integer-valued
    inputs at these shapes; where XLA splits a long contraction into
    blocks, an output whose taps straddle the split differs in the last
    bit."""
    if cols is not None:
        i0, i1, w0, w1 = cols
        x = fma32(w1, x[..., i1], w0 * x[..., i0])
    if rows is not None:
        i0, i1, w0, w1 = rows
        x = fma32(w1[:, None], x[..., i1, :], w0[:, None] * x[..., i0, :])
    return x


def reproject(dmap: torch.Tensor, Q) -> torch.Tensor:
    """dmap: (..., H, W) disparity (any dtype); Q: (4, 4).  Returns points
    (..., H, W, 3) float32.

    Each row of Q is evaluated as fma(q2, d, fma(q0, u, q1*v)) + q3 in
    float32, the form the JAX reference's XLA:CPU path computes."""
    H, W = dmap.shape[-2:]
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
