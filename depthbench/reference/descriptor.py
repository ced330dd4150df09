"""16-channel rhombus feature descriptor (counterpart of
stereovision_tpu/ops/descriptor.py:30-86).

For every pixel, 16 bytes sampled on a rhombus from the Sobel gradient
images (reference descriptor.cpp:45-126): 12 taps of du and 4 of dv.
Layout (16, H, W) uint8, zero outside the valid region u in [3, W-3),
v in [3, H-3), as in the JAX package; a batch of images (B, H, W) gives
(B, 16, H, W), each frame its single-frame descriptor.
"""

from __future__ import annotations

import torch

from .filters import _pad_roll, sobel3x3

# (channel_source, dy, dx); source 0 = du, 1 = dv
DESCRIPTOR_TAPS = (
    (0, -2, 0),
    (0, -1, -2),
    (0, -1, 0),
    (0, -1, 2),
    (0, 0, -1),
    (0, 0, 0),
    (0, 0, 0),
    (0, 0, 1),
    (0, 1, -2),
    (0, 1, 0),
    (0, 1, 2),
    (0, 2, 0),
    (1, -1, 0),
    (1, 0, -1),
    (1, 0, 1),
    (1, 1, 0),
)


def compute_descriptor(img: torch.Tensor,
                       true_height: int = 0) -> torch.Tensor:
    """img: (..., H, W) uint8 -> descriptor (..., 16, H, W) uint8.

    true_height: when the image carries padding rows at the bottom (the
    row-sharded pipeline, parallel/shard.py), the valid region is taken at
    the true height, rows >= true_height - 3 are zero, and the real rows
    equal the unpadded descriptor's (descriptor.py:57-78)."""
    grads = sobel3x3(img)
    h, w = img.shape[-2:]
    th = true_height or h
    desc = torch.stack([_pad_roll(grads[src], dy, dx)
                        for src, dy, dx in DESCRIPTOR_TAPS], dim=-3)
    valid = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    valid[3:th - 3, 3:w - 3] = True
    return torch.where(valid, desc, torch.zeros((), dtype=torch.uint8,
                                                device=img.device))


def texture_sum(desc: torch.Tensor) -> torch.Tensor:
    """Per-pixel texture sum_k |desc_k - 128| (reference elas.cpp:296-299).
    desc: (..., 16, h, w) uint8 -> (..., h, w) int32."""
    return torch.sum(torch.abs(desc.to(torch.int32) - 128), dim=-3,
                     dtype=torch.int32)
