"""Disparity candidate grid as a dense boolean mask (counterpart of
stereovision_tpu/ops/grid.py:24-64).

Per grid_size x grid_size image cell, each support point votes for d-1..d+1
in its cell (reference createGrid, elas.cpp:577-653), followed by a clean
3x3 cell dilation.
"""

from __future__ import annotations

import torch

from .params import ElasParams


def build_grid_mask(pts: torch.Tensor, p: ElasParams, width: int,
                    height: int, right_image: bool) -> torch.Tensor:
    """pts: (N, 3) int [u, v, d] support points, padded entries have d < 0.
    Returns (D, gh, gw) bool candidate mask (D = disp_max + 1); a batch
    (B, N, 3) gives (B, D, gh, gw), each frame from its own points.

    The cell indices follow the JAX reference's scatter exactly: a negative
    index counts once from the end of its axis (as jnp indexing does; so a
    padded point, whose column is forced to -1, votes for the last column)
    and what is still out of range is dropped (mode="drop"): written to a
    spare cell past the mask's end, so that no step depends on how many
    points vote (a CUDA graph captures it)."""
    gw, gh = p.grid_dims(width, height)
    D = p.disp_num
    lead = pts.shape[:-2]
    pts = pts.reshape(-1, *pts.shape[-2:])
    u = pts[..., 0].to(torch.int64)
    v = pts[..., 1].to(torch.int64)
    d = pts[..., 2].to(torch.int64)
    b = torch.arange(pts.shape[0], device=pts.device)[:, None].expand_as(u)
    gs = p.grid_size
    x = torch.div(u - d if right_image else u, gs, rounding_mode="floor")
    y = torch.div(v, gs, rounding_mode="floor")
    x = torch.where(d >= 0, x, -1)
    x = torch.where(x < 0, x + gw, x)
    y = torch.where(y < 0, y + gh, y)
    inb = (x >= 0) & (x < gw) & (y >= 0) & (y < gh)
    cells = pts.shape[0] * D * gh * gw
    flat = torch.zeros(cells + 1, dtype=torch.bool, device=pts.device)
    vote = torch.ones((), dtype=torch.bool, device=pts.device)
    for dd in (-1, 0, 1):
        di = torch.clamp(d + dd, 0, p.disp_max)
        at = torch.where(inb, ((b * D + di) * gh + y) * gw + x, cells)
        flat.index_put_((at.reshape(-1),), vote)
    mask = flat[:cells].reshape(pts.shape[0], D, gh, gw)
    return _dilate3x3(mask).reshape(*lead, D, gh, gw)


def _dilate3x3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 OR-dilation over the last two (cell) axes."""
    mh = mask.clone()
    mh[..., 1:] |= mask[..., :-1]
    mh[..., :-1] |= mask[..., 1:]
    mv = mh.clone()
    mv[..., 1:, :] |= mh[..., :-1, :]
    mv[..., :-1, :] |= mh[..., 1:, :]
    return mv
