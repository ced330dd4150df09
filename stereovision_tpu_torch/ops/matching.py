"""Dense MAP disparity matching (counterpart of
stereovision_tpu/ops/matching.py:33 and the wrapper prep of
stereovision_tpu/ops/pallas/matching_pl.py:313).

Reference semantics (src/serial_includes/elas/elas.cpp:688-944): for each
pixel inside a triangle the candidates are the grid cell's disparities
outside the plane window, scored with the raw 16-byte SAD, and the plane
window [d_plane - r, d_plane + r], scored with SAD + prior P[|d - d_plane|]
when the plane is not too slanted; the warped column must land in
[2, W-3].  Ties go to the earliest candidate in the reference's evaluation
order, which the lexicographic key

    key = ((cost + off) * 2 + in_window) * 512 + d

encodes; the key is a total order (d in its low 9 bits), so its minimum
does not depend on the order in which candidates are visited.

match_keys below is the plain PyTorch version of the CUDA kernel in
ops/cuda/matching_cu.py (csrc/matching.cu).  The per-pixel plane maps
(plane_maps) and the output codes (finish) are shared by both.
Full resolution only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import ElasParams
from .descriptor import texture_sum
from .fma import fma32

_BIG = 2 ** 30


def line_rows(desc: torch.Tensor) -> torch.Tensor:
    """(16, H, W) -> (16, H, W) descriptor rows clamped to [2, H-3], the
    rows the reference matches each image row against (elas.cpp:718)."""
    H = desc.shape[1]
    rows = torch.as_tensor(np.clip(np.arange(H), 2, H - 3), device=desc.device)
    return desc[:, rows, :]


def prior_offset(p: ElasParams) -> int:
    return int(max(512, 1 - int(p.prior_table().min())))


def plane_maps(tri_id: torch.Tensor, planes: torch.Tensor, p: ElasParams):
    """Per-pixel plane-prior quantities (H, W) int32: d_lo, d_hi, d_plane
    and pvalid (1 where the prior applies).

    The centre trunc(a*u + b*v + c) is evaluated as fma(a, u, b*v) + c in
    float32, the form the JAX reference's XLA:CPU path computes; the
    separately rounded form moves trunc across an integer on a few pixels
    per million."""
    H, W = tri_id.shape
    dev = tri_id.device
    pl = planes[torch.clamp(tri_id.to(torch.int64), min=0)]
    a, b, c, a_other = pl[..., 0], pl[..., 1], pl[..., 2], pl[..., 3]
    uf = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    vf = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    d_plane = torch.trunc(fma32(a, uf, b * vf) + c).to(torch.int32)
    d_lo = torch.clamp(d_plane - p.plane_radius, min=0)
    d_hi = torch.clamp(d_plane + p.plane_radius, max=p.disp_num - 1)
    lim = torch.tensor(0.7, dtype=torch.float32, device=dev)
    pvalid = ((torch.abs(a) < lim) & (torch.abs(a_other) < lim)).to(torch.int32)
    return d_lo, d_hi, d_plane, pvalid


def match_keys(desc_self: torch.Tensor, desc_other: torch.Tensor,
               d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
               pvalid: torch.Tensor, grid_mask: torch.Tensor, p: ElasParams,
               right_image: bool) -> torch.Tensor:
    """Plain version of the matching kernel (K1): the minimum key per pixel
    over its candidates, _BIG where there is none.

    desc_self/other: (16, H, W) uint8; d_lo/d_hi/d_plane/pvalid: (H, W)
    int32; grid_mask: (D, gh, gw) bool.  Returns (H, W) int32."""
    _, H, W = desc_self.shape
    dev = desc_self.device
    D = p.disp_num
    gs = p.grid_size
    A = line_rows(desc_self).to(torch.int16)
    B = line_rows(desc_other).to(torch.int16)
    Bpad = torch.nn.functional.pad(B, (0, D) if right_image else (D, 0))
    P_tab = torch.as_tensor(p.prior_table(), device=dev)
    off = prior_offset(p)
    gy = torch.arange(H, device=dev) // gs
    gx = torch.arange(W, device=dev) // gs
    u = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    pv = pvalid != 0
    best = torch.full((H, W), _BIG, dtype=torch.int32, device=dev)
    # disparities no pixel can take (no grid bit anywhere, outside every
    # window) leave every key unchanged: skip them
    any_cell = grid_mask.flatten(1).any(dim=1).cpu().numpy()
    win_lo = int(d_lo.min()) if d_lo.numel() else D
    win_hi = int(d_hi.max()) if d_hi.numel() else -1
    for d in range(D):
        if not any_cell[d] and not win_lo <= d <= win_hi:
            continue
        Bd = Bpad[:, :, d:d + W] if right_image else Bpad[:, :, D - d:D - d + W]
        E = torch.sum(torch.abs(A - Bd), dim=0, dtype=torch.int32)
        in_win = (d >= d_lo) & (d <= d_hi)
        gbit = grid_mask[d][gy][:, gx]
        u_warp = u + d if right_image else u - d
        warp_ok = (u_warp >= 2) & (u_warp <= W - 3)
        cand = ((gbit & ~in_win) | in_win) & warp_ok
        delta = torch.clamp(torch.abs(d - d_plane), 0, D - 1)
        prior = torch.where(in_win & pv, P_tab[delta.to(torch.int64)], 0)
        key = ((E + prior + off) * 2 + in_win.to(torch.int32)) * 512 + d
        best = torch.minimum(best, torch.where(cand, key, _BIG))
    return best


def finish(key: torch.Tensor, desc_self: torch.Tensor, tri_id: torch.Tensor,
           p: ElasParams) -> torch.Tensor:
    """Key -> disparity (H, W) float32 with the reference's codes: -1 where
    the pixel was visited but no candidate survived, -10 where it was not
    visited (elas.cpp:713-736, 797-800, 819-824)."""
    W = key.shape[1]
    tex = texture_sum(line_rows(desc_self))
    u = torch.arange(W, device=key.device)[None, :]
    u_ok = (u >= 2) & (u <= W - 3)
    visited = (tri_id >= 0) & u_ok & (tex >= p.match_texture)
    ok = visited & (key < _BIG)
    d_best = torch.remainder(key, 512).to(torch.float32)
    return torch.where(ok, d_best, torch.where(visited, -1.0, -10.0))


def compute_disparity(desc_self: torch.Tensor, desc_other: torch.Tensor,
                      tri_id: torch.Tensor, planes: torch.Tensor,
                      grid_mask: torch.Tensor, p: ElasParams,
                      right_image: bool, keys=match_keys) -> torch.Tensor:
    """One matching pass (left or right reference image).

    tri_id: (H, W) int (-1 = none); planes: (T, 4) f32 [a, b, c, a_other].
    Returns D (H, W) float32.  `keys` is the key scan to run: this
    module's plain version, or the kernel wrapper
    ops.cuda.matching_cu.match_keys."""
    d_lo, d_hi, d_plane, pvalid = plane_maps(tri_id, planes, p)
    key = keys(desc_self, desc_other, d_lo, d_hi, d_plane, pvalid,
               grid_mask, p, right_image)
    return finish(key, desc_self, tri_id, p)
