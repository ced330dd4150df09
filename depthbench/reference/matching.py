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

Under subsampling the output is the (H//2, W//2) lattice of full-resolution
pixels (2y, 2x): A is the descriptor at (clip(2y, 2, H-3), 2x), the warp
2x -/+ d reads B's full row, the candidates come from the cell of (2y, 2x),
and d stays a full-resolution disparity.

match_keys below is the plain PyTorch version of the CUDA kernel in
ops/cuda/matching_cu.py (csrc/matching.cu).  The per-pixel plane maps
(plane_maps) and the output codes (finish) are shared by both.  Every
function takes one frame or a batch (a leading batch dimension on each
input) and gives each frame its single-frame result; the plain key scan
loops over the frames of a batch.

Row padding and stripes (the row-sharded pipeline, parallel/shard.py):
`height` is the frame's true height, to which the matching row clip(s y,
2, H - 3) clamps, so padding rows at the bottom of the descriptors are
never read; compute_disparity's pad_out_rows adds -10 rows below the
output (matching.py:33-82).  The key scan may cover the output rows [y0,
y0 + count) only, from a slab of the descriptors whose row 0 is frame row
row0 and a slab of the grid mask whose row 0 is cell row g0 (stripe_rows
gives both): the kernel's stripe mode, matching_pl.py:242-293.
"""

from __future__ import annotations

import functools

import torch

from .params import ElasParams
from .descriptor import texture_sum
from .fma import fma32

_BIG = 2 ** 30


def lattice_step(p: ElasParams) -> int:
    """Full-resolution pixels between two output pixels: 2 under
    subsampling, else 1."""
    return 2 if p.subsampling else 1


def lattice_cols(desc: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """(..., 16, Ho, W) rows -> (..., 16, Ho, Wo): the output lattice's
    columns."""
    s = lattice_step(p)
    Wo = p.out_shape(desc.shape[-1], desc.shape[-2])[1]
    return desc[..., ::s][..., :Wo]


def line_rows(desc: torch.Tensor, p: ElasParams, height: int = 0,
              y0: int = 0, count: int = None,
              row0: int = 0) -> torch.Tensor:
    """(..., 16, Hs, W) -> (..., 16, count, W): for each output row y in
    [y0, y0 + count) (default: every output row) the descriptor row
    clip(s y, 2, H-3) of a frame of H = height rows, the row the reference
    matches it against (elas.cpp:718), s = lattice_step(p); desc holds
    frame rows [row0, row0 + Hs)."""
    W = desc.shape[-1]
    H = height or desc.shape[-2]
    if count is None:
        count = p.out_shape(W, H)[0] - y0
    rows = torch.clamp((y0 + torch.arange(count, device=desc.device))
                       * lattice_step(p), 2, H - 3)
    return desc[..., rows - row0, :]


def stripe_rows(p: ElasParams, height: int, y0: int, y1: int):
    """((lo, hi), (glo, ghi)): the descriptor rows and the grid mask's
    cell rows that the output rows [y0, y1) of a frame of `height` rows
    read; empty ranges for no rows."""
    if y1 <= y0:
        return (0, 0), (0, 0)
    s = lattice_step(p)
    lo, hi = (min(max(s * y, 2), height - 3) for y in (y0, y1 - 1))
    return (lo, hi + 1), (s * y0 // p.grid_size,
                          s * (y1 - 1) // p.grid_size + 1)


@functools.lru_cache(maxsize=None)
def prior_offset(p: ElasParams) -> int:
    """The key's cost offset: it keeps every cost + prior positive.  Made
    once per parameter set (every kernel launch reads it)."""
    return int(max(512, 1 - int(p.prior_table().min())))


def plane_maps(tri_id: torch.Tensor, planes: torch.Tensor, p: ElasParams):
    """Per-pixel plane-prior quantities (..., Ho, Wo) int32 on the output
    lattice: d_lo, d_hi, d_plane and pvalid (1 where the prior applies);
    a batch of maps (B, Ho, Wo) reads a batch of tables (B, T, 4).

    The centre trunc(a*u + b*v + c), at the full-resolution pixel (u, v) =
    (s x, s y), is evaluated as fma(a, u, b*v) + c in float32, the form the
    JAX reference's XLA:CPU path computes; the separately rounded form
    moves trunc across an integer on a few pixels per million."""
    Ho, Wo = tri_id.shape[-2:]
    dev = tri_id.device
    s = lattice_step(p)
    idx = torch.clamp(tri_id.to(torch.int64), min=0)
    if idx.dim() == 2:
        pl = planes[idx]
    else:
        b = torch.arange(idx.shape[0], device=dev)[:, None, None]
        pl = planes[b, idx]
    a, b, c, a_other = pl[..., 0], pl[..., 1], pl[..., 2], pl[..., 3]
    uf = (torch.arange(Wo, device=dev) * s).to(torch.float32)[None, :]
    vf = (torch.arange(Ho, device=dev) * s).to(torch.float32)[:, None]
    d_plane = torch.trunc(fma32(a, uf, b * vf) + c).to(torch.int32)
    d_lo = torch.clamp(d_plane - p.plane_radius, min=0)
    d_hi = torch.clamp(d_plane + p.plane_radius, max=p.disp_num - 1)
    lim = torch.full((), 0.7, dtype=torch.float32, device=dev)
    pvalid = ((torch.abs(a) < lim) & (torch.abs(a_other) < lim)).to(torch.int32)
    return d_lo, d_hi, d_plane, pvalid


def match_keys(desc_self: torch.Tensor, desc_other: torch.Tensor,
               d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
               pvalid: torch.Tensor, grid_mask: torch.Tensor, p: ElasParams,
               right_image: bool, height: int = 0, row0: int = 0,
               y0: int = 0, g0: int = 0) -> torch.Tensor:
    """Plain version of the matching kernel (K1): the minimum key per
    output pixel over its candidates, _BIG where there is none.

    desc_self/other: (16, H, W) uint8; d_lo/d_hi/d_plane/pvalid: (Ho, Wo)
    int32; grid_mask: (D, gh, gw) bool.  Returns (Ho, Wo) int32.  A batch
    (a leading dimension on every input) is scanned one frame at a time.
    A stripe: the maps' Ho rows are output rows [y0, y0 + Ho) of a frame
    of `height` rows, the planes a slab from frame row row0, the mask a
    slab from cell row g0 (see stripe_rows)."""
    rows = dict(height=height, row0=row0, y0=y0, g0=g0)
    if desc_self.dim() == 4:
        return torch.stack([
            match_keys(*frame, p, right_image, **rows) for frame in zip(
                desc_self, desc_other, d_lo, d_hi, d_plane, pvalid,
                grid_mask)])
    W = desc_self.shape[-1]
    H = height or desc_self.shape[-2]
    Ho, Wo = d_lo.shape
    s = lattice_step(p)
    dev = desc_self.device
    D = p.disp_num
    gs = p.grid_size
    lines = dict(height=H, y0=y0, count=Ho, row0=row0)
    A = lattice_cols(line_rows(desc_self, p, **lines), p).to(torch.int16)
    B = line_rows(desc_other, p, **lines).to(torch.int16)
    Bpad = torch.nn.functional.pad(B, (0, D) if right_image else (D, 0))
    P_tab = torch.as_tensor(p.prior_table(), device=dev)
    off = prior_offset(p)
    gy = (y0 + torch.arange(Ho, device=dev)) * s // gs - g0
    gx = torch.arange(Wo, device=dev) * s // gs
    u = torch.arange(Wo, dtype=torch.int32, device=dev)[None, :] * s
    span = s * (Wo - 1) + 1     # Bpad columns from a warp's first to last
    pv = pvalid != 0
    best = torch.full((Ho, Wo), _BIG, dtype=torch.int32, device=dev)
    # disparities no pixel can take (no grid bit anywhere, outside every
    # window) leave every key unchanged: skip them
    any_cell = grid_mask.flatten(1).any(dim=1).cpu().numpy()
    win_lo = int(d_lo.min()) if d_lo.numel() else D
    win_hi = int(d_hi.max()) if d_hi.numel() else -1
    for d in range(D):
        if not any_cell[d] and not win_lo <= d <= win_hi:
            continue
        start = d if right_image else D - d
        Bd = Bpad[:, :, start:start + span:s]
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
           p: ElasParams, height: int = 0) -> torch.Tensor:
    """Key -> disparity (Ho, Wo) float32 with the reference's codes: -1
    where the pixel was visited but no candidate survived, -10 where it was
    not visited (elas.cpp:713-736, 797-800, 819-824); `height`: the
    frame's true rows."""
    W = desc_self.shape[-1]
    tex = texture_sum(lattice_cols(line_rows(
        desc_self, p, height, count=key.shape[-2]), p))
    u = torch.arange(key.shape[-1], device=key.device) * lattice_step(p)
    u_ok = (u >= 2) & (u <= W - 3)
    visited = (tri_id >= 0) & u_ok & (tex >= p.match_texture)
    ok = visited & (key < _BIG)
    d_best = torch.remainder(key, 512).to(torch.float32)
    return torch.where(ok, d_best, torch.where(visited, -1.0, -10.0))


def compute_disparity(desc_self: torch.Tensor, desc_other: torch.Tensor,
                      tri_id: torch.Tensor, planes: torch.Tensor,
                      grid_mask: torch.Tensor, p: ElasParams,
                      right_image: bool, keys=match_keys,
                      true_height: int = 0,
                      pad_out_rows: int = 0) -> torch.Tensor:
    """One matching pass (left or right reference image).

    tri_id: (Ho, Wo) int (-1 = none) on the output lattice; planes: (T, 4)
    f32 [a, b, c, a_other].  Returns D (Ho, Wo) float32.  `keys` is the
    key scan to run: this module's plain version, or the kernel wrapper
    ops.cuda.matching_cu.match_keys.  true_height: the frame's rows when
    the descriptors carry bottom padding rows; pad_out_rows: -10 rows
    added below the output, tri_id then being (Ho + pad_out_rows, Wo)
    (the padded lattice, -1 in its padding rows).  Only the real rows are
    matched."""
    H = true_height or desc_self.shape[-2]
    Ho = p.out_shape(desc_self.shape[-1], H)[0]
    if pad_out_rows:
        if tri_id.shape[-2] != Ho + pad_out_rows:
            raise ValueError("padded mode needs lattice-shaped tri_id: "
                             "%d rows, not %d" % (Ho + pad_out_rows,
                                                  tri_id.shape[-2]))
        tri_id = tri_id[..., :Ho, :]
    d_lo, d_hi, d_plane, pvalid = plane_maps(tri_id, planes, p)
    key = keys(desc_self, desc_other, d_lo, d_hi, d_plane, pvalid,
               grid_mask, p, right_image, height=true_height)
    D = finish(key, desc_self, tri_id, p, height=H)
    if pad_out_rows:
        D = torch.nn.functional.pad(D, (0, 0, 0, pad_out_rows),
                                    value=-10.0)
    return D
