"""K1 wrapper: dense matching keys (csrc/matching.cu), counterpart of
stereovision_tpu/ops/pallas/matching_pl.py.

On CUDA tensors match_keys lays its inputs out for the kernel (layout) and
launches it (launch); on CPU tensors it runs the plain version
ops.matching.match_keys.  `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ...params import ElasParams
from .. import matching as plain
from . import _lib

launches = 0


def cell_words(grid_mask: torch.Tensor) -> torch.Tensor:
    """(D, gh, gw) bool -> (gh, gw, ceil(D/32)) int32 packed candidate
    words: bit b of word w is disparity 32 w + b."""
    D, gh, gw = grid_mask.shape
    nwords = -(-D // 32)
    m = torch.nn.functional.pad(grid_mask.to(torch.int64),
                                (0, 0, 0, 0, 0, nwords * 32 - D))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=m.device),
        torch.arange(32, device=m.device))
    words = (m.reshape(nwords, 32, gh, gw) * weights[None, :, None, None]
             ).sum(dim=1)
    return words.permute(1, 2, 0).to(torch.int32).contiguous()


def layout(desc_self: torch.Tensor, desc_other: torch.Tensor,
           grid_mask: torch.Tensor, p: ElasParams):
    """The kernel's inputs besides the plane maps: descriptors as uint8
    (rows, columns, 16), one pixel's descriptor one 16-byte load — A
    (Ho, Wo, 16) on the output lattice, B (Ho, W, 16) the full rows its
    warps read — the packed cell words and the prior table on the
    descriptors' device."""
    rows = plain.line_rows(desc_self, p)
    A = plain.lattice_cols(rows, p).permute(1, 2, 0).contiguous()
    B = plain.line_rows(desc_other, p).permute(1, 2, 0).contiguous()
    prior = torch.as_tensor(p.prior_table(), device=desc_self.device)
    return A, B, cell_words(grid_mask), prior


def launch(A: torch.Tensor, B: torch.Tensor, words: torch.Tensor,
           d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
           pvalid: torch.Tensor, prior: torch.Tensor, p: ElasParams,
           right_image: bool) -> torch.Tensor:
    """Launch the kernel on layout()'s tensors and the plane maps; returns
    the (Ho, Wo) int32 keys."""
    global launches
    Ho, Wo, _ = A.shape
    W = B.shape[1]
    s = plain.lattice_step(p)
    gh, gw, nwords = words.shape
    D = p.disp_num
    _lib.expect(A, "A", torch.uint8, (Ho, Wo, 16))
    _lib.expect(B, "B", torch.uint8, (Ho, W, 16))
    _lib.expect(words, "cell_words", torch.int32, (gh, gw, -(-D // 32)))
    for name, t in (("d_lo", d_lo), ("d_hi", d_hi), ("d_plane", d_plane),
                    ("pvalid", pvalid)):
        _lib.expect(t, name, torch.int32, (Ho, Wo))
    _lib.expect(prior, "prior", torch.int32, (D,))
    if s * (Wo - 1) >= W:
        raise ValueError("a %d-column lattice of step %d does not fit %d "
                         "columns" % (Wo, s, W))
    if gh * p.grid_size <= s * (Ho - 1) or gw * p.grid_size <= s * (Wo - 1):
        raise ValueError("cell words %s do not cover a %dx%d lattice of "
                         "step %d" % (tuple(words.shape), Ho, Wo, s))
    key = torch.empty((Ho, Wo), dtype=torch.int32, device=A.device)
    err = _lib.kernels().svtt_match_keys(
        _lib.ptr(A), _lib.ptr(B), _lib.ptr(words), _lib.ptr(d_lo),
        _lib.ptr(d_hi), _lib.ptr(d_plane), _lib.ptr(pvalid), _lib.ptr(prior),
        Ho, Wo, W, s, D, nwords, p.grid_size, gw, plain.prior_offset(p),
        int(right_image), _lib.ptr(key), _lib.stream())
    _lib.check(err, "match_keys")
    launches += 1
    return key


def match_keys(desc_self: torch.Tensor, desc_other: torch.Tensor,
               d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
               pvalid: torch.Tensor, grid_mask: torch.Tensor, p: ElasParams,
               right_image: bool) -> torch.Tensor:
    """Minimum matching key per output pixel, (Ho, Wo) int32 (see
    ops.matching)."""
    if desc_self.device.type == "cpu":
        return plain.match_keys(desc_self, desc_other, d_lo, d_hi, d_plane,
                                pvalid, grid_mask, p, right_image)
    A, B, words, prior = layout(desc_self, desc_other, grid_mask, p)
    return launch(A, B, words, d_lo, d_hi, d_plane, pvalid, prior, p,
                  right_image)


def compute_disparity(desc_self: torch.Tensor, desc_other: torch.Tensor,
                      tri_id: torch.Tensor, planes: torch.Tensor,
                      grid_mask: torch.Tensor, p: ElasParams,
                      right_image: bool) -> torch.Tensor:
    """ops.matching.compute_disparity through this wrapper's key scan."""
    return plain.compute_disparity(desc_self, desc_other, tri_id, planes,
                                   grid_mask, p, right_image, keys=match_keys)
