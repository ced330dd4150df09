"""K1 wrapper: dense matching keys (csrc/matching.cu), counterpart of
stereovision_tpu/ops/pallas/matching_pl.py.

On CUDA tensors match_keys lays its inputs out for the kernel (layout) and
launches it (launch); on CPU tensors it runs the plain version
ops.matching.match_keys.  `launches` counts kernel launches.  Every
function takes one frame or a batch of frames (a leading batch dimension
on every input): a batch is one launch.
"""

from __future__ import annotations

import threading

import torch

from ...params import ElasParams
from .. import matching as plain
from . import _lib

launches = 0
_priors = {}
_priors_lock = threading.Lock()


def prior_table(p: ElasParams, device: torch.device) -> torch.Tensor:
    """The (D,) int32 prior table, resident on `device`: made once per
    device and parameter set, shared by every launch (single-frame and
    batched) from any thread."""
    key = (p, device)
    with _priors_lock:
        t = _priors.get(key)
        if t is None:
            t = torch.as_tensor(p.prior_table(), device=device)
            if t.device.type == "cuda":
                # a pageable copy may still be in flight when it returns;
                # other threads' streams read the table without waiting
                torch.cuda.current_stream(t.device).synchronize()
            _priors[key] = t
    return t


def cell_words(grid_mask: torch.Tensor) -> torch.Tensor:
    """(..., D, gh, gw) bool -> (..., gh, gw, ceil(D/32)) int32 packed
    candidate words: bit b of word w is disparity 32 w + b."""
    D, gh, gw = grid_mask.shape[-3:]
    nwords = -(-D // 32)
    m = torch.nn.functional.pad(grid_mask.to(torch.int64),
                                (0, 0, 0, 0, 0, nwords * 32 - D))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=m.device),
        torch.arange(32, device=m.device))
    words = (m.reshape(*m.shape[:-3], nwords, 32, gh, gw)
             * weights[:, None, None]).sum(dim=-3)
    return words.movedim(-3, -1).to(torch.int32).contiguous()


def layout(desc_self: torch.Tensor, desc_other: torch.Tensor,
           grid_mask: torch.Tensor, p: ElasParams):
    """The kernel's inputs besides the plane maps: descriptors as uint8
    (rows, columns, 16), one pixel's descriptor one 16-byte load — A
    (..., Ho, Wo, 16) on the output lattice, B (..., Ho, W, 16) the full
    rows its warps read — the packed cell words and the resident prior
    table."""
    rows = plain.line_rows(desc_self, p)
    A = plain.lattice_cols(rows, p).movedim(-3, -1).contiguous()
    B = plain.line_rows(desc_other, p).movedim(-3, -1).contiguous()
    return A, B, cell_words(grid_mask), prior_table(p, desc_self.device)


def launch(A: torch.Tensor, B: torch.Tensor, words: torch.Tensor,
           d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
           pvalid: torch.Tensor, prior: torch.Tensor, p: ElasParams,
           right_image: bool) -> torch.Tensor:
    """Launch the kernel on layout()'s tensors and the plane maps; returns
    the (..., Ho, Wo) int32 keys."""
    n = _lib.frames(A, 3)
    lead = tuple(A.shape[:-3])
    Ho, Wo, _ = A.shape[-3:]
    W = B.shape[-2]
    s = plain.lattice_step(p)
    gh, gw, nwords = words.shape[-3:]
    D = p.disp_num
    _lib.expect(A, "A", torch.uint8, lead + (Ho, Wo, 16))
    _lib.expect(B, "B", torch.uint8, lead + (Ho, W, 16))
    _lib.expect(words, "cell_words", torch.int32,
                lead + (gh, gw, -(-D // 32)))
    for name, t in (("d_lo", d_lo), ("d_hi", d_hi), ("d_plane", d_plane),
                    ("pvalid", pvalid)):
        _lib.expect(t, name, torch.int32, lead + (Ho, Wo))
    _lib.expect(prior, "prior", torch.int32, (D,))
    if s * (Wo - 1) >= W:
        raise ValueError("a %d-column lattice of step %d does not fit %d "
                         "columns" % (Wo, s, W))
    if gh * p.grid_size <= s * (Ho - 1) or gw * p.grid_size <= s * (Wo - 1):
        raise ValueError("cell words %s do not cover a %dx%d lattice of "
                         "step %d" % (tuple(words.shape), Ho, Wo, s))
    key = torch.empty(lead + (Ho, Wo), dtype=torch.int32, device=A.device)
    err = _lib.kernels().svtt_match_keys(
        _lib.ptr(A), _lib.ptr(B), _lib.ptr(words), _lib.ptr(d_lo),
        _lib.ptr(d_hi), _lib.ptr(d_plane), _lib.ptr(pvalid), _lib.ptr(prior),
        n, Ho, Wo, W, s, D, nwords, p.grid_size, gh, gw,
        plain.prior_offset(p), int(right_image), _lib.ptr(key),
        _lib.stream())
    _lib.check(err, "match_keys")
    _lib.count(globals())
    return key


def match_keys(desc_self: torch.Tensor, desc_other: torch.Tensor,
               d_lo: torch.Tensor, d_hi: torch.Tensor, d_plane: torch.Tensor,
               pvalid: torch.Tensor, grid_mask: torch.Tensor, p: ElasParams,
               right_image: bool) -> torch.Tensor:
    """Minimum matching key per output pixel, (..., Ho, Wo) int32 (see
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
