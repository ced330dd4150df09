"""Run-length (span) codec for the per-pixel triangle-id maps (counterpart
of stereovision_tpu/ops/spans.py:37,114).

Encoding (host, NumPy): (H, S, 3) uint8 of [gap, id_lo, id_hi], 3 bytes a
run — gap is the column delta from the previous run's start (0 for the
first run of a row), gaps over 255 are split into filler runs that repeat
the previous id, and the id is a little-endian uint16 with 0xFFFF for -1.
Rows are padded with repeat-fillers.  Decoding (device, PyTorch): starts =
cumsum(gaps); scatter the ids at their starts, dropping starts outside the
row; forward-fill along the row.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

_UNSET = -(2 ** 20)


def encode_tri_spans(tri: np.ndarray, s_max: int) -> np.ndarray:
    """Dense (H, W) int triangle-id map -> (H, s_max, 3) uint8 packed spans.
    Rows with more than s_max runs keep their first s_max (the previous id
    then persists over the dropped tail) and a warning is emitted."""
    tri = np.asarray(tri)
    if tri.max(initial=-1) >= 0xFFFF:
        raise ValueError("triangle id %d overflows the uint16 span codec"
                         % int(tri.max()))
    H, W = tri.shape
    change = np.empty((H, W), dtype=bool)
    change[:, 0] = True
    np.not_equal(tri[:, 1:], tri[:, :-1], out=change[:, 1:])
    counts = change.sum(axis=1)
    rows, cols = np.nonzero(change)           # row-major order
    offsets = np.cumsum(counts) - counts
    k = np.arange(rows.size) - offsets[rows]  # run index within row
    ids = tri[rows, cols].astype(np.int64)

    gaps = np.empty_like(cols)
    first = k == 0
    gaps[first] = cols[first]                 # == 0 by construction
    gaps[~first] = cols[~first] - cols[np.nonzero(~first)[0] - 1]
    # split gaps > 255 into repeat-fillers that precede their run
    n_ins = np.maximum(0, (gaps + 254) // 255 - 1)
    ins_incl = np.cumsum(n_ins)
    ins_excl = ins_incl - n_ins
    row_base = ins_excl[offsets[rows]] if rows.size else ins_excl
    k_new = k + (ins_incl - row_base)
    gaps_real = gaps - 255 * n_ins            # in [0, 255]

    new_counts = np.zeros(H, np.int64)
    if rows.size:
        np.add.at(new_counts, rows, 1 + n_ins)
    if new_counts.max(initial=0) > s_max:
        warnings.warn(
            "tri-span overflow: row has %d runs > s_max=%d; tail runs "
            "dropped (approximate)" % (int(new_counts.max()), s_max))

    # every slot starts as a filler repeating the row's last run id; real
    # runs and the mid-row fillers of >255-column gaps are scattered in
    out_gap = np.full((H, s_max), 255, np.uint8)
    out_id = np.broadcast_to(tri[:, -1:].astype(np.int64),
                             (H, s_max)).copy()
    sel = k_new < s_max
    out_gap[rows[sel], k_new[sel]] = gaps_real[sel]
    out_id[rows[sel], k_new[sel]] = ids[sel]
    big = np.nonzero(n_ins > 0)[0]            # flat run indices (never k=0)
    if big.size:
        n = n_ins[big]
        rep = np.repeat(big, n)
        offs = np.arange(rep.size) - np.repeat(np.cumsum(n) - n, n)
        kf = np.repeat(k_new[big] - n, n) + offs
        fsel = kf < s_max
        out_gap[np.repeat(rows[big], n)[fsel], kf[fsel]] = 255
        out_id[np.repeat(rows[big], n)[fsel], kf[fsel]] = ids[rep[fsel] - 1]

    u16 = (out_id & 0xFFFF).astype(np.uint16)  # -1 -> 0xFFFF
    packed = np.empty((H, s_max, 3), np.uint8)
    packed[..., 0] = out_gap
    packed[..., 1] = u16 & 0xFF
    packed[..., 2] = u16 >> 8
    return packed


def expand_tri_spans(spans: torch.Tensor, width: int) -> torch.Tensor:
    """(H, S, 3) uint8 packed spans -> (H, width) int32 dense map.

    Out-of-range starts (the padding tail) are masked before the scatter,
    as JAX's mode="drop" drops them; the forward fill is a cummax over the
    column index of the last set position."""
    gaps = spans[..., 0].to(torch.int64)
    v = spans[..., 1].to(torch.int32) + 256 * spans[..., 2].to(torch.int32)
    ids = torch.where(v == 0xFFFF, -1, v)
    starts = torch.cumsum(gaps, dim=-1)
    H = spans.shape[0]
    dev = spans.device
    keep = starts < width
    rows = torch.arange(H, device=dev)[:, None].expand_as(starts)
    dense = torch.full((H, width), _UNSET, dtype=torch.int32, device=dev)
    # starts strictly increase along a row (every gap after the first is
    # >= 1), so no two runs share a position
    dense.index_put_((rows[keep], starts[keep]), ids[keep])
    cols = torch.arange(width, device=dev)[None, :].expand(H, width)
    last = torch.cummax(torch.where(dense != _UNSET, cols, -1), dim=1).values
    # column 0 always starts a run, so every position has a last set one
    return torch.gather(dense, 1, last)
