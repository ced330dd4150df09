"""Decoding of the run-length (span) code of the per-pixel triangle-id maps
(counterpart of stereovision_tpu/ops/spans.py:114); the code and its
encoder (host, NumPy) are in hostlib/geometry.py.  Decoding (device,
PyTorch): starts = cumsum(gaps); scatter the ids at their starts, dropping
starts outside the row; forward-fill along the row.
"""

from __future__ import annotations

import torch

_UNSET = -(2 ** 20)


def expand_tri_spans(spans: torch.Tensor, width: int) -> torch.Tensor:
    """(..., H, S, 3) uint8 packed spans -> (..., H, width) int32 dense map
    (rows are independent: a batch is decoded as B H rows).

    Out-of-range starts (the padding tail) go to a spare column past the
    row's end, which is then cut, as JAX's mode="drop" drops them (no step
    depends on how many there are: a CUDA graph captures it); the forward
    fill is a cummax over the column index of the last set position."""
    lead = spans.shape[:-2]
    spans = spans.reshape(-1, *spans.shape[-2:])
    gaps = spans[..., 0].to(torch.int64)
    v = spans[..., 1].to(torch.int32) + 256 * spans[..., 2].to(torch.int32)
    ids = torch.where(v == 0xFFFF, -1, v)
    starts = torch.cumsum(gaps, dim=-1)
    H = spans.shape[0]
    dev = spans.device
    rows = torch.arange(H, device=dev)[:, None].expand_as(starts)
    spare = torch.full((H, width + 1), _UNSET, dtype=torch.int32, device=dev)
    # starts strictly increase along a row (every gap after the first is
    # >= 1), so no two runs share a position inside the row
    spare.index_put_((rows, torch.clamp(starts, max=width)), ids)
    dense = spare[:, :width]
    cols = torch.arange(width, device=dev)[None, :].expand(H, width)
    last = torch.cummax(torch.where(dense != _UNSET, cols, -1), dim=1).values
    # column 0 always starts a run, so every position has a last set one
    return torch.gather(dense, 1, last).reshape(*lead, width)
