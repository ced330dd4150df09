"""Sobel 3x3 with the reference's exact fixed-point semantics, in PyTorch
(counterpart of stereovision_tpu/ops/filters.py:27-61).

  temp_v(y,x) = in(y-1,x) + 2*in(y,x) + in(y+1,x)
  temp_h(y,x) = in(y-1,x) - in(y+1,x)
  du(y,x)     = sat(((temp_v(y,x-1) - temp_v(y,x+1)) >> 2) + 128)
  dv(y,x)     = sat(((temp_h(y,x-1) + 2*temp_h(y,x) + temp_h(y,x+1)) >> 2) + 128)

`>>` on int32 is an arithmetic shift (floor division by 4) in both
frameworks; sat() clips to [0, 255] before the uint8 cast.
"""

from __future__ import annotations

import torch


def _sat_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 255).to(torch.uint8)


def _shift_floor4(x: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_right_shift(x, 2)


def _pad_roll(x: torch.Tensor, dy: int, dx: int, fill=0) -> torch.Tensor:
    """x shifted so that out(y, x) = in(y+dy, x+dx), `fill` outside."""
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        x[..., max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def sobel3x3(img: torch.Tensor):
    """(..., H, W) integer image -> (du, dv) uint8 gradient images."""
    x = img.to(torch.int32)
    up = _pad_roll(x, -1, 0)
    dn = _pad_roll(x, 1, 0)
    temp_v = up + 2 * x + dn
    temp_h = up - dn
    du = _shift_floor4(_pad_roll(temp_v, 0, -1) - _pad_roll(temp_v, 0, 1)) + 128
    dv = _shift_floor4(_pad_roll(temp_h, 0, -1) + 2 * temp_h
                       + _pad_roll(temp_h, 0, 1)) + 128
    return _sat_u8(du), _sat_u8(dv)
