"""Sobel-family integer filters with the reference's exact fixed-point
semantics, in PyTorch (counterpart of stereovision_tpu/ops/filters.py:27-130).
sobel3x3 feeds the descriptor; sobel5x5, blob5x5, checkerboard5x5 and
integral_image are the reference's other filters (filter.cpp), which no
stage of the pipeline calls.

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


def _taps(x: torch.Tensor, kern, vertical: bool) -> torch.Tensor:
    """sum_i kern[i] * x shifted by i - len(kern)//2 along one axis."""
    acc = torch.zeros_like(x)
    c = len(kern) // 2
    for i, k in enumerate(kern):
        if k:
            acc = acc + k * (_pad_roll(x, i - c, 0) if vertical
                             else _pad_roll(x, 0, i - c))
    return acc


def sobel5x5(img: torch.Tensor):
    """5x5 Sobel (reference filter.cpp:426-434): column [1,4,6,4,1] /
    [1,2,0,-2,-1], then row [1,2,0,-2,-1] / [1,4,6,4,1], >> 7, + 128,
    saturated -> (du, dv) uint8."""
    x = img.to(torch.int32)
    smooth_k = (1, 4, 6, 4, 1)
    deriv_k = (1, 2, 0, -2, -1)
    tv = _taps(x, smooth_k, vertical=True)
    th = _taps(x, deriv_k, vertical=True)
    du = torch.bitwise_right_shift(_taps(tv, deriv_k, vertical=False), 7) + 128
    dv = torch.bitwise_right_shift(_taps(th, smooth_k, vertical=False), 7) + 128
    return _sat_u8(du), _sat_u8(dv)


def blob5x5(img: torch.Tensor) -> torch.Tensor:
    """Blob filter (reference filter.cpp:448-475): -(5x5 box sum) + 2 *
    (3x3 box sum) + 7 * centre, int32, zero outside the image."""
    x = img.to(torch.int32)
    box5 = torch.zeros_like(x)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            box5 = box5 + _pad_roll(x, dy, dx)
    box3 = torch.zeros_like(x)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            box3 = box3 + _pad_roll(x, dy, dx)
    return -box5 + 2 * box3 + 7 * x


def checkerboard5x5(img: torch.Tensor) -> torch.Tensor:
    """Checkerboard filter (reference filter.cpp:441-446): separable
    [1,1,0,-1,-1] x [1,1,0,-1,-1], int32."""
    kern = (1, 1, 0, -1, -1)
    tc = _taps(img.to(torch.int32), kern, vertical=True)
    return _taps(tc, kern, vertical=False)


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """Inclusive 2-D prefix sum in int32 (reference filter.cpp:49-66)."""
    x = img.to(torch.int32)
    return torch.cumsum(torch.cumsum(x, dim=-1, dtype=torch.int32), dim=-2,
                        dtype=torch.int32)
