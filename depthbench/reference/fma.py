"""Fused multiply-add in float32, as the JAX reference's CPU path computes it.

XLA:CPU contracts multiply-add chains into fused multiply-adds: it
evaluates `a*u + b*v + c` as `fma(a, u, b*v) + c`, which can differ in the
last bit from the separately rounded form that PyTorch computes.  Where a
float result feeds `trunc` (the plane-prior centre) one bit moves the prior
window, so the port writes these chains with fma32 explicitly, on every
device.
"""

from __future__ import annotations

import torch


def fma32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x*y + z in float32 with one rounding.

    The product of two float32 values is exact in float64; the float64 sum
    is then rounded once to float32.  (A float64 sum can itself round when
    the operands' exponents are far apart, so the result is a true fma up
    to a double rounding that needs an exact float32 tie: not observed.)"""
    return (x.double() * y.double() + z.double()).float()
