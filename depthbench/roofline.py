"""The least time an H100 could take for the four ELAS kernels' work, from
the shapes and from this data's candidates.

The arithmetic is chip_smoke.py's (bound_ms, support_ops, n_candidates and
the bytes and operations of its kernel checks), fed from the plain
reference's own plane maps and grid masks, so that it counts the work the
frames need whatever kernel does it:

  K1 matching (a launch a pass, left and right): the lattice's descriptor
     columns and the B planes' rows, the grid mask, four plane maps and the
     keys, plus one prior table a launch; 32 operations a candidate.
  K2 support scan: both descriptor images and the scan's output rows; the
     SAD table's operations (support_ops).
  K3 speckle: a read and a write of the map, 16 operations a pixel.
  K4 L/R check: two maps read, two written, 8 operations a pixel each way.

A batched launch does B frames' work (one prior table).  Published peaks of
one H100 SXM: 3.35 TB/s of device memory, 67 T 32-bit operations a second
outside the tensor cores.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
KERNELS = ("K1", "K2", "K3", "K4")


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    32-bit rate, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


@functools.lru_cache(maxsize=None)
def support_ops(p, width: int, height: int) -> int:
    """Least operations of one frame's support scan: each (row, x, d) that
    either direction reads costs one SAD32 (64 operations), each Fg entry
    one add and each valid (u, d) of a direction one compare."""
    u = np.arange(width)
    per_row = 0
    for d in range(max(p.disp_min, 0), p.disp_max + 1):
        fwd = u[u >= d + 5]
        bwd = u[u <= width - d - 5] + d
        fg = np.union1d(fwd, bwd)
        f = np.union1d(fg - 2, fg + 2)
        per_row += 64 * f.size + fg.size + fwd.size + bwd.size
    return -(-height // p.step) * per_row


def lattice_step(p) -> int:
    return 2 if p.subsampling else 1


def n_candidates(p, width: int, d_lo: torch.Tensor, d_hi: torch.Tensor,
                 gm: torch.Tensor, right_image: bool) -> int:
    """Candidates one matching pass has: each output pixel's grid-cell
    bits and plane window, the warped column inside the row."""
    s = lattice_step(p)
    Ho, Wo = d_lo.shape
    dev = d_lo.device
    gy = torch.arange(Ho, device=dev) * s // p.grid_size
    gx = torch.arange(Wo, device=dev) * s // p.grid_size
    uu = torch.arange(Wo, device=dev)[None, :] * s
    n = 0
    for d in range(p.disp_num):
        uw = uu + d if right_image else uu - d
        cand = ((gm[d][gy][:, gx] | ((d >= d_lo) & (d <= d_hi)))
                & (uw >= 2) & (uw <= width - 3))
        n += int(cand.sum())
    return n


def frame_work(p, width: int, height: int, passes) -> Dict[str, tuple]:
    """One frame's (bytes, operations) by kernel; K1 as two entries, one a
    pass.  passes: the reference's [(d_lo, d_hi, grid mask, right_image)]
    for the left and the right pass."""
    Ho, Wo = p.out_shape(width, height)
    hc = -(-height // p.step)
    out = {"K2": (2 * 16 * height * width + 8 * hc * width * 4,
                  support_ops(p, width, height)),
           "K3": (2 * Ho * Wo * 4, Ho * Wo * 16),
           "K4": (4 * Ho * Wo * 4, 2 * Ho * Wo * 8)}
    for lo, hi, gm, right in passes:
        nbytes = (Ho * Wo * 16 + Ho * width * 16
                  + p.disp_num * gm.shape[-2] * gm.shape[-1]
                  + 4 * Ho * Wo * 4 + Ho * Wo * 4)
        out["K1" + ("r" if right else "l")] = (
            nbytes, 32 * n_candidates(p, width, lo, hi, gm, right))
    return out


def call_bounds(p, works: Sequence[Dict[str, tuple]],
                batch: int) -> Dict[str, float]:
    """Mean least seconds of one launch of each kernel over a cycle of the
    traffic, taken as frame i being pair i % len(works) and batch b
    holding frames b*batch to b*batch + batch - 1 (the mix sends each turn
    of the pairs in an order of its own, so a batch smaller than a turn
    holds another split of it; a single frame, or a batch of a whole turn,
    is exact).  K1's mean is over its left and right launches."""
    n = len(works)
    kinds = np.lcm(n, batch) // batch
    tot = {k: 0.0 for k in KERNELS}
    for b in range(kinds):
        frames = [works[(b * batch + j) % n] for j in range(batch)]
        for k in ("K2", "K3", "K4"):
            tot[k] += bound_s(sum(f[k][0] for f in frames),
                              sum(f[k][1] for f in frames))
        for side in ("K1l", "K1r"):
            tot["K1"] += 0.5 * bound_s(
                sum(f[side][0] for f in frames) + p.disp_num * 4,
                sum(f[side][1] for f in frames))
    return {k: v / kinds for k, v in tot.items()}


def share(bounds: Dict[str, float], kernels: Dict[str, List[float]]):
    """Percent of the kernels' traced device time that their least time
    is: sum over K1-K4 of calls times the mean bound a call, over the sum of
    their device seconds; None where the trace holds none of them.
    kernels: name -> [calls, device seconds]."""
    busy = sum(kernels[k][1] for k in KERNELS if k in kernels)
    if busy <= 0:
        return None
    least = sum(kernels[k][0] * bounds[k] for k in KERNELS if k in kernels)
    return 100.0 * least / busy
