"""Whether what the timed path served is correct: every compared frame's
display disparity and point cloud against the plain reference's for its
pair.

Two numbers, each with a limit from the configuration's "check" entry:

  dmap_px     the most pixels of one frame's uint8 display disparity that
              differ from the reference's;
  points_rel  the largest difference of one coordinate of the cloud,
              |served - reference| / max(|reference|, 1), over the frames
              whose cloud was kept; a point finite on one side and not on
              the other (or of another sign of infinity) counts as inf.

A frame that was sent and never came back counts as missing, and a run
with any missing frame is not correct.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

NAMES = ("dmap_px", "points_rel")


def points_rel(served: np.ndarray, ref: np.ndarray) -> float:
    a = np.asarray(served, np.float64)
    b = np.asarray(ref, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return float("inf")
    inf = ~fa & ~np.isnan(a)
    if not np.array_equal(a[inf], b[inf]) or \
            not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    if not fa.any():
        return 0.0
    d = np.abs(a[fa] - b[fa]) / np.maximum(np.abs(b[fa]), 1.0)
    return float(d.max())


def compare(served: Dict[int, List[dict]], refs: Dict[int, dict]) -> dict:
    """served: pair index -> outputs kept for it ({"dmap", "points" or
    None}); refs: pair index -> the reference's output.  -> {name: the
    worst reading} and "frames" / "clouds" compared."""
    px, rel, frames, clouds = 0, 0.0, 0, 0
    for k, outs in served.items():
        r = refs[k]
        for o in outs:
            dm = np.asarray(o["dmap"])
            if dm.shape != r["dmap"].shape:
                px = max(px, r["dmap"].size)
            else:
                px = max(px, int((dm != r["dmap"]).sum()))
            frames += 1
            if o.get("points") is not None:
                pts = np.asarray(o["points"]).reshape(-1, 3)
                rel = max(rel, points_rel(pts, r["points"])
                          if pts.shape == r["points"].shape
                          else float("inf"))
                clouds += 1
    return {"dmap_px": px, "points_rel": rel, "frames": frames,
            "clouds": clouds}


def verdict(readings: dict, limits: dict, missing: int) -> tuple:
    """-> (correct, [[name, value, limit], ...]) with missing frames as a
    number of its own (limit 0)."""
    rows = [[n, readings[n], limits[n]] for n in NAMES]
    rows.append(["missing_frames", missing, 0])
    ok = all(v <= lim for _, v, lim in rows) and readings["frames"] > 0
    return ok, rows


def limits_of(config: dict) -> Dict[str, float]:
    lim: Optional[dict] = config.get("check")
    if not lim or any(n not in lim for n in NAMES):
        raise ValueError("configuration %r states no limits for %s"
                         % (config.get("name"), ", ".join(NAMES)))
    return {n: float(lim[n]) for n in NAMES}
