"""points_rel: the largest difference of one coordinate of the cloud,
|served - reference| / max(|reference|, 1), over the frames whose cloud was
kept; a point finite on one side and not on the other (or of another sign
of infinity), or a cloud of another shape, counts as inf."""

import numpy as np


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


def keep(out, cloud):
    return out["points"] if cloud else None


def read(kept, refs, pairs, config, device):
    rel = 0.0
    for k, clouds in kept.items():
        r = refs[k]["points"]
        for pts in clouds:
            if pts is None:
                continue
            pts = np.asarray(pts).reshape(-1, 3)
            rel = max(rel, points_rel(pts, r) if pts.shape == r.shape
                      else float("inf"))
    return rel
