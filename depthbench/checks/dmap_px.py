"""dmap_px: the most pixels of one served frame's uint8 display disparity
that differ from the reference's for its pair (a frame of another shape:
every pixel)."""

import numpy as np


def keep(out, cloud):
    return out["dmap"]


def read(kept, refs, pairs, config, device):
    px = 0
    for k, dmaps in kept.items():
        r = refs[k]["dmap"]
        for dm in dmaps:
            dm = np.asarray(dm)
            if dm.shape != r.shape:
                px = max(px, r.size)
            else:
                px = max(px, int((dm != r).sum()))
    return float(px)
