"""The benchmark's one traffic generator: seeded stereo pairs of a textured
synthetic scene with a known disparity (byte for byte the frames of the
port's synthetic.stereo_pair, drawn here in one pass), cycled as a traffic
mix's data file says.

A traffic mix (traffic/<name>.json) names the entry point that serves it
(drivers/<entry>.py) and its parameters; every mix draws its frames, and
the order it sends them in, here.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]


def disparity_field(width: int, height: int) -> np.ndarray:
    """(H, W) int32 true disparity of the left image: a slanted ground
    below the horizon, a far background above it, two boxes."""
    horizon = int(height * 0.4)
    far, near = max(2, width // 200), max(6, width // 20)
    v = np.arange(height)[:, None]
    ground = far + (near - far) * (v - horizon) / max(height - 1 - horizon, 1)
    d = np.where(v > horizon, np.rint(ground), far) * np.ones((1, width))
    d = d.astype(np.int32)
    boxes = ((0.15, 0.30, 0.25, 0.70, max(4, width // 40)),
             (0.55, 0.75, 0.30, 0.80, max(5, width // 28)))
    for x0, x1, y0, y1, db in boxes:
        d[int(y0 * height):int(y1 * height),
          int(x0 * width):int(x1 * width)] = db
    return d


def stereo_pair(width: int, height: int, seed: int) -> Pair:
    """-> (left, right): (H, W, 3) uint8 BGR frames with three equal
    channels; the right one is the left one warped by disparity_field,
    nearer surfaces drawn last, fresh texture where nothing lands."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (height // 4 + 1, width // 4 + 1))
    coarse = np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:height, :width]
    fine = rng.integers(0, 256, (height, width))
    left = (0.5 * coarse + 0.5 * fine).astype(np.uint8)
    disp = disparity_field(width, height)
    right = rng.integers(0, 256, (height, width)).astype(np.uint8)
    # every left pixel lands at u - d of its row; where several land on one
    # right pixel, the nearest (largest d) is drawn, in one pass
    v, u = np.indices((height, width))
    ok = u >= disp
    dst = (v * width + u - disp)[ok]
    d = disp[ok]
    top = np.full(height * width, -1, np.int32)
    np.maximum.at(top, dst, d)
    near = d == top[dst]
    right.reshape(-1)[dst[near]] = left[ok][near]
    bgr = lambda g: np.repeat(g[..., None], 3, axis=-1)  # noqa: E731
    return bgr(left), bgr(right)


def pairs(config: dict, traffic: dict, seed: int) -> List[Pair]:
    """The mix's distinct pairs for a seed: stereo_pair(W, H, seed * 100 +
    i) for i < traffic["pairs"]."""
    return [stereo_pair(config["width"], config["height"], seed * 100 + i)
            for i in range(int(traffic["pairs"]))]


class Schedule:
    """Which pair each frame sends: the pairs in turn, each turn in an
    order of its own drawn from the seed, so that no two batches in a row
    need be alike; schedule[i] is frame i's pair."""

    def __init__(self, n_pairs: int, seed: int):
        self.n, self.seed = n_pairs, seed
        self.order: List[int] = []

    def __getitem__(self, i: int) -> int:
        while len(self.order) <= i:
            turn = len(self.order) // self.n
            rng = np.random.default_rng([self.seed, 11, turn])
            self.order.extend(int(k) for k in rng.permutation(self.n))
        return self.order[i]
