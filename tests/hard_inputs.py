"""Hard inputs for the speckle filter (K3), the support scan (K2), the
matching pass (K1) and the L/R check (K4), made with NumPy from a seed.

The maps stress what a tiled, union-find labelling can get wrong: one
component over the whole frame, a one-pixel-wide serpentine across every
32 x 8 and 32 x 16 tile border, isolated pixels, a similarity test decided
by the last bit of float32, components of exactly `speckle` - 1 and
`speckle` pixels astride tile corners, and a batch whose frames touch at
their shared row.  The descriptors give the support scan true matches at a
few disparities, and, with few byte levels, many ties.  The matching
inputs pair those descriptors (or constant ones, where every SAD ties and
d decides) with grid masks all set, none set and random, and plane tables
whose windows touch 0 and D - 1, whose centre lies outside [0, D), and
whose slopes switch the prior off.  The L/R maps hold the codes -1 and
-10, warps that land exactly on columns 0 and W - 1 or just outside, and
differences exactly at the threshold and one above it.  Both
tests/test_torch_hard_inputs.py (the plain versions against the JAX
package) and tests/test_torch_kernels.py (the kernels against the plain
versions on the card) use them; this module imports neither torch nor jax.
"""

import numpy as np

INVALID = -1.0


def whole(H, W, thr, speckle, seed):
    """One component over the whole frame: a slow ramp with jitter, every
    neighbour step well under thr."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W]
    D = 20.0 + 0.05 * thr * (u + v) + 0.3 * thr * rng.random((H, W))
    return D.astype(np.float32)


def serpentine_rows(H, W, thr, speckle, seed):
    """A one-pixel-wide path: every even row in full, joined at alternate
    ends through the odd rows, on an invalid background.  Its rows cross
    every vertical tile border; a run alone (W pixels) may be under
    `speckle`, the whole path is not."""
    D = np.full((H, W), INVALID, np.float32)
    D[0::2, :] = 30.0
    for v in range(1, H, 2):
        D[v, W - 1 if (v // 2) % 2 == 0 else 0] = 30.0
    # neighbours along the path alternate by 0.75 thr: still joined
    D[D >= 0] += np.where((np.add.outer(np.arange(H), np.arange(W)) % 2
                           == 0)[D >= 0], 0.0, 0.75 * thr).astype(np.float32)
    return D


def serpentine_cols(H, W, thr, speckle, seed):
    """serpentine_rows transposed: its columns cross every horizontal tile
    border."""
    return np.ascontiguousarray(serpentine_rows(W, H, thr, speckle, seed).T)


def checkerboard(H, W, thr, speckle, seed):
    """Every other pixel invalid: every valid pixel is a singleton."""
    rng = np.random.default_rng(seed)
    D = (10.0 + 5.0 * rng.random((H, W))).astype(np.float32)
    D[np.add.outer(np.arange(H), np.arange(W)) % 2 == 1] = INVALID
    return D


def _stripes(H, W, a, b):
    """Bands of 20 rows, each row of a band alternating a, b column by
    column, an invalid row between bands.  A stripe alone is 20 pixels;
    joined, a band is 20 W."""
    D = np.where(np.arange(W) % 2 == 0, a, b).astype(np.float32)
    D = np.tile(D, (H, 1))
    D[20::21, :] = INVALID
    return D


def stripes_at(H, W, thr, speckle, seed):
    """|a - b| equals thr in float32: the stripes join."""
    a = np.float32(12.5)
    b = np.float32(a + np.float32(thr))
    assert np.abs(b - a) == np.float32(thr)
    return _stripes(H, W, a, b)


def stripes_above(H, W, thr, speckle, seed):
    """|a - b| is the next float32 above thr: the stripes stay apart."""
    a = np.float32(12.5)
    b = np.nextafter(np.float32(a + np.float32(thr)), np.float32(np.inf))
    assert np.abs(b - a) > np.float32(thr)
    return _stripes(H, W, a, b)


def _blob(D, v0, u0, width, n, value):
    """n pixels of value, row by row in rows of `width` from (v0, u0)."""
    for k in range(n):
        D[v0 + k // width, u0 + k % width] = value


def blobs(H, W, thr, speckle, seed):
    """On a valid background, blobs of exactly speckle - 1 pixels (removed)
    and speckle pixels (kept), each astride a tile corner (u = 32 k, v =
    8 k and 16 k), and two blobs under speckle pixels that touch at a
    corner only (4-connectivity keeps them apart: both removed; joined,
    they would be kept)."""
    rng = np.random.default_rng(seed)
    D = (50.0 + 0.2 * thr * rng.random((H, W))).astype(np.float32)
    width = _blob_width(speckle)
    rows = -(-speckle // width)
    _blob(D, 16 - rows // 2, 32 - width // 2, width, speckle - 1, 10.0)
    _blob(D, 48 - rows // 2, 96 - width // 2, width, speckle, 10.0)
    # corner to corner: the first fills whole rows, so its last pixel is
    # its bottom-right corner; the second starts one row lower, one right
    n = (speckle - 1) // width * width
    v1, u1 = 80 - rows, 64 - width
    _blob(D, v1, u1, width, n, 20.0)
    _blob(D, v1 + n // width, u1 + width, width, speckle - 1, 20.0)
    return D


def _blob_width(speckle):
    return max(int(np.ceil(np.sqrt(speckle))), 2)


def blobs_removed(speckle):
    """Pixels of blobs() that the speckle filter removes."""
    return 2 * (speckle - 1) + (speckle - 1) // _blob_width(speckle) \
        * _blob_width(speckle)


MAPS = {f.__name__: f for f in (whole, serpentine_rows, serpentine_cols,
                                checkerboard, stripes_at, stripes_above,
                                blobs)}
# (W, H): the second is not a multiple of the 32 x 16 tiles either way
MAP_SIZES = [(160, 120), (333, 101)]


def touching_batch(H, W, thr, speckle, seed, frames=3):
    """`frames` maps of blobs() whose last row ends in a segment of
    speckle // 2 + 1 pixels that the next frame's first row repeats, the
    rows next to both invalid: a segment alone is removed, the two would
    be kept if labelling joined frames."""
    n = speckle // 2 + 1
    out = []
    for b in range(frames):
        D = blobs(H, W, thr, speckle, seed + b)
        D[[0, 1, H - 2, H - 1], :] = INVALID
        D[0, :n] = 60.0 + b - 1     # frame b - 1's last segment
        D[H - 1, :n] = 60.0 + b
        out.append(D)
    return np.stack(out)


# (W, H, disp_min, disp_max, byte levels) of the support scan: disp_min > 0;
# disp_max above the frame's width; few levels (ties) with both
SCAN_CASES = [
    (160, 120, 7, 63, 256),
    (333, 101, 3, 120, 256),
    (160, 120, 0, 197, 256),
    (333, 101, 5, 370, 4),
    (160, 120, 12, 190, 2),
]


def case_id(case):
    return "-".join(map(str, case))


def descriptors(H, W, seed, levels=256, shift=9):
    """(16, H, W) uint8 pairs: desc2 is desc1 moved left by a disparity of
    shift + (v // 16) % 5 columns, with one byte in 8 redrawn; with few
    levels, many costs tie."""
    rng = np.random.default_rng(seed)
    desc1 = rng.integers(0, levels, (16, H, W), dtype=np.uint8)
    desc2 = np.empty_like(desc1)
    for v in range(H):
        desc2[:, v] = np.roll(desc1[:, v], -(shift + (v // 16) % 5), axis=1)
    noise = rng.random(desc2.shape) < 0.125
    desc2[noise] = rng.integers(0, levels, int(noise.sum()), dtype=np.uint8)
    return desc1, desc2


# (W, H, disp_max, grid mask, descriptors) of the matching pass: masks all,
# none and one bit in six set; random descriptors, constant ones (every SAD
# ties) and two byte levels (many ties); disp_max above the frame's width
MATCH_CASES = [
    (160, 120, 63, "random", "random"),
    (333, 101, 63, "all", "random"),
    (160, 120, 40, "none", "random"),
    (333, 101, 63, "random", "constant"),
    (333, 101, 50, "all", "levels2"),
    (160, 120, 200, "random", "random"),
]


def match_descriptors(H, W, kind, seed):
    """(16, H, W) uint8 pairs for the matching pass: "random" (true matches
    at disparities 9-13), "levels2" (the same with two byte levels) or
    "constant" (every byte 77: every SAD is 0; the texture test still
    passes)."""
    if kind == "constant":
        desc = np.full((16, H, W), 77, np.uint8)
        return desc, desc.copy()
    return descriptors(H, W, seed, levels=2 if kind == "levels2" else 256)


def grid_mask(kind, D, gh, gw, seed):
    """(D, gh, gw) bool candidate mask: "all", "none" or "random"."""
    if kind == "all":
        return np.ones((D, gh, gw), bool)
    if kind == "none":
        return np.zeros((D, gh, gw), bool)
    return np.random.default_rng(seed).random((D, gh, gw)) < 1 / 6


def plane_table(D):
    """(T, 4) float32 planes [a, b, c, a_other].  Every coefficient is a
    multiple of 1/4 but one a_other, so a u + b v + c is exact in float32
    at these sizes however it is rounded or fused."""
    rows = [
        # flat: window [0, R + 1]; [D - 2 - R, D - 1]; centre -1 (window
        # [0, R - 1]); centre -9 (empty window); centre D (window
        # [D - R, D - 1]); centre D + 9 (empty)
        (0.0, 0.0, 1.5, 0.0),
        (0.0, 0.0, D - 1.5, 0.0),
        (0.0, 0.0, -1.5, 0.0),
        (0.0, 0.0, -9.5, 0.0),
        (0.0, 0.0, D + 0.5, 0.0),
        (0.0, 0.0, D + 9.5, 0.0),
        # slanted: the centre sweeps through and past [0, D) along a row;
        # |a| >= 0.7 or |a_other| >= 0.7 switches the prior off
        (0.75, 0.0, -20.25, 0.0),
        (-0.75, 0.25, D - 3.75, 0.0),
        (0.25, -0.25, D / 2 + 0.25, 0.75),
        (0.5, 0.25, -10.5, -0.5),
        # |a_other| exactly float32(0.7): not < 0.7, prior off
        (0.0, 0.25, 7.25, 0.7),
        (-0.25, 0.0, D / 4 + 0.5, -0.25),
    ]
    return np.asarray(rows, np.float32)


def tri_ids(Ho, Wo, T, seed):
    """(Ho, Wo) int32 triangle ids in [0, T): patches of 7 rows by 11
    columns, one pixel in 20 outside every triangle (-1)."""
    rng = np.random.default_rng(seed)
    tid = ((np.arange(Ho)[:, None] // 7) * 3
           + np.arange(Wo)[None, :] // 11) % T
    tid[rng.random((Ho, Wo)) < 0.05] = -1
    return tid.astype(np.int32)


def match_inputs(W, H, disp_max, mask, desc, subsampling, grid_dims,
                 seed=0):
    """One matching case's inputs on the output lattice of its mode: the
    descriptors (desc1, desc2) and, for the left and the right pass, (tid,
    planes, grid mask); grid_dims is ElasParams.grid_dims(W, H)."""
    D = disp_max + 1
    Ho, Wo = (H // 2, W // 2) if subsampling else (H, W)
    gw, gh = grid_dims
    desc1, desc2 = match_descriptors(H, W, desc, seed + disp_max)
    planes = plane_table(D)
    passes = [(tri_ids(Ho, Wo, len(planes), seed + k), planes,
               grid_mask(mask, D, gh, gw, seed + 10 + k)) for k in (0, 1)]
    return desc1, desc2, passes


def lr_maps(H, W, scale, thr, seed):
    """(D1, D2) (H, W) float32 integer maps for the L/R check with warp
    scale `scale` (1, or 0.5 on the half lattice) and threshold thr.

    Rows 0-1: D1 warps exactly to column 0, then half a step or one step
    left of it (out of the row).  Rows 2-3: D2 warps exactly to column
    W - 1, then to column W.  Rows 4-6: D1 is 10 and D2 is 10 + thr, 10 +
    thr + 1 and 10 - thr (kept, dropped, kept, both ways).  The other rows
    are random disparities in [0, 40) with the codes -1 and -10."""
    rng = np.random.default_rng(seed)
    D1 = rng.integers(0, 40, (H, W)).astype(np.float32)
    D2 = rng.integers(0, 40, (H, W)).astype(np.float32)
    for D in (D1, D2):
        D[rng.random((H, W)) < 0.1] = -1.0
        D[rng.random((H, W)) < 0.05] = -10.0
    u = np.arange(W, dtype=np.float32)
    step = np.float32(1.0 / scale)          # d that moves the warp a column
    D1[0] = u * step
    D1[1] = u * step + 1.0
    D2[2] = (W - 1 - u) * step
    D2[3] = (W - u) * step
    for row, diff in ((4, thr), (5, thr + 1), (6, -thr)):
        D1[row] = 10.0
        D2[row] = 10.0 + diff
    return D1, D2
