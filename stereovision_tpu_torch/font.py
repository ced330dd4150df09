"""Text for the viewer's overlays, drawn without cv2 (the machines the
port runs on may have no cv2 and no PIL).

Two tables, one for each size the overlays draw at: the label text
(FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1) and the FPS text (scale
0.7, thickness 2).  Each holds, for the printable ASCII characters 32 to
126, the advance and the descent below the baseline that OpenCV's
cv2.getTextSize gives them, the text height it gives every string, and
glyph bitmaps: the pixels cv2.putText draws at half intensity or more,
for every character (labels) or for those "FPS: %.2f" can print.  They
were read off OpenCV 5.0's text functions; tests/test_torch_viz_live.py
reads them off again and holds them equal, and holds text_size against
cv2.getTextSize on random strings.

text_size gives cv2.getTextSize's extents exactly; put_text draws the
bitmaps side by side at the advances, which is close to cv2.putText's
antialiased text but not equal to it.  A character outside the tables
takes the metrics and glyph of "?".
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

FIRST, LAST = 32, 126

# (scale, thickness) -> (text height, advances, descents, glyphs); a
# glyph line is: character code, the bitmap's left column and top row
# relative to the text origin (the baseline's left end), then its rows
# as hexadecimal bit masks (bit i: column i)
_TABLES = {
    (0.5, 1): (
        14,
        """
        3 3 5 10 9 11 10 3 9 9 6 9 3 7 3 7 9 9 9 9 9 9 9 9 9 9 3 4 7 8 7
        7 12 10 10 9 10 9 8 10 10 4 9 9 8 11 10 10 9 10 9 9 8 10 9 11 9
        9 8 4 7 4 6 11 5 8 8 8 8 8 5 8 9 3 3 7 3 13 9 8 8 8 5 7 5 9 8 12
        8 8 7 5 3 5 8""",
        """
        0 0 0 0 2 1 1 0 2 2 0 0 2 0 0 2 1 0 0 1 0 1 1 0 1 0 0 2 0 0 0 0
        2 0 0 1 0 0 0 1 0 0 1 0 0 0 0 1 0 1 0 1 0 1 0 0 0 0 0 3 2 3 0 1
        0 1 1 1 1 1 0 4 0 0 3 0 0 0 0 1 3 3 0 1 0 1 0 0 0 3 0 3 4 3 0""",
        """
        33 1 -10 3 3 3 3 3 3 3 0 1 3
        34 1 -11 1 d d 1
        35 1 -10 48 4c ff fe 64 24 ff 26 26
        36 1 -12 8 18 3e 63 1 3 1e 70 40 c1 63 3e 8
        37 1 -10 18f c9 49 29 36 1d8 368 224 146 1c2
        38 1 -11 8 3e 22 22 1e c 9a b1 e1 e3 1be
        39 1 -11 1 1 1 1
        40 3 -12 e 2 3 1 1 1 1 1 1 1 3 3 6 4
        41 3 -12 3 6 4 4 4 4 4 4 4 4 4 6 3 1
        42 1 -11 4 5 1f e a
        43 1 -8 8 8 8 ff 8 8 8
        44 1 -2 3 1 1
        45 1 -5 1f
        46 1 -2 3 3
        47 1 -12 20 10 10 18 8 c 4 4 6 2 3 1 1
        48 1 -11 8 3e 73 53 51 49 49 45 47 77 3e
        49 1 -10 1c 1e 1a 18 18 18 18 18 18 7f
        50 1 -11 8 3e 63 63 60 30 18 c 6 7 7f
        51 1 -10 7f 30 18 8 3c 60 40 41 63 3e
        52 0 -10 60 70 58 4c 44 46 1ff e0 40 40
        53 1 -10 7e 2 2 1f 77 40 40 41 63 3e
        54 1 -10 18 8 4 3e 67 43 c1 43 63 3c
        55 1 -10 7f 60 20 30 10 18 18 8 c 4
        56 1 -11 8 3e 63 43 63 3e 63 41 41 63 3e
        57 1 -11 8 3e 63 41 41 63 3e 30 18 8 4
        58 1 -7 3 3 0 0 0 3 3
        59 1 -7 3 3 0 0 0 3 3 1
        60 1 -8 18 c 3 1 7 c 18
        61 1 -7 3f 0 0 0 3f
        62 1 -9 1 3 c 18 30 18 e 3
        63 1 -11 c 3f 21 21 30 18 8 c 0 0 c
        64 1 -10 f8 186 202 2f1 2c9 6c9 6c9 2c9 1b3 2 18c 70
        65 0 -10 30 78 48 48 cc 84 1fe 1fe 102 303
        66 1 -10 7f c3 c3 c3 7f c3 c3 c3 c3 7f
        67 1 -11 18 7e c3 83 1 1 1 3 c3 e6 7c
        68 1 -10 7f c3 83 83 83 83 83 c3 e3 3f
        69 1 -10 7f 3 3 3 7f 3 3 3 3 7f
        70 1 -10 7f 3 3 3 7f 3f 3 3 3 3
        71 1 -11 10 7e c3 83 1 e1 e1 83 83 c6 3c
        72 1 -10 83 83 83 83 ff 83 83 83 83 83
        73 1 -10 3 3 3 3 3 3 3 3 3 3
        74 1 -10 7f 40 40 40 40 40 40 61 73 3e
        75 1 -10 63 33 1b f 7 f 1b 33 63 c3
        76 1 -10 3 3 3 3 3 3 3 3 3 7f
        77 1 -10 303 387 387 3cf 34b 37b 333 303 303 303
        78 1 -10 83 87 87 8b 9b 93 a3 e3 c3 c3
        79 1 -11 18 7e c3 c3 81 81 81 83 c3 66 3c
        80 1 -10 7f c3 c3 c3 e3 3f 3 3 3 3
        81 1 -11 18 7e c3 c3 81 81 81 83 c3 66 7c c0
        82 1 -10 7f 43 c3 c3 73 3f 23 63 c3 83
        83 1 -11 8 3e 63 3 3 1e 70 40 c1 63 3e
        84 0 -10 ff 10 10 10 10 10 10 10 10 10
        85 1 -10 83 83 83 83 83 83 83 c2 e6 7c
        86 1 -10 81 c3 43 42 66 26 24 3c 1c 18
        87 1 -10 201 201 333 333 132 16a 1ca 1ce 1ce 84
        88 1 -10 c3 62 36 1c 18 1c 34 66 43 c1
        89 1 -10 c1 43 66 24 3c 18 18 18 18 18
        90 1 -10 7f 60 30 18 18 c 6 2 3 7f
        91 1 -12 7 7 1 1 1 1 1 1 1 1 1 1 1 7
        92 1 -12 1 1 1 2 2 6 4 c 8 8 18 10 30
        93 1 -12 3 7 6 6 6 6 6 6 6 6 6 6 6 7
        94 2 -11 2 7
        95 1 -1 1ff 1ff
        96 1 -11 3 6
        97 1 -8 1e 33 20 3c 27 21 31 2f
        98 1 -11 1 3 3 1f 77 63 43 43 43 63 3f
        99 1 -8 1c 37 23 1 1 21 33 1e
        100 1 -10 60 60 6e 73 61 61 61 61 73 7e
        101 1 -8 1c 33 21 63 3f 1 23 1c
        102 0 -11 38 c 4 1f c 4 4 4 4 4 4
        103 1 -8 4e 73 61 61 61 61 73 7e 60 23 3e
        104 1 -11 1 3 3 3f 77 63 43 43 43 43 43
        105 1 -11 1 1 0 1 3 3 3 3 3 3 1
        106 0 -11 6 6 0 2 6 6 6 6 6 6 6 6 2 1
        107 1 -11 1 3 3 33 1b f 7 7 f 13 21
        108 1 -11 1 3 3 3 3 3 3 3 3 3 1
        109 1 -8 39d 677 463 423 423 423 423 421
        110 1 -8 1d 37 63 43 43 43 43 41
        111 1 -8 1c 37 63 61 61 61 33 1e
        112 1 -8 3d 77 63 43 43 43 63 3f 3 3 1
        113 1 -8 5e 77 61 61 61 61 73 7e 60 60 40
        114 1 -8 d f 3 3 3 3 3 1
        115 1 -8 e 33 1 7 1c 30 31 1e
        116 0 -11 4 4 4 1f e 4 4 4 4 c 18
        117 1 -8 41 61 61 61 61 63 63 7e
        118 1 -8 41 21 23 32 12 1e c c
        119 1 -8 231 231 231 37b 14a 1ce 1ce 84
        120 1 -8 21 33 1e c c 1e 33 21
        121 1 -8 41 21 23 32 16 1c c c 4 4 6
        122 1 -8 3f 38 18 c 4 2 3 3f
        123 1 -12 8 e 2 2 2 2 3 1 3 2 2 2 6 c
        124 1 -13 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1
        125 1 -11 3 2 6 6 6 4 c 4 6 6 6 2 3
        126 1 -5 3f"""),
    (0.7, 2): (
        19,
        """
        5 5 8 13 13 16 14 4 13 13 9 12 5 9 5 10 13 13 13 13 13 13 13 13
        13 13 5 5 10 11 10 11 17 14 14 14 14 12 12 14 14 6 13 13 11 16
        14 14 13 14 13 13 12 14 13 16 13 13 12 7 10 7 9 15 7 11 12 11 12
        11 8 12 12 5 5 11 5 18 12 12 12 12 8 11 9 12 11 16 11 11 11 8 5
        8 11""",
        """
        0 0 0 0 3 1 1 0 3 3 0 0 2 0 0 2 1 0 0 1 0 1 1 0 1 0 0 2 0 0 0 0
        3 0 0 1 0 0 0 1 0 0 1 0 0 0 0 1 0 2 0 1 0 1 0 0 0 0 0 4 2 4 0 2
        0 1 1 1 1 1 0 5 0 0 4 0 0 0 0 1 4 4 0 1 0 1 0 0 0 4 0 4 5 4 0""",
        """
        45 1 -7 ff 7f
        46 1 -3 7 7 7
        48 1 -14 1fc 3fe 7de 7cf 7c7 747 727 727 737 71f 79f 3fe 3fe 1f8
        49 1 -14 f0 f8 fe ff e6 e0 e0 e0 e0 e0 e0 7fe 7fe 7fe
        50 1 -14 1fc 3fe 3de 78f 786 380 3c0 1e0 f8 7c 3e 7ff 7ff 7ff
        51 1 -14 7fe 7fe 3c0 1c0 f0 78 3f8 7f8 780 700 707 7df 3fe 1fc
        52 0 -14 3c0 3c0 3e0 3f0 3b8 3b8 39c 38e ffe 1fff 1fff 380 380 380
        53 1 -14 3fe 3fe e e e 1fe 3fe 78e 700 700 70f 7df 3fe 1fc
        54 1 -14 e0 f0 78 38 7c 3fe 7fe 78f 707 707 70f 7de 3fe 1f8
        55 2 -14 3ff 3ff 3ff 1c0 1e0 e0 f0 70 70 78 38 3c 1c 1c
        56 1 -14 1fc 3fe 78e 707 70e 3fe 3fc 7fe 70f 707 707 78f 3fe 1fc
        57 1 -14 1fc 3fe 78f 707 707 707 78f 3fe 3fc 1e0 e0 70 78 38
        58 1 -10 f f 7 0 0 0 0 7 f 7
        70 2 -14 3ff 3ff 1ff 7 7 7 1ff 1ff 1ff 7 7 7 7 7
        80 2 -14 1ff 3ff 3c7 787 707 787 3ff 3ff ff 7 7 7 7 7
        83 1 -14 1fc 3fe 78f 707 f 3f 1fe 7f8 7c0 700 707 7df 3fe 1fc
        97 1 -11 78 fe 1ef 1c0 3e0 3fc 3cf 3c7 3c7 3ff 3be
        102 0 -15 1f0 1f8 38 3c fe ff fe 1c 1c 1c 1c 1c 1c 1c 18
        105 1 -15 7 7 7 0 6 7 7 7 7 7 7 7 7 7 7
        110 1 -11 e6 1ff 3ff 38f 78f 707 707 707 707 707 707"""),
}


@functools.lru_cache(maxsize=None)
def _font(scale: float, thickness: int):
    """The parsed table: (height, advances, descents, {char: (dx, dy,
    (rows, cols) bool bitmap)})."""
    if (scale, thickness) not in _TABLES:
        raise ValueError("no font table for scale %r, thickness %r (have %s)"
                         % (scale, thickness, sorted(_TABLES)))
    height, adv, desc, glyph_lines = _TABLES[scale, thickness]
    glyphs = {}
    for line in glyph_lines.split("\n"):
        if not line.strip():
            continue
        code, dx, dy, *rows = line.split()
        masks = [int(r, 16) for r in rows]
        cols = max(masks).bit_length()
        bitmap = np.array([[(m >> i) & 1 for i in range(cols)]
                           for m in masks], bool)
        glyphs[chr(int(code))] = (int(dx), int(dy), bitmap)
    return (height, [int(a) for a in adv.split()],
            [int(d) for d in desc.split()], glyphs)


def _index(c: str) -> int:
    code = ord(c)
    return code - FIRST if FIRST <= code <= LAST else ord("?") - FIRST


def text_size(text: str, scale: float,
              thickness: int) -> Tuple[Tuple[int, int], int]:
    """((width, height), baseline) of cv2.getTextSize(text,
    FONT_HERSHEY_SIMPLEX, scale, thickness): the advances' sum plus one,
    the table's height, the largest descent; ((0, 0), 0) for ""."""
    if not text:
        return (0, 0), 0
    height, adv, desc, _ = _font(scale, thickness)
    idx = [_index(c) for c in text]
    return (sum(adv[i] for i in idx) + 1, height), max(desc[i] for i in idx)


def put_text(img: np.ndarray, text: str, org: Sequence[int], scale: float,
             thickness: int, color) -> None:
    """Draw text into img in place, its baseline's left end at org = (x,
    y), clipped to the image: each character's bitmap at the pen, which
    moves on by the character's advance."""
    _, adv, _, glyphs = _font(scale, thickness)
    h, w = img.shape[:2]
    x, y = int(org[0]), int(org[1])
    for c in text:
        i = _index(c)
        g = glyphs.get(chr(FIRST + i))
        if g is not None:
            dx, dy, bitmap = g
            x0, y0 = x + dx, y + dy
            gh, gw = bitmap.shape
            # the bitmap's part inside the image
            ya, yb = max(0, -y0), min(gh, h - y0)
            xa, xb = max(0, -x0), min(gw, w - x0)
            if ya < yb and xa < xb:
                sub = bitmap[ya:yb, xa:xb]
                img[y0 + ya:y0 + yb, x0 + xa:x0 + xb][sub] = color
        x += adv[i]
