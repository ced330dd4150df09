"""PGM (P5) image I/O, equivalent to the reference's loadPGM/savePGM
(src/common_includes/image.h:134-170).

A copy of stereovision_tpu/io/pgm.py, kept in the port so that it never
imports the JAX package."""

from __future__ import annotations

import re

import numpy as np


def load_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise ValueError(f"{path}: not a binary PGM (P5) file")
    # Parse header: magic, width, height, maxval, separated by whitespace,
    # with '#' comments allowed.
    pos = 2
    fields = []
    while len(fields) < 3:
        m = re.compile(rb"\s*(?:#[^\n]*\n)*\s*(\d+)").match(data, pos)
        if not m:
            raise ValueError(f"{path}: malformed PGM header")
        fields.append(int(m.group(1)))
        pos = m.end()
    width, height, maxval = fields
    pos += 1  # single whitespace after maxval
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM not supported")
    img = np.frombuffer(data, dtype=np.uint8, count=width * height, offset=pos)
    return img.reshape(height, width).copy()


def save_pgm(img: np.ndarray, path: str) -> None:
    if img.ndim != 2:
        raise ValueError("save_pgm expects a 2-D array")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())
