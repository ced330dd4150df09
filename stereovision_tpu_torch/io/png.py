"""A PNG reader in the standard library and NumPy, for machines that have
neither cv2 nor PIL (io.kitti._imread falls back to it).

It reads what KITTI ships and what cv2.imwrite writes: 8-bit samples,
no interlacing, colour types 0 (gray), 2 (RGB) and 6 (RGBA), any of the
five row filters.  It returns what cv2.imread returns for such a file,
BGR with the alpha dropped, except that a gray image stays 2-D.  Anything
else (16-bit samples, a palette, gray with alpha, Adam7 interlacing, a
chunk whose CRC fails, a short or long image stream) raises ValueError:
it never returns pixels it did not decode exactly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}      # colour type -> samples a pixel


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 4:pos + 8 + n]
        if len(body) != n + 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body) != crc:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        yield kind, body[4:]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(ftype: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Undo the row filters: rows (H, W, C) uint8 filtered samples, ftype
    (H,) their filter types.  Sample (r, x) needs (r, x-1), (r-1, x) and
    (r-1, x-1) decoded, so the pixels of one anti-diagonal r + x = k are
    independent of each other: the loop walks the H + W - 1 diagonals and
    decodes each one's pixels, every row's filter at once."""
    H, W, C = rows.shape
    if not ftype.any():
        return rows
    out = np.zeros((H + 1, W + 1, C), np.int32)   # a zero row and column
    raw = rows.astype(np.int32)
    for k in range(H + W - 1):
        r = np.arange(max(0, k - W + 1), min(H, k + 1))
        x = k - r
        a = out[r + 1, x]           # left
        b = out[r, x + 1]           # up
        c = out[r, x]               # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftype[r][:, None], [np.zeros_like(a), a, b,
                                             (a + b) >> 1, paeth])
        out[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced gray, RGB or RGBA PNG -> (H, W)
    uint8 gray or (H, W, 3) uint8 BGR."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, method, filt, interlace = header
    if depth != 8 or colour not in CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour} "
                         "not supported (8-bit gray, RGB or RGBA only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG not supported")
    if method or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    C = CHANNELS[colour]
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if stream.size != height * (1 + width * C):
        raise ValueError(f"{path}: image data holds {stream.size} bytes, "
                         f"expected {height * (1 + width * C)}")
    stream = stream.reshape(height, 1 + width * C)
    ftype = stream[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown row filter type")
    img = _unfilter(ftype, stream[:, 1:].reshape(height, width, C))
    # np.array copies: a writable, C-ordered array, as cv2.imread returns
    return np.array(img[..., 0] if C == 1 else img[..., 2::-1])
