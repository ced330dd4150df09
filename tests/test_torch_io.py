"""The port's I/O and viz held against the JAX package.

PGM I/O; the PNG reader that _imread falls back to
without cv2 and PIL, against cv2.imread bit for bit on files written by
cv2.imwrite (gray, BGR, RGBA; compression 0 and 9, so that every row
filter appears), and its refusals; _imread's fallback chain and _resize's
fallback against jax.image.resize; KittiRawSequence and Kitti2015Scenes;
remap_frames; the packaged calibration rigs, byte for byte; and every viz
function, output for output.
"""

import builtins
import os
import os.path as osp
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereovision_tpu import viz as jviz
from stereovision_tpu.io import calibration as jcal
from stereovision_tpu.io import kitti as jkitti
from stereovision_tpu.io import pgm as jpgm

from stereovision_tpu_torch import viz as pviz
from stereovision_tpu_torch.io import calibration as pcal
from stereovision_tpu_torch.io import kitti as pkitti
from stereovision_tpu_torch.io import pgm as ppgm
from stereovision_tpu_torch.io.png import read_png

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_RIGS = osp.join(ROOT, "stereovision_tpu", "data", "calibration")
PORT_RIGS = osp.join(ROOT, "stereovision_tpu_torch", "data", "calibration")
RIGS = sorted(f for f in os.listdir(JAX_RIGS) if f.endswith(".yml"))


def _missing(monkeypatch, *names):
    """Make `import name` raise ImportError for each of names."""
    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.split(".")[0] in names:
            raise ImportError(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", fake)


# ---- PGM --------------------------------------------------------------------

def test_pgm_round_trip_and_jax_bytes(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 53), dtype=np.uint8)
    ppgm.save_pgm(img, str(tmp_path / "p.pgm"))
    jpgm.save_pgm(img, str(tmp_path / "j.pgm"))
    assert (tmp_path / "p.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()
    np.testing.assert_array_equal(ppgm.load_pgm(str(tmp_path / "p.pgm")), img)
    with pytest.raises(ValueError):
        ppgm.save_pgm(img[None], str(tmp_path / "x.pgm"))


def test_pgm_comment_header(tmp_path):
    path = str(tmp_path / "c.pgm")
    with open(path, "wb") as f:
        f.write(b"P5\n# a comment\n4 2\n# another\n255\n" + bytes(range(8)))
    out = ppgm.load_pgm(path)
    np.testing.assert_array_equal(out, jpgm.load_pgm(path))
    np.testing.assert_array_equal(out, np.arange(8, dtype=np.uint8)
                                  .reshape(2, 4))
    with open(path, "wb") as f:
        f.write(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError):
        ppgm.load_pgm(path)


# ---- PNG --------------------------------------------------------------------

def _image(shape, channels, seed):
    """Noise in the lower half, smooth ramps in the upper: libpng picks
    every row filter for such an image."""
    rng = np.random.default_rng(seed)
    full = shape + ((channels,) if channels > 1 else ())
    img = rng.integers(0, 256, full, dtype=np.uint8)
    top = shape[0] // 2
    img[:top] = np.cumsum(img[:top] // 32, axis=1).astype(np.uint8)
    return img


@pytest.mark.parametrize("level", [0, 9])
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (120, 160)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_matches_cv2(tmp_path, channels, shape, level):
    path = str(tmp_path / "t.png")
    img = _image(shape, channels, seed=channels * 10 + level)
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    # gray stays 2-D (as _imread's PIL branch returns it); colour is BGR
    # with the alpha dropped, as cv2.imread's default gives it
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED if channels == 1
                     else cv2.IMREAD_COLOR)
    out = read_png(path)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_png_images_use_every_row_filter(tmp_path):
    """The files of test_png_reader_matches_cv2 exercise all five row
    filters (so the reader's Sub, Up, Average and Paeth are all held)."""
    seen = set()
    for channels in (1, 3, 4):
        path = str(tmp_path / ("f%d.png" % channels))
        cv2.imwrite(path, _image((120, 160), channels, seed=channels * 10),
                    [cv2.IMWRITE_PNG_COMPRESSION, 0])
        data = open(path, "rb").read()
        pos, idat = 8, b""
        while pos < len(data):
            n, kind = struct.unpack(">I4s", data[pos:pos + 8])
            if kind == b"IDAT":
                idat += data[pos + 8:pos + 8 + n]
            pos += 12 + n
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
            120, -1)
        seen |= set(rows[:, 0].tolist())
    assert seen == {0, 1, 2, 3, 4}


def _png(path, width, height, depth, colour, interlace, payload):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                             depth, colour, 0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(payload))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["interlaced", "16-bit", "palette", "crc",
                                  "short"])
def test_png_reader_refuses(tmp_path, case):
    path = str(tmp_path / "bad.png")
    rows = b"".join(b"\0" + bytes(range(i, i + 4)) for i in range(2))
    if case == "interlaced":
        _png(path, 4, 2, 8, 0, 1, rows)
    elif case == "16-bit":
        _png(path, 2, 2, 16, 0, 0, rows)
    elif case == "palette":
        _png(path, 4, 2, 8, 3, 0, rows)
    elif case == "short":
        _png(path, 4, 3, 8, 0, 0, rows)
    else:
        _png(path, 4, 2, 8, 0, 0, rows)
        data = bytearray(open(path, "rb").read())
        data[-20] ^= 1                       # a byte of the IDAT payload
        open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        read_png(path)
    if case in ("interlaced", "16-bit"):
        _png(path, 4, 2, 8, 0, 0, rows)      # the same, valid, decodes
        np.testing.assert_array_equal(
            read_png(path), np.array([[0, 1, 2, 3], [1, 2, 3, 4]], np.uint8))


def test_imread_falls_back_to_pil_then_png(tmp_path, monkeypatch):
    path = str(tmp_path / "c.png")
    img = _image((30, 40), 3, seed=5)
    cv2.imwrite(path, img)
    _missing(monkeypatch, "cv2")
    np.testing.assert_array_equal(pkitti._imread(path), img)     # PIL
    _missing(monkeypatch, "cv2", "PIL")
    np.testing.assert_array_equal(pkitti._imread(path), img)     # read_png


@pytest.mark.parametrize("size", [(80, 60), (20, 15), (50, 45)])
def test_resize_fallback_against_jax(monkeypatch, size):
    """Without cv2, _resize grows an axis with jitted jax.image.resize's
    weights and order (ops.reproject.resize_linear) and shrinks one with
    its antialiased weights in float64.  Against JAX's fallback, which
    runs unjitted and truncates float32 to uint8: exact at 2x, each uint8
    within 1 elsewhere."""
    w, h = size
    img = np.random.default_rng(1).integers(0, 256, (30, 40, 3),
                                            dtype=np.uint8)
    ref = np.asarray(jax.image.resize(jnp.asarray(img, jnp.float32),
                                      (h, w, 3), "linear")).astype(np.uint8)
    _missing(monkeypatch, "cv2")
    out = pkitti._resize(img, w, h)
    assert out.shape == ref.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(int) - ref)
    if (w, h) == (80, 60):
        assert not diff.any()
    else:
        assert diff.max() <= 1


@pytest.fixture
def kitti_dir(tmp_path):
    rng = np.random.default_rng(2)
    for cam in ("image_02", "image_03"):
        d = tmp_path / cam / "data"
        d.mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(d / f"{i:010d}.png"),
                        rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    return str(tmp_path)


@pytest.mark.parametrize("size", [(None, None), (40, 30), (20, 15)])
def test_kitti_raw_sequence_matches_jax(kitti_dir, size):
    ref = jkitti.KittiRawSequence(kitti_dir, *size)
    seq = pkitti.KittiRawSequence(kitti_dir, *size)
    assert len(seq) == len(ref) == 3
    for (l, r), (jl, jr) in zip(seq.frames(), ref.frames()):
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(r, jr)
    assert len(list(seq.frames())) == 3


def test_kitti2015_scenes_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for cam in ("image_2", "image_3"):
        d = tmp_path / "testing" / cam
        d.mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(d / f"{i:06d}_10.png"),
                        rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    seq = pkitti.Kitti2015Scenes(str(tmp_path), width=20, height=15)
    ref = jkitti.Kitti2015Scenes(str(tmp_path), width=20, height=15)
    assert len(seq) == len(ref) == 2
    for i in range(2):
        for a, b in zip(seq[i], ref[i]):
            np.testing.assert_array_equal(a, b)


# ---- calibration --------------------------------------------------------------

@pytest.mark.parametrize("rig", RIGS)
def test_packaged_rig_equals_jax_copy_and_loads(rig):
    port, ref = osp.join(PORT_RIGS, rig), osp.join(JAX_RIGS, rig)
    assert open(port, "rb").read() == open(ref, "rb").read()
    r = pcal.rectification_from_yaml(port, 320, 240)
    j = jcal.rectification_from_yaml(ref, 320, 240)
    for k in ("Q", "P1", "P2", "R1", "R2", "XR", "XT"):
        np.testing.assert_array_equal(getattr(r, k), getattr(j, k))
    assert np.isfinite(r.Q).all()


def test_port_rigs_are_the_jax_rigs():
    assert sorted(f for f in os.listdir(PORT_RIGS)
                  if f.endswith(".yml")) == RIGS and len(RIGS) == 7


def test_remap_frames_matches_jax():
    rig = osp.join(PORT_RIGS, "kitti_2011_09_26.yml")
    rng = np.random.default_rng(4)
    left = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    rect = pcal.rectification_from_yaml(rig, 64, 48, compute_maps=True)
    jrect = jcal.rectification_from_yaml(
        osp.join(JAX_RIGS, "kitti_2011_09_26.yml"), 64, 48,
        compute_maps=True)
    out = pcal.remap_frames(left, right, rect)
    ref = jcal.remap_frames(left, right, jrect)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="without maps"):
        pcal.remap_frames(left, right,
                          pcal.rectification_from_yaml(rig, 64, 48))


# ---- viz --------------------------------------------------------------------

def _cloud(n=400, seed=6):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * [8, 8, 1.5]).astype(np.float32)
    pts[::37] = np.inf
    pts[5::41, 2] = 2e4
    return pts


def test_normalize_depth_and_top_view_match_jax():
    vals = np.linspace(0, 28, 50)
    np.testing.assert_array_equal(pviz.normalize_depth(vals, 0, 28.3),
                                  jviz.normalize_depth(vals, 0, 28.3))
    pts = _cloud()
    for kw in ({}, dict(x_range=(-10, 10), y_range=(-5, 5), z_range=(-2, 2),
                        scale=3)):
        out, ref = pviz.points_to_top_view(pts, **kw), \
            jviz.points_to_top_view(pts, **kw)
        assert out.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_colorize_disparity_matches_jax(monkeypatch, with_cv2):
    dmap = np.random.default_rng(7).integers(0, 256, (30, 40),
                                             dtype=np.uint8)
    dmap[::5] = 0
    if not with_cv2:
        _missing(monkeypatch, "cv2")
    np.testing.assert_array_equal(pviz.colorize_disparity(dmap),
                                  jviz.colorize_disparity(dmap))


@pytest.mark.parametrize("colors", [False, True])
def test_save_ply_and_npz_match_jax(tmp_path, colors):
    pts = _cloud()
    cols = (np.random.default_rng(8).integers(0, 256, pts.shape,
                                              dtype=np.uint8)
            if colors else None)
    pviz.save_ply(pts, str(tmp_path / "p.ply"), colors=cols, max_depth=1e4)
    jviz.save_ply(pts, str(tmp_path / "j.ply"), colors=cols, max_depth=1e4)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    pviz.save_npz(str(tmp_path / "p.npz"), points=pts)
    jviz.save_npz(str(tmp_path / "j.npz"), points=pts)
    a, b = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert a.files == b.files
    np.testing.assert_array_equal(a["points"], b["points"])
