"""The port's live viewer (stereovision_tpu_torch/viz_live.py) held against
the JAX package's, on the CPU (device="cpu").

Every case of tests/test_viz_live.py, run against the port; then, on the
same seeded NumPy inputs in both packages:

  * Camera poses after the same key sequences: exact.
  * PointCloudRenderer.render: images equal.  The one exception allowed
    is a pixel near a point whose float64 u or v lies within 1e-9 of an
    integer in the JAX projection (NumPy's matmul may contract the
    rotation's products and sums where the port rounds each one); the
    random clouds here have none, and the tests assert that.
  * draw_detections: without cv2 in the port.  The box outlines and the
    label backgrounds are cv2's pixels, and font.text_size is
    cv2.getTextSize, exactly.  The text is the port's own glyphs: equal
    outside each text's box ([x - 1, x + width] x [y - height, y +
    baseline] around its origin; cv2's antialiased "j" reaches one column
    left of the origin), and inside the boxes the differing pixels are
    counted and bounded.
  * font.py's tables, read off cv2 again (they follow OpenCV 5.0's text
    functions; other versions' differ).
  * tracker_cubes; LiveViewer.show headless with record_dir (the same
    files, the cloud and disparity byte for byte, PNG through cv2 and PGM
    without it), for the cloud as fetch "host" gives it (coloured) and as
    fetch "dmap" gives it (depth-shaded); _pump_keys / close / _try_show
    with a stand-in cv2 module.
  * Importing the port's viz_live loads neither jax nor cv2.
"""

import dataclasses
import os.path as osp
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from stereovision_tpu import viz_live as J
from stereovision_tpu.models.bayesian import Detection as JDetection

from stereovision_tpu_torch import font
from stereovision_tpu_torch import viz_live as P
from stereovision_tpu_torch.models.bayesian import Detection

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FONT = cv2.FONT_HERSHEY_SIMPLEX


def _det(x=10, y=20, w=30, h=15, name="car", conf=0.9):
    return Detection(name=name, x=x, y=y, w=w, h=h, conf=conf,
                     r=1.0, g=0.5, b=0.0)


def _cams(**pose):
    return J.Camera(**pose), P.Camera(**pose)


def _renderers(*args, **kwargs):
    return (J.PointCloudRenderer(*args, **kwargs),
            P.PointCloudRenderer(*args, **kwargs, device="cpu"))


# ---- tests/test_viz_live.py, against the port -------------------------------

class TestOverlays:
    def test_draw_detections_burns_pixels(self):
        frame = np.zeros((100, 120, 3), np.uint8)
        out = P.draw_detections(frame, [_det()], fps=12.5)
        assert out.shape == frame.shape
        assert (out != frame).any()
        assert (frame == 0).all()            # input untouched
        # bottom box edge pixels carry the detection color (BGR of
        # r=1,g=.5,b=0); the top edge is under the label background
        assert out[35, 25].tolist() == [0, 127, 255]

    def test_fps_only(self):
        frame = np.zeros((60, 200, 3), np.uint8)
        out = P.draw_detections(frame, [], fps=30.0)
        assert (out[:, :, 1] > 0).any()      # green FPS text


class TestCamera:
    def test_default_looks_forward(self):
        cam = P.Camera()
        np.testing.assert_allclose(cam.forward(), [0, 0, 1], atol=1e-12)

    def test_wasd_moves(self):
        cam = P.Camera()
        z0 = cam.z
        assert cam.handle_key("w")
        assert cam.z > z0
        x0 = cam.x
        assert cam.handle_key("d")
        assert cam.x > x0
        y0 = cam.y
        assert cam.handle_key("r")
        assert cam.y < y0                     # up = -y (image frame)

    def test_yaw_changes_forward(self):
        cam = P.Camera()
        for _ in range(10):
            cam.handle_key("right")
        f = cam.forward()
        assert abs(f[0]) > 0.1                # rotated toward +x
        assert cam.handle_key("?") is False   # unknown key

    def test_pitch_clamped(self):
        cam = P.Camera()
        for _ in range(200):
            cam.handle_key("up")
        assert -1.5 <= cam.pitch <= 1.5


class TestRenderer:
    def test_points_rendered(self):
        r = P.PointCloudRenderer(160, 120, device="cpu")
        cam = P.Camera(z=-5.0)
        pts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
        img = r.render(pts, cam)
        assert img.shape == (120, 160, 3)
        assert (img > 12).any()               # points brighter than bg

    def test_zbuffer_near_wins(self):
        r = P.PointCloudRenderer(64, 64, device="cpu")
        cam = P.Camera(z=-5.0)
        pts = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 10.0]])
        colors = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
        img = r.render(pts, cam, colors=colors)
        assert img[32, 32].tolist() == [255, 0, 0]

    def test_nonfinite_and_behind_camera_skipped(self):
        r = P.PointCloudRenderer(64, 64, device="cpu")
        cam = P.Camera(z=-5.0)
        pts = np.array([[np.inf, 0, 0], [np.nan, 1, 1], [0, 0, -50.0]])
        img = r.render(pts, cam, draw_rings=False)
        assert (img == 12).all()              # nothing drawn

    def test_range_rings(self):
        r = P.PointCloudRenderer(128, 128, device="cpu")
        cam = P.Camera(y=-3.0, z=-5.0, pitch=0.4)
        img = r.render(np.zeros((0, 3)), cam)
        red = (img[..., 2] == 255) & (img[..., 0] == 0) & (img[..., 1] == 0)
        green = (img[..., 1] == 255) & (img[..., 2] == 0)
        assert red.sum() > 100                # ring points rasterized
        assert green.any()                    # origin marker
        off = r.render(np.zeros((0, 3)), cam, draw_rings=False)
        assert (off == 12).all()

    def test_cube_wireframe(self):
        r = P.PointCloudRenderer(128, 128, device="cpu")
        cam = P.Camera(z=-6.0)
        img = r.render(np.zeros((0, 3)), cam,
                       cubes=[{"center": (0, 0, 0), "size": (2, 2, 2),
                               "color": (0, 255, 255)}])
        ys, xs = np.nonzero((img[..., 1] == 255) & (img[..., 2] == 255))
        assert len(ys) > 20                   # edges rasterized

    def test_tracker_cubes(self):
        class Obj:
            name = "car"

        class Trk:
            objects = [Obj(), Obj()]
        cubes = P.tracker_cubes(Trk(), positions=np.array([[0, 0, 5.0],
                                                           [1, 1, 8.0]]))
        assert len(cubes) == 2
        assert cubes[1]["center"] == (1.0, 1.0, 8.0)
        assert cubes[0]["label"] == "car"
        assert cubes == J.tracker_cubes(Trk(), positions=np.array(
            [[0, 0, 5.0], [1, 1, 8.0]]))
        assert P.tracker_cubes(Trk()) == J.tracker_cubes(Trk())
        assert P.tracker_cubes(object()) == J.tracker_cubes(object()) == []


def _fake_out(h=48, w=64, seed=0):
    dmap = np.zeros((h, w), np.uint8)
    dmap[h // 2:, :] = 128
    pts = np.random.default_rng(seed).normal(0, 1, (h * w, 3))
    pts[:, 2] = np.abs(pts[:, 2]) + 2
    return {"dmap": dmap, "points": pts}


class TestLiveViewer:
    def test_headless_show_renders_all_windows(self, tmp_path):
        v = P.LiveViewer(view3d=True, width=96, height=64,
                         record_dir=str(tmp_path), device="cpu")
        v._display = False
        left = np.full((48, 64, 3), 40, np.uint8)
        rendered = v.show(_fake_out(), left, [_det(x=5, y=5, w=10, h=10)],
                          fps=9.0)
        assert set(rendered) == {"detections", "disparity", "cloud"}
        assert rendered["cloud"].shape == (64, 96, 3)
        files = sorted(p.name for p in tmp_path.iterdir())
        assert len(files) == 3 and files[0].startswith("cloud_000000")

    def test_camera_motion_applies_between_frames(self):
        v = P.LiveViewer(view3d=True, width=64, height=64, device="cpu")
        v._display = False
        out = _fake_out(32, 32)
        left = np.zeros((32, 32, 3), np.uint8)
        a = v.show(out, left)["cloud"]
        v.cam.handle_key("w")
        v.cam.handle_key("w")
        b = v.show(out, left)["cloud"]
        assert (a != b).any()


# ---- Camera -----------------------------------------------------------------

KEYS = ["w", "a", "s", "d", "r", "f", "left", "right", "up", "down", "i",
        "j", "k", "l", "?", "W", "x"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_poses_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jc, pc = _cams(x=float(rng.normal()), yaw=float(rng.normal()))
    for key in rng.choice(KEYS, 300):
        assert pc.handle_key(str(key)) == jc.handle_key(str(key))
        assert dataclasses.astuple(pc) == dataclasses.astuple(jc)
        np.testing.assert_array_equal(pc.rotation(), jc.rotation())
        np.testing.assert_array_equal(pc.forward(), jc.forward())
        np.testing.assert_array_equal(pc.right(), jc.right())


# ---- the renderer against the JAX package's ---------------------------------

def _near_integer(jr, pts, cam):
    """Points valid in the JAX projection whose float64 u or v lies within
    1e-9 of an integer: (their count, the pixels a point_px square at
    them may reach, one pixel of margin)."""
    p = np.asarray(pts, np.float64).reshape(-1, 3)
    with np.errstate(all="ignore"):
        rel = (p - [cam.x, cam.y, cam.z]) @ cam.rotation().T
        z = rel[:, 2]
        ok = np.isfinite(p).all(axis=1) & (z > 1e-3)
        u = jr.f * rel[:, 0] / z + jr.w / 2
        v = jr.f * rel[:, 1] / z + jr.h / 2
        near = ok & ((np.abs(u - np.round(u)) < 1e-9)
                     | (np.abs(v - np.round(v)) < 1e-9))
    mask = np.zeros((jr.h, jr.w), bool)
    r = max(jr.point_px, 1)
    near &= (np.abs(u) < 1e6) & (np.abs(v) < 1e6)      # can reach the image
    for uu, vv in zip(u[near].astype(np.int64), v[near].astype(np.int64)):
        mask[max(vv - 1, 0):max(vv + r + 1, 0),
             max(uu - 1, 0):max(uu + r + 1, 0)] = True
    return int(near.sum()), mask


def _assert_render_equal(jr, pr, pts, jc, pc, near_ok=False, **kw):
    """The two renders equal but near the JAX projection's near-integer
    points (none expected unless near_ok); returns the port's image."""
    want = jr.render(pts, jc, **kw)
    port_pts = pts
    if isinstance(pts, np.ndarray) and pts.ndim == 3:
        port_pts = torch.from_numpy(pts)
    got = pr.render(port_pts, pc, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    n_near, mask = _near_integer(jr, pts, jc)
    if not near_ok:
        assert n_near == 0
    diff = (got != want).any(axis=2)
    assert not (diff & ~mask).any(), int((diff & ~mask).sum())
    return got


def _cloud(rng, n):
    """n points in front of a camera at z = -5: many collide on a 64x48
    image, some lie behind it, a few are not finite."""
    pts = rng.normal(0, 1, (n, 3)) * [1.5, 1.0, 3.0] + [0, 0, 1]
    pts[rng.integers(0, n, n // 50)] = np.nan
    pts[rng.integers(0, n, n // 50), 0] = np.inf
    pts[rng.integers(0, n, n // 50), 2] = -20.0
    return pts


@pytest.mark.parametrize("point_px", [1, 2, 3])
@pytest.mark.parametrize("rings", [True, False])
@pytest.mark.parametrize("n", [1000, 20000])
def test_render_random_clouds_equal_jax(point_px, rings, n):
    rng = np.random.default_rng(n + point_px)
    pts = _cloud(rng, n)
    jr, pr = _renderers(64, 48, point_px=point_px)
    pose = dict(x=float(rng.normal(0, .3)), y=float(rng.normal(0, .3)),
                z=-5.0, yaw=float(rng.normal(0, .2)),
                pitch=float(rng.normal(0, .2)))
    img = _assert_render_equal(jr, pr, pts, *_cams(**pose), draw_rings=rings)
    # many points per pixel: the z-buffer decided
    assert (img != 12).any(axis=2).sum() > 200


@pytest.mark.parametrize("point_px", [1, 2])
def test_render_explicit_colors_equal_jax(point_px):
    rng = np.random.default_rng(7)
    pts = _cloud(rng, 5000)
    colors = rng.integers(0, 256, (5000, 3), dtype=np.uint8)
    jr, pr = _renderers(64, 48, point_px=point_px)
    _assert_render_equal(jr, pr, pts, *_cams(yaw=0.1, pitch=-0.05),
                         colors=colors)


def test_render_hw3_tensor_input_equal_jax():
    """An (H, W, 3) float32 cloud, as fetch "dmap" leaves it on the
    device, against the JAX renderer given the same array."""
    rng = np.random.default_rng(3)
    pts = _cloud(rng, 48 * 64).astype(np.float32).reshape(48, 64, 3)
    jr, pr = _renderers(64, 48)
    _assert_render_equal(jr, pr, pts, *_cams(y=-1.0, pitch=0.3))


def test_render_cubes_equal_jax():
    """Cuboids on top of a cloud, one off to the side and one behind the
    camera; labels drawn by cv2 in both (these tests import it)."""
    rng = np.random.default_rng(4)
    pts = _cloud(rng, 3000)
    cubes = [{"center": (0, 0, 2), "size": (1, 1, 1), "color": (0, 255, 255),
              "label": "car"},
             {"center": (2.5, 0.5, 6), "size": (2, 1, 3), "color": (255, 0, 0),
              "label": "person"},
             {"center": (0, 0, -30)}]
    jr, pr = _renderers(96, 64)
    img = _assert_render_equal(jr, pr, pts, *_cams(yaw=0.05), cubes=cubes)
    assert ((img[..., 1] == 255) & (img[..., 2] == 255)).sum() > 20


@pytest.mark.parametrize("pts", [
    np.zeros((0, 3)),
    np.array([[np.inf, 0, 0], [np.nan, 1, 1], [0, 0, -50.0]]),
    np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 10.0], [1.0, 0.0, 0.0],
              [0.0, 0.0, 0.0]]),
    # u or v just below 0 (kept as 0 by the int32 cast) and at w, h
    np.array([[-2.01, 0, 0], [-1.99, 0, 0], [1.99, 0, 0], [2.01, 0, 0],
              [0, -1.49, 0], [0, -1.51, 0], [0, 1.49, 0], [0, 1.51, 0]]),
    # far outside the int32 range after projection, and the overflow of
    # finite coordinates to inf in the rotation
    np.array([[1e300, 0, 0], [-1e300, 1e300, 0], [1e308, 1e308, 1e308]]),
], ids=["empty", "not-finite", "ties", "edges", "huge"])
@pytest.mark.parametrize("rings", [True, False])
def test_render_edge_cases_equal_jax(pts, rings):
    """Points exactly on pixel boundaries (near_ok: the camera's rotation
    is the identity, so both projections are exact), ties in depth
    (stable order: the later point wins), the projection's bounds."""
    jr, pr = _renderers(16, 12, fov_deg=90.0)
    _assert_render_equal(jr, pr, pts, *_cams(), near_ok=True,
                         draw_rings=rings)


def test_project_equals_jax():
    rng = np.random.default_rng(5)
    pts = _cloud(rng, 2000)
    jr, pr = _renderers(64, 48)
    jc, pc = _cams(x=0.3, yaw=0.2, pitch=-0.1)
    ju, jv, jz, jok = jr.project(pts, jc)
    pu, pv, pz, pok = (t.numpy() for t in pr.project(pts, pc))
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(pu[jok], ju[jok])
    np.testing.assert_array_equal(pv[jok], jv[jok])
    np.testing.assert_allclose(pz[jok], jz[jok], rtol=1e-15, atol=0)
    assert pu.dtype == pv.dtype == np.int32 and pz.dtype == np.float64


# ---- overlays ---------------------------------------------------------------

def _text_box(text, org, scale, thickness):
    """The box cv2's antialiased text stays inside: [x - 1, x + width] x
    [y - height, y + baseline] (inclusive)."""
    (tw, th), base = cv2.getTextSize(text, FONT, scale, thickness)
    return org[0] - 1, org[1] - th, org[0] + tw, org[1] + base


def _glyph_mask(shape, dets, fps):
    mask = np.zeros(shape[:2], bool)
    boxes = []
    for d in dets:
        label = "%s: %.2f" % (d.name, d.conf)
        th = cv2.getTextSize(label, FONT, 0.5, 1)[0][1]
        boxes.append(_text_box(label, (int(d.x), max(int(d.y), th + 2)),
                               0.5, 1))
    if fps is not None:
        boxes.append(_text_box("FPS: %.2f" % fps, (8, 24), 0.7, 2))
    for x0, y0, x1, y1 in boxes:
        mask[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = True
    return mask


def _random_dets(rng, h, w, k):
    names = ["car", "person", "jeep", "traffic light", "bus", "Q_x"]
    return [Detection(name=str(rng.choice(names)),
                      x=int(rng.integers(-20, w)), y=int(rng.integers(-20, h)),
                      w=int(rng.integers(0, w // 2)),
                      h=int(rng.integers(0, h // 2)),
                      conf=float(rng.random()), r=float(rng.random()),
                      g=float(rng.random()), b=float(rng.random()))
            for _ in range(k)]


def _overlay_diff(frame, dets, fps):
    """port and JAX draw_detections: (pixels differing outside the text
    boxes, differing inside them, the boxes' area)."""
    jd = [JDetection(**dataclasses.asdict(d)) for d in dets]
    want = J.draw_detections(frame, jd, fps=fps)
    got = P.draw_detections(frame, dets, fps=fps)
    assert got.shape == want.shape and got.dtype == want.dtype
    mask = _glyph_mask(frame.shape, dets, fps)
    diff = (got != want).any(axis=2)
    return int((diff & ~mask).sum()), int((diff & mask).sum()), \
        int(mask.sum())


@pytest.mark.parametrize("seed", range(4))
def test_draw_detections_equal_jax_outside_text(seed):
    """Boxes (thickness 2, some partly off the frame, overlapping) and
    label backgrounds exact; the text's pixels differ only inside its
    boxes (cv2 antialiases, the port's glyphs are cv2's pixels at half
    intensity or more), on fewer than 40 % of the boxes' pixels (1656,
    1986, 1997 and 2003 of 5491, 7224, 7223 and 6986 on these four
    frames: cv2 blends its glyphs' edges into the frame)."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (120, 200, 3), dtype=np.uint8)
    dets = _random_dets(rng, 120, 200, 6)
    fps = [None, 12.5, 1234.5678, 0.0][seed]
    outside, inside, area = _overlay_diff(frame, dets, fps)
    assert outside == 0
    assert inside < 0.4 * area


def test_draw_detections_label_text_is_cv2_thresholded():
    """On a white label background, the port's black glyph pixels are
    exactly the pixels where cv2's antialiased text is darker than half:
    one label at an origin whose text starts on a whole pixel."""
    frame = np.zeros((60, 160, 3), np.uint8)
    d = Detection(name="car", x=20, y=40, w=50, h=10, conf=0.5, r=1.0)
    got = P.draw_detections(frame, [d])
    want = J.draw_detections(frame, [JDetection(**dataclasses.asdict(d))])
    box = _text_box("car: 0.50", (20, 40), 0.5, 1)
    sl = np.s_[box[1]:box[3] + 1, box[0] + 1:box[2] + 1]
    dark_port = (got[sl] == 0).all(axis=2)
    dark_jax = want[sl].max(axis=2) < 128
    assert dark_port.sum() > 30
    assert int((dark_port != dark_jax).sum()) <= dark_port.sum() // 4


def test_draw_detections_needs_no_cv2(monkeypatch):
    """Without cv2 the JAX function raises at its first line; the port's
    draws the same boxes."""
    frame = np.zeros((60, 80, 3), np.uint8)
    want = P.draw_detections(frame, [_det()], fps=5.0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        J.draw_detections(frame, [], fps=5.0)
    np.testing.assert_array_equal(
        P.draw_detections(frame, [_det()], fps=5.0), want)


def test_rectangle_equals_cv2():
    """font-free parts of the overlay: cv2.rectangle's pixel set at
    thickness 1, 2 (the boxes) and filled (the label backgrounds), on
    random rectangles, swapped corners, points and lines, partly or
    wholly off the image, and far outside it."""
    rng = np.random.default_rng(0)
    cases = [((-100000, 3), (100000, 6)), ((5, 4), (5, 4)), ((8, 4), (3, 9))]
    for _ in range(600):
        h, w = (int(v) for v in rng.integers(5, 40, 2))
        p0 = (int(rng.integers(-10, w + 10)), int(rng.integers(-10, h + 10)))
        p1 = (p0[0] + int(rng.integers(-3, 4)), p0[1] + int(rng.integers(
            -3, 4))) if rng.random() < 0.3 else (
            int(rng.integers(-10, w + 10)), int(rng.integers(-10, h + 10)))
        cases.append((p0, p1))
    for k, (p0, p1) in enumerate(cases):
        for t in (1, 2, -1):
            want = np.zeros((24, 30, 3), np.uint8)
            cv2.rectangle(want, p0, p1, (1, 2, 3), t)
            got = np.zeros_like(want)
            P._rectangle(got, p0, p1, (1, 2, 3), t)
            np.testing.assert_array_equal(got, want, err_msg=str((p0, p1, t)))


CHARS = "".join(chr(c) for c in range(font.FIRST, font.LAST + 1))
FPS_CHARS = " -.0123456789:FPSafin"


def tabulate(scale, thickness, glyph_chars):
    """font.py's table for (scale, thickness), read off cv2: the height,
    each character's advance and descent, and the glyphs' bitmaps (cv2's
    pixels at half intensity or more) with their offsets."""
    w_x = cv2.getTextSize("x", FONT, scale, thickness)[0][0]
    height = cv2.getTextSize("x", FONT, scale, thickness)[0][1]
    adv = [cv2.getTextSize(c + "x", FONT, scale, thickness)[0][0] - w_x
           for c in CHARS]
    desc = [cv2.getTextSize(c, FONT, scale, thickness)[1] for c in CHARS]
    glyphs = {}
    for c in glyph_chars:
        img = np.zeros((80, 80), np.uint8)
        cv2.putText(img, c, (20, 40), FONT, scale, 255, thickness)
        ys, xs = np.nonzero(img >= 128)
        if len(xs):
            glyphs[c] = (int(xs.min()) - 20, int(ys.min()) - 40,
                         img[ys.min():ys.max() + 1,
                             xs.min():xs.max() + 1] >= 128)
    return height, adv, desc, glyphs


@pytest.mark.parametrize("key", [((0.5, 1), CHARS), ((0.7, 2), FPS_CHARS)],
                         ids=["label", "fps"])
def test_font_tables_are_cv2s(key):
    (scale, thickness), chars = key
    height, adv, desc, glyphs = font._font(scale, thickness)
    want = tabulate(scale, thickness, chars)
    assert (height, adv, desc) == want[:3]
    assert sorted(glyphs) == sorted(want[3])
    for c, (dx, dy, bitmap) in glyphs.items():
        wdx, wdy, wbitmap = want[3][c]
        assert (dx, dy) == (wdx, wdy), c
        np.testing.assert_array_equal(bitmap, wbitmap, err_msg=c)


@pytest.mark.parametrize("scale,thickness", [(0.5, 1), (0.7, 2)])
def test_text_size_equals_cv2(scale, thickness):
    rng = np.random.default_rng(int(scale * 10))
    texts = ["", "car: 0.93", "FPS: 1234.57", "jeep: 1.00", "~ _|"]
    texts += ["".join(rng.choice(list(CHARS), int(rng.integers(1, 30))))
              for _ in range(2000)]
    for s in texts:
        assert font.text_size(s, scale, thickness) == cv2.getTextSize(
            s, FONT, scale, thickness), repr(s)


# ---- LiveViewer -------------------------------------------------------------

def _viewers(tmp_path, **kw):
    jv = J.LiveViewer(record_dir=str(tmp_path / "jax"), **kw)
    pv = P.LiveViewer(record_dir=str(tmp_path / "port"), device="cpu", **kw)
    jv._display = pv._display = False
    return jv, pv


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("fetch", ["host", "dmap"])
@pytest.mark.parametrize("cv2_present", [True, False])
def test_live_viewer_records_jax_files(tmp_path, monkeypatch, fetch,
                                       cv2_present):
    """Three frames headless with record_dir: the same file names, the
    cloud and disparity files byte for byte (PNG through cv2, else PGM of
    the gray mean), the detections outside the text.  fetch "host"'s
    (H*W, 3) cloud is coloured from the left frame, fetch "dmap"'s
    (H, W, 3) cloud (a tensor in the port) is depth-shaded: the JAX
    package's rule, on the same shapes."""
    if not cv2_present:
        # as on a machine without cv2, but for the JAX package's overlay,
        # which cannot draw without it
        monkeypatch.setitem(sys.modules, "cv2", None)
        real = J.draw_detections

        def with_cv2(*args, **kwargs):
            sys.modules["cv2"] = cv2
            try:
                return real(*args, **kwargs)
            finally:
                sys.modules["cv2"] = None
        monkeypatch.setattr(J, "draw_detections", with_cv2)
    h, w = 48, 64
    jv, pv = _viewers(tmp_path, view3d=True, width=96, height=64)
    rng = np.random.default_rng(11)
    shots = {}
    for i in range(3):
        out = _fake_out(h, w, seed=i)
        left = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        dets = _random_dets(rng, h, w, 2)
        pout = dict(out)
        if fetch == "dmap":
            out["points"] = out["points"].reshape(h, w, 3)
            pout["points"] = torch.from_numpy(out["points"])
        jd = [JDetection(**dataclasses.asdict(d)) for d in dets]
        want = jv.show(out, left, jd, fps=20.0 + i)
        got = pv.show(pout, left, dets, fps=20.0 + i)
        assert sorted(got) == sorted(want) == ["cloud", "detections",
                                               "disparity"]
        for k in ("cloud", "disparity"):
            np.testing.assert_array_equal(got[k], want[k])
        mask = _glyph_mask(left.shape, dets, 20.0 + i)
        assert not ((got["detections"] != want["detections"]).any(axis=2)
                    & ~mask).any()
        shots[i] = got["cloud"]
    # the points' pixels that are not gray (the rings are red and green)
    img = shots[0].reshape(-1, 3)
    rings = (img == (0, 0, 255)).all(axis=1) | (img == (0, 255, 0)).all(axis=1)
    coloured = ~rings & (img != img[:, :1]).any(axis=1)
    assert coloured.any() == (fetch == "host")
    ext = "png" if cv2_present else "pgm"
    jf, pf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(pf) == sorted(jf) == sorted(
        "%s_%06d.%s" % (k, i, ext) for k in ("cloud", "detections",
                                             "disparity") for i in range(3))
    for name in pf:
        if not name.startswith("detections"):
            assert pf[name] == jf[name], name


def test_live_viewer_without_view3d_and_device_tensors(tmp_path):
    """view3d=False renders no cloud; under fetch "device" the dmap and
    the cloud are tensors, which the port reads where they lie."""
    jv, pv = _viewers(tmp_path, view3d=False, width=32, height=24)
    out = _fake_out(24, 32)
    got = pv.show({k: torch.from_numpy(v) for k, v in out.items()},
                  np.zeros((24, 32, 3), np.uint8))
    want = jv.show(out, np.zeros((24, 32, 3), np.uint8))
    assert sorted(got) == sorted(want) == ["detections", "disparity"]
    np.testing.assert_array_equal(got["disparity"], want["disparity"])
    np.testing.assert_array_equal(got["detections"], want["detections"])


class _StubCv2(types.ModuleType):
    """A stand-in cv2 with windows: imshow records (or raises), waitKey
    plays a key sequence."""

    def __init__(self, keys, imshow_fails=False):
        super().__init__("cv2")
        self.keys, self.imshow_fails = list(keys), imshow_fails
        self.shown, self.destroyed = [], 0

    def imshow(self, name, img):
        if self.imshow_fails:
            raise RuntimeError("no display")
        self.shown.append(name)

    def waitKey(self, delay):
        return self.keys.pop(0) if self.keys else -1

    def destroyAllWindows(self):
        self.destroyed += 1


def test_pump_keys_and_close_equal_jax(monkeypatch):
    """The same key codes (arrows 81-84, letters, unknown codes, q) move
    both cameras alike; q closes the windows once and ends the pump."""
    codes = [81, 82, 83, 84, ord("w"), ord("A"), ord("d"), ord("r"), 0, 300,
             0x10000 + ord("s"), ord("?"), ord("l"), ord("q"), ord("w")]
    results = {}
    for name, mod in (("jax", J), ("port", P)):
        stub = _StubCv2(codes)
        monkeypatch.setitem(sys.modules, "cv2", stub)
        monkeypatch.setenv("DISPLAY", ":0")
        v = (mod.LiveViewer(view3d=True) if mod is J
             else mod.LiveViewer(view3d=True, device="cpu"))
        assert v._display is None
        v._try_show("Detections", np.zeros((2, 2, 3), np.uint8))
        assert v._display is True and stub.shown == ["Detections"]
        trail = []
        for _ in codes:
            trail.append((v._pump_keys(), dataclasses.astuple(v.cam),
                          v._display, stub.destroyed))
        v.close()
        trail.append((v._display, stub.destroyed))
        results[name] = trail
    assert results["port"] == results["jax"]
    assert results["port"][13][0] is False     # q
    assert results["port"][-1] == (False, 1)


@pytest.mark.parametrize("env", [{}, {"DISPLAY": ":0"},
                                 {"WAYLAND_DISPLAY": "wayland-0"}])
def test_headless_decision_and_failing_imshow_equal_jax(monkeypatch, env):
    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    states = {}
    for name, mod in (("jax", J), ("port", P)):
        stub = _StubCv2([], imshow_fails=True)
        monkeypatch.setitem(sys.modules, "cv2", stub)
        v = (mod.LiveViewer(view3d=True) if mod is J
             else mod.LiveViewer(view3d=True, device="cpu"))
        first = v._display
        v._try_show("Disparity", np.zeros((2, 2, 3), np.uint8))
        states[name] = (first, v._display, v._pump_keys())
        v.close()
    assert states["port"] == states["jax"]
    assert states["port"][0] is (None if env else False)


def test_viz_live_imports_neither_jax_nor_cv2():
    code = ("import sys\n"
            "import stereovision_tpu_torch.viz_live\n"
            "import stereovision_tpu_torch.profiling\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'cv2',\n"
            "                                    'stereovision_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_renderer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.PointCloudRenderer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.LiveViewer()
