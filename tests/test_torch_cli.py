"""The port's user-facing surface held against the JAX package's.

process_frame in its three fetch modes (types, shapes, values) and its
dmap_t stamp; box_centroids
and object_positions (both cloud layouts, NaN where JAX has NaN);
StereoVision, with object tracking; and the command line (python -m
stereovision_tpu_torch), run in process with main(..., device="cpu")
beside the JAX package's main() on the same KITTI-layout directory: npz,
ply and top-view dumps and -P's PGMs byte for byte, the per-frame and
AVG_FPS lines, --batch, -o's detection lines (after the detections'
decision margins are asserted), live mode on a stand-in camera, the
viewer's flags (-g, --view3d, --record) with their recorded windows, and
the import hygiene of a CLI run.
"""

import dataclasses
import os
import os.path as osp
import re
import subprocess
import sys
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereovision_tpu.engine as jengine
import stereovision_tpu.models.elas as jelas
from stereovision_tpu import cli as jcli
from stereovision_tpu.models import yolo as jyolo
from stereovision_tpu.io.pgm import save_pgm as j_save_pgm
from stereovision_tpu.ops.reproject import box_centroids as j_box_centroids

from stereovision_tpu_torch import cli
from stereovision_tpu_torch import engine as pengine
from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.engine import (StereoEngine, StereoVision,
                                           bgr_to_gray)
from stereovision_tpu_torch.io.pgm import save_pgm
from stereovision_tpu_torch.models import yolo
from stereovision_tpu_torch.ops.reproject import box_centroids
from stereovision_tpu_torch.synthetic import darknet_weights, stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
W, H = 160, 120              # engine tests
CW, CH = 120, 80             # command-line tests
FRAMES = 3
LINE = re.compile(r"^\(FPS=\d+\.\d{6}\) \((\d+), (\d+)\) \(t_t=\d+\.\d{6}, "
                  r"dmap_t=\d+\.\d{6}, pc_t=\d+\.\d{6}\)$")
AVG = re.compile(r"^AVG_FPS=\d+\.\d{6}$")


def _port(jp):
    return params_from_dict(dataclasses.asdict(jp))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(port, ref):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        port.shape, ref.shape, port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


# ---- process_frame ----------------------------------------------------------

@pytest.fixture(scope="module")
def frame_pair():
    left, right, _ = stereo_pair(W, H, seed=1)
    with jengine.StereoEngine(CALIB, W, H, use_pallas=False) as je:
        refs = {f: je.process_frame(left, right, fetch=f)
                for f in ("host", "dmap", "device")}
    return left, right, refs


@pytest.mark.parametrize("fetch", ["host", "dmap", "device"])
def test_process_frame_fetch_modes_match_jax(frame_pair, fetch):
    """Under "host" NumPy dmap and (pc_h*pc_w, 3) points; under "dmap"
    NumPy dmap and the (pc_h, pc_w, 3) cloud left on the device; under
    "device" both left there: where JAX returns a jax.Array, the port
    returns a tensor of the same shape and values."""
    left, right, refs = frame_pair
    ref = refs[fetch]
    out = StereoEngine(CALIB, W, H, device="cpu").process_frame(
        left, right, fetch=fetch)
    for key in ("dmap", "points", "disparity"):
        if isinstance(ref[key], np.ndarray):
            assert isinstance(out[key], np.ndarray), key
        else:
            assert isinstance(ref[key], jax.Array)
            assert torch.is_tensor(out[key]), key
        _eq(out[key], ref[key])
    assert out["points"].shape == ((H * W, 3) if fetch == "host"
                                   else (H, W, 3))
    assert set(out["timings"]) == set(ref["timings"])


def test_process_frame_dmap_t_starts_after_gray(monkeypatch):
    """dmap_t, like the JAX engine's, leaves out the BGR -> gray
    conversion: t_t covers it, dmap_t and pc_t do not."""
    real = pengine.bgr_to_gray

    def slow(img):
        time.sleep(0.15)
        return real(img)
    monkeypatch.setattr(pengine, "bgr_to_gray", slow)
    left, right, _ = stereo_pair(W, H, seed=2)
    eng = StereoEngine(CALIB, W, H, device="cpu")
    for fetch in ("host", "dmap"):
        t = eng.process_frame(left, right, fetch=fetch)["timings"]
        assert t["t_t"] - t["dmap_t"] - t["pc_t"] >= 0.3, t
        assert t == eng.timings


# ---- box_centroids / object_positions -----------------------------------------

BOXES = np.array([[10, 10, 20, 20], [60, 40, 30, 30], [-5, -5, 500, 500],
                  [0, 0, 1, 1], [159, 119, 5, 5], [40, 30, 0, 7],
                  [150, 100, 40, 40]], np.int32)


def test_box_centroids_match_jax_on_finite_clouds(frame_pair):
    """A finite cloud: within rtol 1e-6 of JAX.  (The sum follows XLA:CPU's
    tree-reduction order, tree_sum_hw, and is in fact equal.)"""
    pts = np.asarray(frame_pair[2]["host"]["points"]).reshape(H, W, 3)
    fin = np.where(np.isfinite(pts), pts, 0).astype(np.float32)
    ref = np.asarray(j_box_centroids(jnp.asarray(fin), jnp.asarray(BOXES)))
    assert np.isfinite(ref).all()
    out = box_centroids(torch.as_tensor(fin), torch.as_tensor(BOXES))
    assert out.dtype == torch.float32 and out.shape == (len(BOXES), 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    eng = StereoEngine(CALIB, W, H, device="cpu")
    for points in (fin.reshape(-1, 3), fin, torch.as_tensor(fin)):
        pos = eng.object_positions(points, BOXES)
        assert isinstance(pos, np.ndarray) and pos.dtype == np.float32
        np.testing.assert_allclose(pos, ref, rtol=1e-6, atol=0)
    assert eng.object_positions(fin, np.zeros((0, 4), np.int32)).shape == (
        0, 3)


def test_box_centroids_nan_where_jax_has_nan(frame_pair):
    """A non-finite point outside every box makes inf * 0 = NaN in every
    box, as in JAX (kept: the port is held to its reference); and the
    engine's own cloud, which has invalid pixels, the same."""
    pts = np.asarray(frame_pair[2]["host"]["points"]).reshape(H, W, 3)
    fin = np.where(np.isfinite(pts), pts, 0).astype(np.float32)
    one = fin.copy()
    one[119, 0, 2] = np.inf                  # outside every box of BOXES[:2]
    eng = StereoEngine(CALIB, W, H, device="cpu")
    for cloud, boxes in ((one, BOXES[:2]), (pts, BOXES)):
        ref = np.asarray(j_box_centroids(jnp.asarray(cloud),
                                         jnp.asarray(boxes)))
        assert np.isnan(ref).any()
        for points in (cloud.reshape(-1, 3), torch.from_numpy(cloud.copy())):
            out = eng.object_positions(points, boxes)
            np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
            ok = ~np.isnan(ref)
            np.testing.assert_allclose(out[ok], ref[ok], rtol=1e-6, atol=0)


# ---- StereoVision -------------------------------------------------------------

def test_stereo_vision_matches_jax(capsys):
    left, right, _ = stereo_pair(W, H, seed=5)
    ref = jengine.StereoVision(width=W, height=H).generatePointCloud(
        left, right)
    ref_line = capsys.readouterr().out.strip()
    sv = StereoVision(width=W, height=H, device="cpu")
    out = sv.generatePointCloud(left, right)
    line = capsys.readouterr().out.strip()
    assert out.dtype == ref.dtype == np.float64
    assert out.shape == (W * H, 3)
    np.testing.assert_array_equal(out, ref)
    for text in (line, ref_line):
        m = LINE.match(text)
        assert m and m.groups() == (str(H), str(W)), text
    assert sv.last["dmap"].shape == (H, W)
    sv.close()
    del sv


def test_stereo_vision_object_tracking_is_refused(tmp_path, capsys):
    """A detector that cannot be built (a weights file that does not fit
    the cfg) is refused with a warning that names the fault; the frames
    are processed without detection, as in the JAX class."""
    bad = tmp_path / "bad.weights"
    bad.write_bytes(np.zeros(40, np.int32).tobytes())
    with pytest.warns(UserWarning, match="no detector.*ValueError"):
        sv = StereoVision(width=W, height=H, objectTracking=True,
                          YOLO_WEIGHTS=str(bad), device="cpu")
    assert sv.detector is None and sv.tracker is not None
    left, right, _ = stereo_pair(W, H, seed=5)
    sv.generatePointCloud(left, right)
    assert "objects" not in sv.last
    capsys.readouterr()
    sv.close()


@pytest.fixture(scope="module")
def yolo_files(tmp_path_factory):
    """A small yolov4-tiny cfg file (the built-in one at 160x160) and a
    synthesized weights file for it; no weights file is in the repo."""
    d = tmp_path_factory.mktemp("yolo")
    sections = yolo.builtin_yolov4_tiny_cfg()
    sections[0] = dict(sections[0], width="160", height="160")
    cfg = str(d / "small.cfg")
    with open(cfg, "w") as f:
        for sec in sections:
            f.write("[%s]\n" % sec["type"] + "".join(
                "%s=%s\n" % kv for kv in sec.items() if kv[0] != "type"))
    weights = str(d / "synth.weights")
    darknet_weights(weights, sections, seed=0)
    return cfg, weights


def assert_margins(files, frames):
    """Both packages' detectors on the frames: every decision of
    _rows_to_dets further from its threshold than the rows moved it."""
    j = jyolo.YoloV4Tiny.from_files(*files)
    p = yolo.YoloV4Tiny.from_files(*files, device="cpu")
    imgs = np.stack([jyolo._resize_bilinear(
        np.ascontiguousarray(f[..., ::-1]), j.size, j.size) for f in frames])
    ref = np.asarray(jnp.concatenate(
        j._fwd(jnp.asarray(imgs.astype(np.float32) / 255.0)), axis=1))
    got = p.rows(frames)
    for k, f in enumerate(frames):
        m = yolo.decision_margins(ref[k], got[k], f.shape[:2])
        assert min(m.values()) > 1, (k, m)
    return float(np.abs(got - ref)[..., 5:].max())


def test_stereo_vision_object_tracking_matches_jax(yolo_files, capsys):
    """objectTracking=True on 6 frames: the cloud bit for bit, and
    last["objects"] (detections, then the tracker's predicted boxes) equal
    to the JAX class's but for conf, within the rows' difference."""
    frames = [stereo_pair(W, H, seed=s)[:2] for s in (11, 12, 13) * 2]
    tol = assert_margins(yolo_files, [f[0] for f in frames[:3]])
    kw = dict(width=W, height=H, objectTracking=True,
              YOLO_CFG=yolo_files[0], YOLO_WEIGHTS=yolo_files[1])
    ref = jengine.StereoVision(**kw)
    sv = StereoVision(**kw, device="cpu")
    n_objects = 0
    for left, right in frames:
        _eq(sv.generatePointCloud(left, right),
            ref.generatePointCloud(left, right))
        got, want = sv.last["objects"], ref.last["objects"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            ta, tb = dataclasses.asdict(a), dataclasses.asdict(b)
            assert abs(ta.pop("conf") - tb.pop("conf")) <= tol
            assert ta == tb
        n_objects += len(got)
    assert n_objects > 0
    assert sv.tracker.mean_error == ref.tracker.mean_error
    assert sv.detector.device.type == "cpu"
    capsys.readouterr()
    sv.close()


def test_object_tracking_on_bgra_frames_raises_as_in_jax(yolo_files,
                                                         capsys):
    """A reference fault kept (ROADMAP Queue 3): with objectTracking the
    left frame goes to the detector as given, and a BGRA frame (what the C
    ABI passes) reaches the first convolution with 4 channels, which
    raises in both packages."""
    left, right, _ = stereo_pair(W, H, seed=5)
    bgra = [np.ascontiguousarray(np.concatenate(
        [f, np.full((H, W, 1), 255, np.uint8)], axis=-1)) for f in (left,
                                                                     right)]
    kw = dict(width=W, height=H, objectTracking=True,
              YOLO_CFG=yolo_files[0], YOLO_WEIGHTS=yolo_files[1])
    with pytest.raises(ValueError, match="4 // 1 != 3"):
        jengine.StereoVision(**kw).generatePointCloud(*bgra)
    sv = StereoVision(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="3 channels, but got 4"):
        sv.generatePointCloud(*bgra)
    capsys.readouterr()
    sv.close()


# ---- the command line ------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """FRAMES synthetic pairs at CW x CH in KITTI raw layout (cv2 PNGs)."""
    root = tmp_path_factory.mktemp("kitti")
    for cam in ("image_02", "image_03"):
        (root / cam / "data").mkdir(parents=True)
    for i in range(FRAMES):
        left, right, _ = stereo_pair(CW, CH, seed=40 + i)
        cv2.imwrite(str(root / "image_02" / "data" / f"{i:010d}.png"), left)
        cv2.imwrite(str(root / "image_03" / "data" / f"{i:010d}.png"), right)
    return str(root)


@pytest.fixture(scope="module")
def jax_main():
    """The JAX package's main(), with one JAX StereoEngine / ElasEngine
    made per constructor arguments and shared by this module's runs (each
    new one compiles)."""
    made = {}
    real = {"stereo": jengine.StereoEngine, "elas": jelas.ElasEngine}

    def shared(kind):
        def make(*args, **kwargs):
            key = (kind, args, tuple(sorted(kwargs.items(), key=str)),
                   repr(kwargs.get("params")))
            if key not in made:
                made[key] = real[kind](*args, **kwargs)
            return made[key]
        return make
    mp = pytest.MonkeyPatch()
    mp.setattr(jengine, "StereoEngine", shared("stereo"))
    mp.setattr(jelas, "ElasEngine", shared("elas"))
    yield jcli.main
    mp.undo()
    for eng in made.values():
        eng.close()


def _lines(text, n):
    lines = text.strip().splitlines()
    assert len(lines) == n + 1, lines
    for line in lines[:-1]:
        assert LINE.match(line), line
    assert AVG.match(lines[-1]), lines[-1]
    return lines


def _kitti_args(d, out, *extra):
    return ["-k", d, "-w", str(CW), "-ht", str(CH), "--out_dir", out,
            *extra]


@pytest.fixture(scope="module")
def npz_runs(kitti_dir, jax_main, tmp_path_factory):
    """--dump npz from both CLIs, full resolution and -s 1: their out
    dirs and stdout."""
    import contextlib
    import io
    runs = {}
    for mode, extra in (("full", []), ("sub", ["-s", "1"])):
        for name, run in (("port", lambda a: cli.main(a, device="cpu")),
                          ("jax", jax_main)):
            out = str(tmp_path_factory.mktemp(name + mode))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert run(_kitti_args(kitti_dir, out, "--dump", "npz",
                                       *extra)) == 0
            runs[name, mode] = (out, buf.getvalue())
    return runs


def _npz_equal(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir))
    assert names == ["frame_%06d.npz" % i for i in range(FRAMES)]
    for name in names:
        a, b = np.load(osp.join(a_dir, name)), np.load(osp.join(b_dir, name))
        assert a.files == b.files == ["dmap", "points"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", ["full", "sub"])
def test_cli_npz_matches_jax(npz_runs, mode):
    out, text = npz_runs["port", mode]
    ref_out, ref_text = npz_runs["jax", mode]
    _npz_equal(out, ref_out)
    shape = (CH, CW) if mode == "full" else (CH // 2, CW // 2)
    for lines in (_lines(text, FRAMES), _lines(ref_text, FRAMES)):
        for line in lines[:-1]:
            assert LINE.match(line).groups() == tuple(map(str, shape))
    d = np.load(osp.join(out, "frame_000000.npz"))
    assert d["dmap"].shape == shape and d["points"].shape == (CW * CH, 3)


def test_cli_batch_equals_unbatched(npz_runs, kitti_dir, tmp_path, capsys):
    """--batch 2 (stream_batched, a padded last batch) writes what the
    frame-by-frame loop writes."""
    out = str(tmp_path / "b")
    assert cli.main(_kitti_args(kitti_dir, out, "--dump", "npz", "--batch",
                                "2"), device="cpu") == 0
    _lines(capsys.readouterr().out, FRAMES)
    _npz_equal(out, npz_runs["port", "full"][0])


@pytest.mark.parametrize("dump", ["ply", "topview"])
def test_cli_dumps_match_jax(kitti_dir, jax_main, tmp_path, capsys, dump):
    args = ["--dump", dump, "--frames", "2"]
    out, ref = str(tmp_path / "p"), str(tmp_path / "j")
    assert cli.main(_kitti_args(kitti_dir, out, *args), device="cpu") == 0
    _lines(capsys.readouterr().out, 2)
    assert jax_main(_kitti_args(kitti_dir, ref, *args)) == 0
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(ref)) and len(names) == 2
    for name in names:
        assert open(osp.join(out, name), "rb").read() == \
            open(osp.join(ref, name), "rb").read(), name


def test_cli_no_dump_keeps_cloud_on_device(kitti_dir, monkeypatch, capsys):
    """No --dump: every frame through process_frame(fetch="dmap"), whose
    cloud stays a (pc_h, pc_w, 3) tensor."""
    seen = []
    real = StereoEngine.process_frame

    def spy(self, left, right, fetch="host"):
        out = real(self, left, right, fetch=fetch)
        seen.append((fetch, tuple(out["points"].shape),
                     torch.is_tensor(out["points"])))
        return out
    monkeypatch.setattr(StereoEngine, "process_frame", spy)
    assert cli.main(["-k", kitti_dir, "-w", str(CW), "-ht", str(CH)],
                    device="cpu") == 0
    _lines(capsys.readouterr().out, FRAMES)
    assert seen == [("dmap", (CH, CW, 3), True)] * FRAMES


def test_cli_preset_is_parsed_not_applied(kitti_dir, npz_runs, tmp_path,
                                          capsys):
    """As in the JAX CLI, --preset does not reach the engine; the port
    says so on stderr."""
    out = str(tmp_path / "r")
    assert cli.main(_kitti_args(kitti_dir, out, "--dump", "npz", "--frames",
                                "1", "--preset", "robotics"),
                    device="cpu") == 0
    err = capsys.readouterr().err
    assert "--preset robotics is parsed but not applied" in err
    a = np.load(osp.join(out, "frame_000000.npz"))
    b = np.load(osp.join(npz_runs["port", "full"][0], "frame_000000.npz"))
    np.testing.assert_array_equal(a["dmap"], b["dmap"])


@pytest.fixture(scope="module")
def profile_pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("profile")
    for name, seed in (("a", 50), ("b", 51)):
        left, right, _ = stereo_pair(CW, CH, seed=seed)
        save_pgm(bgr_to_gray(left), str(d / f"{name}_left.pgm"))
        save_pgm(bgr_to_gray(right), str(d / f"{name}_right.pgm"))
    j_save_pgm(bgr_to_gray(left), str(d / "lonely_left.pgm"))  # no right
    return str(d)


def test_cli_profile_matches_jax(profile_pairs, jax_main, tmp_path, capsys):
    out, ref = str(tmp_path / "p"), str(tmp_path / "j")
    assert cli.main(["-P", "--profile_dir", profile_pairs, "--out_dir", out],
                    device="cpu") == 0
    text = capsys.readouterr().out
    assert jax_main(["-P", "--profile_dir", profile_pairs, "--out_dir",
                     ref]) == 0
    assert text == capsys.readouterr().out
    assert text.splitlines()[-1] == "... done!"
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(ref)) == [
        "a_left_disp.pgm", "a_right_disp.pgm", "b_left_disp.pgm",
        "b_right_disp.pgm"]
    for name in names:
        data = open(osp.join(out, name), "rb").read()
        assert data == open(osp.join(ref, name), "rb").read(), name
        assert data.startswith(b"P5\n%d %d\n255\n" % (CW, CH))


def test_cli_profile_without_pairs(tmp_path, capsys):
    assert cli.main(["-P", "--profile_dir", str(tmp_path / "none"),
                     "--out_dir", str(tmp_path / "o")], device="cpu") == 0
    assert capsys.readouterr().out == "... done!\n"
    assert os.listdir(tmp_path / "o") == []


class _Camera:
    """A stand-in for cv2.VideoCapture: camera 0 (left) and 2 (right)
    deliver `frames` frames each (the left one more, read for the size),
    then nothing."""
    frames = 2

    def open(self, index):
        left, right, _ = stereo_pair(CW, CH, seed=60)
        self.queue = ([left] * (self.frames + 1) if index == 0
                      else [right] * self.frames)
        return True

    def grab(self):
        return bool(self.queue)

    def retrieve(self):
        return (True, self.queue.pop()) if self.queue else (False, None)


@pytest.mark.parametrize("swap", [False, True])
def test_run_live_on_stand_in_cameras(monkeypatch, capsys, swap):
    monkeypatch.setattr(cv2, "VideoCapture", _Camera)
    args = ["-ctu", "0"] + (["-sw"] if swap else [])
    assert cli.main(args, device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == _Camera.frames
    for line in lines:
        assert LINE.match(line).groups() == (str(CH), str(CW))


# the viewer's flag sets, each run with --record by both CLIs
VIEWER_FLAGS = {"g": ["-g"], "view3d": ["--view3d"],
                "g_view3d": ["-g", "--view3d"], "record": [],
                "view3d_sub": ["--view3d", "-s", "1"],
                "view3d_batch": ["--view3d", "--batch", "2"],
                "view3d_npz": ["--view3d", "--dump", "npz"],
                "view3d_o": ["--view3d", "-o"]}


def _spy_viewer(monkeypatch, viewer_cls, shown):
    """Record each show()'s detections and fps."""
    real = viewer_cls.show

    def show(self, out, left, detections=(), fps=None, cubes=None):
        shown.append((list(detections), fps, list(cubes or [])))
        return real(self, out, left, detections, fps=fps, cubes=cubes)
    monkeypatch.setattr(viewer_cls, "show", show)


def _glyph_boxes(shape, detections, fps):
    """The pixels of the detections window the text may reach: each text's
    box [x - 1, x + width] x [y - height, y + baseline] (cv2's
    antialiased text stays inside it)."""
    font = cv2.FONT_HERSHEY_SIMPLEX
    texts = [("%s: %.2f" % (d.name, d.conf), int(d.x), int(d.y), 0.5, 1)
             for d in detections]
    mask = np.zeros(shape[:2], bool)
    for text, x, y, scale, thick in texts + [("FPS: %.2f" % fps, 8, None,
                                              0.7, 2)]:
        (tw, th), base = cv2.getTextSize(text, font, scale, thick)
        y = 24 if y is None else max(y, th + 2)
        mask[max(y - th, 0):max(y + base + 1, 0),
             max(x - 1, 0):max(x + tw + 1, 0)] = True
    return mask


@pytest.mark.parametrize("name", list(VIEWER_FLAGS))
def test_cli_viewer_records_jax_files(kitti_dir, jax_main, yolo_files,
                                      tmp_path, monkeypatch, capsys, name):
    """-g / --view3d / --record, alone and with -s 1, --batch 2, --dump npz
    (fetch "host": the coloured cloud) and -o (detections, tracked, and
    their cubes; the synthetic frames' box means are not finite, so no
    cube edge lands on the image): the port's CLI and the JAX CLI side by
    side on a display-less host, each with --record.  Both exit 0 and
    record the same files; the cloud and disparity windows byte for byte;
    the detections window outside its text boxes, each run's boxes from
    the detections and fps its viewer was given."""
    from stereovision_tpu import viz_live as jviz_live
    from stereovision_tpu_torch import viz_live
    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    flags = list(VIEWER_FLAGS[name])
    if "-o" in flags:
        flags += ["-ycfg", yolo_files[0], "-yw", yolo_files[1]]
    shown = {"port": [], "jax": []}
    _spy_viewer(monkeypatch, viz_live.LiveViewer, shown["port"])
    _spy_viewer(monkeypatch, jviz_live.LiveViewer, shown["jax"])
    rec = {k: tmp_path / ("rec_" + k) for k in shown}
    assert cli.main(_kitti_args(kitti_dir, str(tmp_path / "p"), "--record",
                                str(rec["port"]), *flags),
                    device="cpu") == 0
    assert jax_main(_kitti_args(kitti_dir, str(tmp_path / "j"), "--record",
                                str(rec["jax"]), *flags)) == 0
    capsys.readouterr()
    windows = ["detections", "disparity"] + (
        ["cloud"] if "--view3d" in flags else [])
    names = sorted("%s_%06d.png" % (w, i) for w in windows
                   for i in range(FRAMES))
    assert sorted(os.listdir(rec["port"])) == names
    assert sorted(os.listdir(rec["jax"])) == names
    assert len(shown["port"]) == len(shown["jax"]) == FRAMES
    n_dets = 0
    for i, (port, ref) in enumerate(zip(shown["port"], shown["jax"])):
        assert [dataclasses.replace(d, conf=0) for d in port[0]] == [
            yolo.Detection(**dict(dataclasses.asdict(d), conf=0))
            for d in ref[0]]
        assert len(port[2]) == len(ref[2]) == len(port[0])
        n_dets += len(port[0])
        for w in windows:
            f = "%s_%06d.png" % (w, i)
            got = (rec["port"] / f).read_bytes()
            want = (rec["jax"] / f).read_bytes()
            if w != "detections":
                assert got == want, f
                continue
            a, b = (cv2.imread(str(rec[k] / f)) for k in ("port", "jax"))
            mask = (_glyph_boxes(a.shape, port[0], port[1])
                    | _glyph_boxes(b.shape, ref[0], ref[1]))
            assert not ((a != b).any(axis=2) & ~mask).any(), f
    assert (n_dets > 0) == ("-o" in flags)


FPS_LINE = re.compile(r"^\(FPS=[0-9.]+\) (\(\d+, \d+\)) \(t_t=[0-9.]+, "
                      r"dmap_t=[0-9.]+, pc_t=[0-9.]+\)$")
DET_LINE = re.compile(r"^  .+ conf=\d\.\d\d XYZ=\([^,]+,[^,]+,[^,]+\)$")


def _untimed(text):
    """stdout without its clocks: a frame line keeps its shape, AVG_FPS
    its name; the detection lines stay as printed."""
    out = []
    for line in text.splitlines():
        m = FPS_LINE.match(line)
        out.append("frame " + m.group(1) if m else
                   "AVG_FPS" if AVG.match(line) else line)
    return out


@pytest.mark.parametrize("batch", [[], ["--batch", "2"]])
def test_cli_object_track_matches_jax(kitti_dir, jax_main, yolo_files,
                                      capsys, batch):
    """-o with -ycfg / -yw: the detection lines under each frame's line
    equal the JAX CLI's as strings, frame by frame and with --batch 2 (the
    detection groups of 2, the last one padded), after the margins of the
    three frames' detections are asserted.  The synthetic frames have
    invalid pixels (their points are +-inf), so the XYZ printed is not
    finite, in both (ROADMAP Queue 3)."""
    frames = [cv2.imread(osp.join(kitti_dir, "image_02", "data",
                                  "%010d.png" % i)) for i in range(FRAMES)]
    assert_margins(yolo_files, frames)
    argv = ["-k", kitti_dir, "-w", str(CW), "-ht", str(CH), "-o", "-ycfg",
            yolo_files[0], "-yw", yolo_files[1], *batch]
    assert cli.main(argv, device="cpu") == 0
    got = capsys.readouterr().out
    assert jax_main(argv) == 0
    ref = capsys.readouterr().out
    assert _untimed(got) == _untimed(ref)
    dets = [DET_LINE.match(l) for l in got.splitlines() if DET_LINE.match(l)]
    assert len(dets) >= FRAMES
    assert _untimed(got)[-1] == "AVG_FPS"
    assert sum(l.startswith("frame ") for l in _untimed(got)) == FRAMES


def test_cli_object_track_collects_in_order(kitti_dir, yolo_files,
                                            monkeypatch, capsys):
    """The detection thread gets frames in groups of max(--batch, 1), the
    last group padded with its last frame; each frame's detections are
    the ones of that frame."""
    groups = []
    real = yolo.YoloV4Tiny.detect_batch

    def spy(self, frames, *args):
        groups.append([int(f.sum()) for f in frames])
        return real(self, frames, *args)
    monkeypatch.setattr(yolo.YoloV4Tiny, "detect_batch", spy)
    sums = [int(cv2.imread(osp.join(kitti_dir, "image_02", "data",
                                    "%010d.png" % i)).sum())
            for i in range(FRAMES)]
    for batch, want in ((0, [[s] for s in sums]),
                        (2, [sums[:2], [sums[2], sums[2]]])):
        groups.clear()
        assert cli.main(["-k", kitti_dir, "-w", str(CW), "-ht", str(CH),
                         "-o", "-ycfg", yolo_files[0], "-yw", yolo_files[1],
                         "--batch", str(batch)], device="cpu") == 0
        capsys.readouterr()
        assert groups == want


def test_cli_needs_a_source_and_the_card(monkeypatch, capsys, tmp_path):
    assert cli.main([], device="cpu") == 1
    assert "--kitti" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["-k", str(tmp_path)],
                 ["-P", "--profile_dir", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_module_help_runs():
    out = subprocess.run([sys.executable, "-m", "stereovision_tpu_torch",
                          "-h"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: stereovision_tpu_torch")
    for flag in ("--kitti", "--batch", "--dump", "--profile_dir", "-ctu"):
        assert flag in out.stdout


def test_cli_run_imports_no_jax(kitti_dir, yolo_files):
    """A run with -o loads no jax."""
    code = (
        "import sys\n"
        "from stereovision_tpu_torch import cli\n"
        "rc = cli.main(['-k', sys.argv[1], '-w', '%d', '-ht', '%d',\n"
        "               '--frames', '1', '-o', '-ycfg', sys.argv[2],\n"
        "               '-yw', sys.argv[3]], device='cpu')\n"
        "assert rc == 0\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'stereovision_tpu'))\n"
        "assert not bad, bad\n" % (CW, CH))
    out = subprocess.run([sys.executable, "-c", code, kitti_dir, *yolo_files],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert LINE.match(out.stdout.splitlines()[0])
