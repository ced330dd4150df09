"""YOLOv4 in the port (stereovision_tpu_torch/models/yolo.py) held against
the plain darknet reference (depthbench/reference/darknet.py) on the CPU.

The built-in topology's counts and the packaged cfg; the convolutions'
work from depthbench/roofline_darknet.py; the rows of the port's forward
against the reference's on seeded weights, at the YOLOv4 topology with
every width divided by 8 and 3 classes at 96x96, and once at the published
widths at 64x64, within RTOL / ATOL; the detections equal where the
decision margins hold; [shortcut] and the four-way route against hand
sums; a section or activation that forward does not implement raises;
StereoVision(objectTracking=True) keeps the frame's rows and records the
detector's spans in the frame's id; the command line's -o runs YOLOv4.
"""

import dataclasses
import os.path as osp
import re

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depthbench import roofline_darknet
from depthbench.reference import darknet as ref_darknet
from stereovision_tpu_torch import cli
from stereovision_tpu_torch import profiling as P
from stereovision_tpu_torch.engine import StereoVision
from stereovision_tpu_torch.models import yolo
from stereovision_tpu_torch.models.yolo import YoloV4Tiny
from stereovision_tpu_torch.synthetic import darknet_weights, stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
# The port folds batch norm into its weights and runs F.conv2d; the
# reference applies batch norm unfolded after an im2col matmul: float32
# rounding in two orders through 110 layers.  Measured on the CPU: scores
# within 3.6e-7, boxes within 2.0e-6 relative (narrowed) and 1.1e-6 (the
# published widths at 64x64).  The reference in TF32 moves the scores by
# 1.4e-4 or more (asserted below), so these bounds would catch a forward
# computed in the precision below float32.
RTOL, ATOL = 2e-5, 2e-6
# the objectness shift of the narrowed tests' weights: 9 detections a
# frame at 96x96 with 3 classes, each decision far from flipping
SHIFT = -0.75
W, H = 160, 120


def narrowed(div=8, classes=3, size=96):
    """The built-in YOLOv4 with every width divided by `div` (the heads:
    3 * (5 + classes)) and `classes` classes, at size x size."""
    secs = yolo.builtin_yolov4_cfg()
    secs[0] = dict(secs[0], width=str(size), height=str(size))
    for s in secs[1:]:
        if s["type"] == "convolutional":
            f = int(s["filters"])
            s["filters"] = str(3 * (5 + classes) if f == 255 else f // div)
        elif s["type"] == "yolo":
            s["classes"] = str(classes)
    return secs


def files(d, name, secs, shift=SHIFT):
    cfg, weights = str(d / (name + ".cfg")), str(d / (name + ".weights"))
    yolo.write_darknet_cfg(cfg, secs)
    darknet_weights(weights, secs, seed=0, objectness_shift=shift)
    return cfg, weights


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The narrowed cfg and seeded weights as files."""
    return files(tmp_path_factory.mktemp("yolov4"), "narrow", narrowed())


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The published widths at 64x64: cfg and a seeded weights file."""
    return files(tmp_path_factory.mktemp("yolov4"), "full64",
                 narrowed(1, 80, 64), shift=-1.25)


def frames(seeds=(1, 2, 3)):
    return [stereo_pair(W, H, seed=s)[0] for s in seeds]


# ---- topology ---------------------------------------------------------------

def test_builtin_topology_counts(published):
    secs = yolo.builtin_yolov4_cfg()
    layers = secs[1:]
    types = [l["type"] for l in layers]
    acts = [l["activation"] for l in layers if l["type"] == "convolutional"]
    assert len(layers) == 162
    assert types.count("convolutional") == 110
    assert (acts.count("mish"), acts.count("leaky"),
            acts.count("linear")) == (72, 35, 3)
    assert types.count("shortcut") == 23
    assert types.count("maxpool") == 3 and types.count("upsample") == 2
    assert [i for i, t in enumerate(types) if t == "yolo"] == [139, 150, 161]
    assert [layers[i]["layers"] for i in (119, 129, 142, 153, 113)] == [
        "85", "54", "-1,-16", "-1,-37", "-1,-3,-5,-6"]
    assert [layers[i]["scale_x_y"] for i in (139, 150, 161)] == [
        "1.2", "1.1", "1.05"]
    shapes = ref_darknet.layer_shapes(secs)
    grids = [shapes[i][1] for i in (139, 150, 161)]
    assert grids == [76, 38, 19]
    assert sum(3 * g * g for g in grids) == 22743
    m = YoloV4Tiny(secs, device="cpu")
    assert m.counts == {"convs": 110, "shortcuts": 23, "routes": 21}
    assert sum(b.numel() for b in m.buffers()) == 64329949
    # the published widths' weights file (any [net] size) is consumed
    # exactly by the port and by the reference
    assert osp.getsize(published[1]) == 257717640
    YoloV4Tiny(secs, device="cpu").load_darknet_weights(published[1])
    ref_darknet.Darknet(published[0], published[1])


def test_packaged_cfg_is_the_builtin_one():
    path = osp.join(yolo.DATA_DIR, "yolov4.cfg")
    assert yolo.parse_darknet_cfg(path) == yolo.builtin_yolov4_cfg()
    assert ref_darknet.parse_cfg(path) == yolo.builtin_yolov4_cfg()


def test_roofline_darknet_work():
    w = roofline_darknet.work(yolo.builtin_yolov4_cfg())
    assert round(w["ops"] / 1e9, 2) == 128.39
    assert round(w["bytes"] / 1e9, 3) == 1.236
    assert round(w["bound_ms"], 3) == 1.916 and w["by"] == "operations"
    assert len(roofline_darknet.conv_work(yolo.builtin_yolov4_cfg())) == 110


# ---- the port against the reference ----------------------------------------

@pytest.mark.parametrize("which", ["narrowed", "published_widths"])
def test_rows_match_reference(small, published, which):
    cfg, weights = small if which == "narrowed" else published
    port = YoloV4Tiny.from_files(cfg, weights, device="cpu")
    ref = ref_darknet.Darknet(cfg, weights)
    size, classes = (96, 3) if which == "narrowed" else (64, 80)
    n_rows = 3 * sum(g * g for g in (size // 8, size // 16, size // 32))
    for left in frames((1, 2) if which == "narrowed" else (1,)):
        got, want = port.rows([left])[0], ref.rows(left)
        assert got.shape == want.shape == (n_rows, 5 + classes)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # the same reference in TF32 is outside these bounds
        low = ref.rows(left, tf32=True)
        assert not np.allclose(low, want, rtol=RTOL, atol=ATOL)


def test_detections_match_reference_after_margins(small):
    port = YoloV4Tiny.from_files(*small, device="cpu")
    ref = ref_darknet.Darknet(*small)
    n = 0
    for left in frames((1, 2, 3, 4)):
        got, want = port.rows([left])[0], ref.rows(left)
        m = yolo.decision_margins(want, got, left.shape[:2])
        assert min(m.values()) > 1, m
        dets = port.detect(left)
        want_dets = port._rows_to_dets(want, left.shape[:2], 0.5, 0.4)
        assert len(dets) == len(want_dets)
        for a, b in zip(dets, want_dets):
            ta, tb = dataclasses.asdict(a), dataclasses.asdict(b)
            assert abs(ta.pop("conf") - tb.pop("conf")) <= ATOL
            assert ta == tb
        n += len(dets)
    assert n > 0


# ---- sections -----------------------------------------------------------------

def _conv(f, k, act="linear"):
    return {"type": "convolutional", "filters": str(f), "size": str(k),
            "stride": "1", "pad": "1", "activation": act}


def test_shortcut_and_four_way_route_against_hand_sums(monkeypatch):
    """conv, conv, [shortcut] from=-2, then SPP's pattern: three stride-1
    max pools of the shortcut, each after a route back to it, and the
    four-way route -1,-3,-5,-6."""
    secs = [{"type": "net", "width": "12", "height": "12", "channels": "3"},
            _conv(4, 1), _conv(4, 3, "leaky"),
            {"type": "shortcut", "from": "-2", "activation": "linear"},
            {"type": "maxpool", "size": "3", "stride": "1"},
            {"type": "route", "layers": "-2"},
            {"type": "maxpool", "size": "5", "stride": "1"},
            {"type": "route", "layers": "-4"},
            {"type": "maxpool", "size": "7", "stride": "1"},
            {"type": "route", "layers": "-1,-3,-5,-6"},
            {"type": "yolo", "mask": "0", "anchors": "1,1", "classes": "1"}]
    m = YoloV4Tiny(secs, seed=3, device="cpu")
    assert m._layer_channels() == [4, 4, 4, 4, 4, 4, 4, 4, 16, 16]
    monkeypatch.setattr(m, "_decode_yolo", lambda x, l: x)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (1, 3, 12, 12), np.float32))
    with torch.no_grad():
        got, = m(x)
        a0 = F.conv2d(x, m.w0) + m.b0[:, None, None]
        a1 = F.conv2d(a0, m.w1, padding=1) + m.b1[:, None, None]
        a1 = torch.where(a1 > 0, a1, 0.1 * a1)
        s = a1 + a0
        pools = [F.max_pool2d(s, k, 1, padding=k // 2) for k in (3, 5, 7)]
        want = torch.cat([pools[2], pools[1], pools[0], s], dim=1)
    assert got.shape == (1, 16, 12, 12)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bad", [
    {"type": "dropout", "probability": "0.1"},
    dict(_conv(4, 1), activation="swish"),
    {k: v for k, v in _conv(4, 1).items() if k != "activation"},
    {"type": "shortcut", "from": "-1", "activation": "leaky"},
    {"type": "shortcut", "from": "-2", "activation": "linear"},
    {"type": "shortcut", "from": "-1", "activation": "linear",
     "weights_type": "per_feature"},
    dict(_conv(4, 3), groups="4"),
], ids=["section", "activation", "logistic_default", "shortcut_activation",
        "shortcut_channels", "shortcut_weights", "groups"])
def test_what_forward_does_not_implement_raises(bad):
    secs = [{"type": "net", "width": "8", "height": "8", "channels": "3"},
            _conv(8, 1), _conv(4, 1), bad]
    with pytest.raises(ValueError, match="not implemented"):
        YoloV4Tiny(secs, device="cpu")


# ---- the normal path ---------------------------------------------------------

def test_stereo_vision_keeps_rows_and_records_spans(small, capsys):
    sv = StereoVision(width=W, height=H, objectTracking=True,
                      YOLO_CFG=small[0], YOLO_WEIGHTS=small[1],
                      CAMERA_CALIBRATION_YAML=CALIB, device="cpu")
    pairs = [stereo_pair(W, H, seed=s)[:2] for s in (5, 6)]
    P.trace_drain()
    P.trace_start()
    try:
        for left, right in pairs:
            sv.generatePointCloud(left, right)
            np.testing.assert_array_equal(sv.last["rows"],
                                          sv.detector.rows([left])[0])
    finally:
        P.trace_stop()
    spans = P.trace_drain()["spans"]
    capsys.readouterr()
    sv.close()
    roots = [s for s in spans if s.name == "svtt.frame"]
    assert len(roots) == 2
    # the test's own rows() calls record their spans in no frame
    by_id = {s.id: s for s in spans}
    for fr in roots:
        mine = [s for s in spans if s.frame_id == fr.frame_id]
        det, = [s for s in mine if s.name == "svtt.detect"]
        trk, = [s for s in mine if s.name == "svtt.track"]
        assert det.parent is None and trk.parent is None
        kids = {s.name: s for s in mine if s.parent == det.id}
        assert set(kids) == {"svtt.detect.preprocess", "svtt.detect.forward",
                             "svtt.detect.fetch", "svtt.detect.decode"}
        assert kids["svtt.detect.forward"].counts == {
            "convs": 110, "shortcuts": 23, "routes": 21}
        assert kids["svtt.detect.fetch"].counts == {"bytes": 567 * 8 * 4}
        dec = kids["svtt.detect.decode"].counts
        assert dec["candidates"] > 0 and dec["detections"] > 0
        assert trk.counts["boxes"] == dec["detections"]
        assert "predicted" in trk.counts
        assert det.t0_ns >= fr.t1_ns
        for s in kids.values():
            assert by_id[s.parent] is det


def test_cli_object_track_runs_yolov4(small, tmp_path, capsys):
    for cam in ("image_02", "image_03"):
        (tmp_path / cam / "data").mkdir(parents=True)
    for i in range(2):
        left, right, _ = stereo_pair(120, 80, seed=40 + i)
        cv2.imwrite(str(tmp_path / "image_02" / "data" / f"{i:010d}.png"),
                    left)
        cv2.imwrite(str(tmp_path / "image_03" / "data" / f"{i:010d}.png"),
                    right)
    argv = ["-k", str(tmp_path), "-w", "120", "-ht", "80", "-o", "-ycfg",
            small[0], "-yw", small[1]]
    assert cli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    dets = [l for l in out if re.match(r"^  .+ conf=\d\.\d\d XYZ=", l)]
    assert len(dets) >= 2
    assert out[-1].startswith("AVG_FPS=")
