"""The cell kitti_yolov4.detect on the CPU: its configuration, mix, driver
(StereoVision with objectTracking=True), readings and metric files through
run_cell, with YOLOv4 narrowed (every width divided by 8, 3 classes) at
96x96 and 160x120 frames through overrides; correct when sound, and not
correct with the detector's rows moved, its suppression left out or the
tracker's boxes moved; the readings' controls above their limits; the
metric files on the record."""

import os
import time

import numpy as np
import pytest

from depthbench import check, control, harness, lookup, program
from stereovision_tpu_torch.models import bayesian, yolo

CELL = "kitti_yolov4.detect"
# the readers the cell shares with kitti_full.live, then its own
LIVE = ("frame_ms_p95.live", "host_mid_ms.live", "launches_per_frame.live",
        "cloud_fetch_ms.live", "kernels_roofline.live", "device_idle.live",
        "host_filters_ms.live", "host_delaunay_ms.live",
        "host_raster_ms.live", "host_span_code_ms.live",
        "stage_a_device_ms.live", "stage_b_device_ms.live")
DETECT = ("detect_ms.detect", "detect_post_ms.detect",
          "detect_device_ms.detect", "detect_roofline.detect",
          "detect_mfu.detect")
# what a traced run reads on the CPU: no device trace
ON_CPU = {"frame_ms_p95.live", "host_mid_ms.live", "cloud_fetch_ms.live",
          "host_filters_ms.live", "host_delaunay_ms.live",
          "host_raster_ms.live", "host_span_code_ms.live",
          "detect_ms.detect", "detect_post_ms.detect", "detect_mfu.detect"}
READINGS = ["dmap_px", "points_rel", "det_score_abs", "det_box_px",
            "det_objects"]


@pytest.fixture(scope="module")
def overrides(tmp_path_factory):
    """160x120 frames and the narrowed YOLOv4 at 96x96, its weights with
    the objectness shift at which a frame has detections."""
    secs = yolo.builtin_yolov4_cfg()
    secs[0] = dict(secs[0], width="96", height="96")
    for s in secs[1:]:
        if s["type"] == "convolutional":
            f = int(s["filters"])
            s["filters"] = str(24 if f == 255 else f // 8)
        elif s["type"] == "yolo":
            s["classes"] = "3"
    cfg = str(tmp_path_factory.mktemp("yolov4") / "narrow.cfg")
    yolo.write_darknet_cfg(cfg, secs)
    return {"width": 160, "height": 120, "trace_start": 2,
            "trace_frames": 3, "yolo_cfg": cfg, "objectness_shift": -0.75}


def _run(overrides, traced, seed, recs=None):
    return harness.run_cell(CELL, seed, 1.5, traced, time.perf_counter(),
                            device="cpu", overrides=dict(overrides),
                            log=lambda s: None,
                            on_record=None if recs is None else recs.append)


def test_the_cell_is_declared():
    bench = harness.load_bench()
    c = harness.resolve(CELL, bench)
    assert c["workload"]["chips"] == 1
    assert c["config"]["reduced"] == [] and c["traffic"]["entry"] == \
        "stereo_vision"
    assert [m["name"] for m in c["end_to_end"]] == ["frame_ms", "setup_s"]
    assert [m["name"] for m in c["per_layer"]] == list(LIVE + DETECT)
    assert list(check.limits_of(c["config"])) == READINGS
    entry, = [x for x in bench["configs"] if x["name"] == "kitti_yolov4"]
    assert entry["reduced"] == []


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("moved", [None, "scores", "boxes"])
def test_the_cell_runs_and_checks_the_rows(overrides, monkeypatch, traced,
                                           moved):
    """Sound: every reading under its limit.  With the served rows moved
    (a score by 1e-3, a box centre by half a pixel of the frame), the
    reading of those columns is over its limit and the run not correct."""
    if moved:
        real = yolo.YoloV4Tiny.rows

        def rows(self, frames):
            out = real(self, frames)
            if moved == "scores":
                out[:, 7, 4] += 1e-3
            else:
                out[:, 7, 0] += 0.5 / 160
            return out
        monkeypatch.setattr(yolo.YoloV4Tiny, "rows", rows)
    r = _run(overrides, traced, 2**33 + 11)
    checks = r["checks"]
    assert checks["dmap_px"]["value"] == 0
    assert checks["points_rel"]["value"] == 0
    reading = {"scores": "det_score_abs", "boxes": "det_box_px"}.get(moved)
    for name in ("det_score_abs", "det_box_px", "det_objects"):
        over = checks[name]["value"] > checks[name]["limit"]
        assert over is (name == reading), (name, checks)
    assert r["correct"] is (moved is None)
    if traced:
        # on the CPU no device op: the host's spans and clock read
        assert set(r["metrics"]) == ON_CPU
    else:
        assert set(r["metrics"]) == {"frame_ms", "setup_s"}


def _in_row_order(boxes, scores, thr):
    return sorted(_real_nms(boxes, scores, thr))


def _moved_predictions(self):
    boxes = _real_predictions(self)
    for b in boxes:
        b.x += 1
    return boxes


_real_predictions = bayesian.BayesianTracker.get_predicted_boxes
_real_nms = yolo._nms


@pytest.mark.parametrize("fault", ["row_order", "tracker"])
def test_det_objects_finds_a_fault_after_the_rows(overrides, monkeypatch,
                                                  fault):
    """The rows sound, the served objects not: each class's detections in
    row order in place of falling score, or each predicted box one pixel to
    the right.  Only det_objects reads over its limit."""
    if fault == "row_order":
        monkeypatch.setattr(yolo, "_nms", _in_row_order)
    else:
        monkeypatch.setattr(bayesian.BayesianTracker,
                            "get_predicted_boxes", _moved_predictions)
    r = _run(overrides, False, 2**33 + 12)
    checks = r["checks"]
    for name in READINGS:
        over = checks[name]["value"] > checks[name]["limit"]
        assert over is (name == "det_objects"), (name, checks)
    assert r["correct"] is False


def test_controls_exceed_the_limits(overrides):
    """control.py on the configuration: the lower readings from run_cell,
    the upper ones from each detector reading's control (the reference with
    TF32 for the rows, its boxes rounded for the objects), above the
    limits."""
    r = control.readings("kitti_yolov4", [2**34 + 5], [2**34 + 6], 1.0,
                         device="cpu", bench=harness.load_bench(),
                         overrides=dict(overrides), log=lambda s: None)
    s = control.summarize(r)
    limits = check.limits_of(harness.resolve(CELL)["config"])
    low = s["lower"][CELL]
    for n in ("det_score_abs", "det_box_px"):
        assert low[n] < limits[n] < s["upper"][n], (n, low, s["upper"])
    assert low["det_objects"] == limits["det_objects"] == 0
    assert s["upper"]["det_objects"] >= 1


def _read(name, rec):
    return lookup.load_module("metrics", name).read(rec)


def test_the_metric_files_read_the_record(overrides):
    recs = []
    r = _run(overrides, True, 2**35 + 1, recs)
    rec, = recs
    assert r["correct"]
    assert _read("detect_ms.detect", rec) > _read("detect_post_ms.detect",
                                                  rec) > 0
    assert _read("detect_ms.detect", rec) == pytest.approx(
        program.span_ms(rec, "svtt.detect"))
    for n in ("detect_device_ms.detect", "detect_roofline.detect",
              "launches_per_frame.live"):
        assert _read(n, rec) is None, n
    # the readers shared with kitti_full.live on the host's spans
    for n in ("host_mid_ms.live", "host_delaunay_ms.live",
              "cloud_fetch_ms.live", "frame_ms_p95.live"):
        assert _read(n, rec) > 0, n
    # the device readers on a profiled stretch's record
    rec["trace"] = {"frames": 16, "launch_calls": 32000,
                    "stage_device_s": {"svtt.detect.forward": 0.16,
                                       "svtt.detect.preprocess": 0.004,
                                       "svtt.stage_b": 0.06, "": 0.01}}
    rec["config"] = dict(rec["config"], yolo_cfg=os.path.join(
        "stereovision_tpu_torch", "data", "yolo", "yolov4.cfg"))
    assert _read("detect_device_ms.detect", rec) == pytest.approx(10.25)
    assert _read("detect_roofline.detect", rec) == pytest.approx(
        100 * 1.9162609327761195 / 10.0)
    assert _read("launches_per_frame.live", rec) == 2000
    frame_s = rec["window_s"] / rec["frames"]
    assert _read("detect_mfu.detect", rec) == pytest.approx(
        100 * 128389482496.0 / (frame_s * 67e12))
    # a program without the detector's spans reads nothing
    rec["program"] = dict(rec["program"], spans=[
        s for s in rec["program"]["spans"]
        if not s.name.startswith(("svtt.detect", "svtt.track"))])
    assert _read("detect_ms.detect", rec) is None
    assert _read("detect_post_ms.detect", rec) is None
    assert np.isfinite(_read("frame_ms", rec))


def _crowded_rows(seed, n=600, nc=6):
    """Rows with many candidates a class, overlapping boxes, exact score
    ties and boxes of zero width."""
    rng = np.random.default_rng(seed)
    rows = np.empty((n, 5 + nc), np.float32)
    rows[:, 0:2] = rng.random((n, 2))
    rows[:, 2:4] = rng.random((n, 2)) * 0.3
    rows[::37, 2] = 0.0
    rows[:, 4] = rng.random(n)
    rows[:, 5:] = rng.random((n, nc))
    rows[5:40:7, 5] = rows[5, 5]
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_the_reference_decode_holds_the_ports(seed):
    """reference/darknet.py on crowded rows: it agrees with the port's
    detections, which may order equal scores otherwise than its own, and
    with its own; not with one left out, two of unequal score swapped, or
    boxes rounded."""
    from depthbench import detector
    from depthbench.reference import darknet
    rows, names = _crowded_rows(seed), ["c0", "c1", "c2", "c3"]
    port = yolo.YoloV4Tiny.__new__(yolo.YoloV4Tiny)
    port.class_names = names
    for hw in ((375, 1242), (80, 120)):
        got = detector.objects(port._rows_to_dets(rows, hw, 0.5, 0.4))
        mine = darknet.detections(rows, hw, names)
        assert sorted(got) == sorted(mine)
        assert darknet.agrees(got, rows, hw, names)
        assert darknet.agrees(mine, rows, hw, names)
        assert not darknet.agrees(got[:-1], rows, hw, names)
        i = next(i for i in range(len(got) - 1)
                 if got[i][0] == got[i + 1][0] and got[i][5] > got[i + 1][5])
        swapped = got[:i] + [got[i + 1], got[i]] + got[i + 2:]
        assert not darknet.agrees(swapped, rows, hw, names)
        assert not darknet.agrees(
            darknet.detections(rows, hw, names, to_pixel=np.rint), rows, hw,
            names)


@pytest.mark.parametrize("seed", range(4))
def test_the_reference_tracker_follows_the_ports(seed):
    """reference/tracker.py against the port's tracker on 60 frames of
    random detections (up to 14 a frame, steps near and over the 100-pixel
    reach), fresh and from a state taken over after 7 frames."""
    from depthbench import detector
    from depthbench.reference.tracker import Tracker
    rng = np.random.default_rng(seed)
    port = bayesian.BayesianTracker()
    mine = None
    pos = rng.integers(0, 1000, (14, 2))
    for f in range(60):
        if f == 7:
            mine = Tracker.from_state(detector.tracker_state(port))
        pos = pos + rng.integers(-70, 71, pos.shape)
        pos[rng.random(14) < 0.1] = rng.integers(0, 1000, 2)
        dets = [bayesian.Detection(name="car", x=int(x), y=int(y), w=30,
                                   h=20, conf=0.9)
                for x, y in pos[:rng.integers(0, 15)]]
        want = detector.objects(port.get_predicted_boxes())
        port.append(dets)
        if mine is not None:
            assert mine.predict() == want, f
            mine.append(detector.objects(dets))
    fresh, port = Tracker(), bayesian.BayesianTracker()
    for f in range(20):
        dets = [bayesian.Detection(name="car", x=int(x), y=int(y), w=5, h=5)
                for x, y in rng.integers(0, 300, (rng.integers(0, 12), 2))]
        assert fresh.predict() == detector.objects(port.get_predicted_boxes())
        port.append(dets)
        fresh.append(detector.objects(dets))
