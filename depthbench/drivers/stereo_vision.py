"""A closed loop with one caller through StereoVision.generatePointCloud
with objectTracking=True (the pip package's and the C ABI's per-frame
path): each pair's disparity and cloud, the detector's forward on its left
frame, the rows' fetch, the threshold and NMS, then the tracker; the next
pair is sent when the last returns."""

from __future__ import annotations

import time

from depthbench import detector

ROWS_KEPT = 2


def build(config, calib_path, device):
    """StereoVision on the configuration's rig and size, with its cfg and
    seeded weights file (written once, detector.weights_path)."""
    from stereovision_tpu_torch.engine import StereoVision
    sv = StereoVision(width=int(config["width"]), height=int(config["height"]),
                      objectTracking=True, scale=config["scale"],
                      pc_extrapolation=config["pc_extrapolation"],
                      YOLO_CFG=detector.cfg_path(config),
                      YOLO_WEIGHTS=detector.weights_path(config),
                      YOLO_CLASSES=detector.classes_path(config),
                      CAMERA_CALIBRATION_YAML=calib_path,
                      subsampling=bool(config["subsampling"]), device=device)
    if sv.detector is None:
        sv.close()
        raise RuntimeError("StereoVision built no detector from %s"
                           % config["yolo_cfg"])
    return sv


def _serve(sv, left, right) -> dict:
    sv.generatePointCloud(left, right)
    if "rows" not in sv.last:
        raise RuntimeError("StereoVision kept no detector rows")
    return sv.last


def warm(sv, pairs, traffic, config) -> None:
    """Every pair once: builds the kernels, picks cuDNN's algorithms and
    fills the allocator."""
    for left, right in pairs:
        _serve(sv, left, right)


def window(sv, pairs, schedule, traffic, config, seconds, keep,
           tracer) -> dict:
    """Send frames until `seconds` have passed since the first was sent.
    Each frame's latency runs from its send to its return; the window from
    the first send to the last return.  Kept: the frame's number, dmap,
    cloud and objects (detections, then predicted boxes), the detector's
    rows of a pair's first ROWS_KEPT frames (7.7 MB a frame at 608), and
    with the first frame the tracker's state before it."""
    lat, pc_t, rows_kept = [], [], {}
    state = detector.tracker_state(sv.tracker)
    t0 = time.perf_counter()
    t_end, last, i = t0 + seconds, t0, 0
    while i == 0 or last < t_end:
        k = schedule[i]
        left, right = pairs[k]
        tracer.frame(i)
        sent = time.perf_counter()
        out = _serve(sv, left, right)
        last = time.perf_counter()
        lat.append(last - sent)
        pc_t.append(out["timings"]["pc_t"])
        n = rows_kept[k] = rows_kept.get(k, 0) + 1
        keep(k, {"frame": i, "dmap": out["dmap"], "points": out["points"],
                 "objects": detector.objects(out["objects"]),
                 "rows": out["rows"] if n <= ROWS_KEPT else None,
                 "tracker": state if i == 0 else None})
        i += 1
    tracer.close(i)
    return {"frames": i, "attempted": i, "emitted": i, "batch": 1,
            "window_s": last - t0, "latencies_s": lat, "pc_t_s": pc_t}
