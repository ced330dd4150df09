"""What a configuration can bring as files alone: a driver that builds the
object it serves, readings of the check under checks/ found by name, and
metric files that read the configuration, the program's spans and every
device op from the run's record.  The moved stereo readings against the
comparison they replace."""

import json
import os
import time

import numpy as np
import pytest

from depthbench import check, control, harness, lookup

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
SMALL = {"width": 160, "height": 120, "trace_start": 2, "trace_frames": 3}
NEW_READERS = ("host_filters_ms.live", "host_delaunay_ms.live",
               "host_raster_ms.live", "host_span_code_ms.live",
               "stage_a_device_ms.live", "stage_b_device_ms.live")


def _old_points_rel(served, ref):
    a = np.asarray(served, np.float64)
    b = np.asarray(ref, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return float("inf")
    inf = ~fa & ~np.isnan(a)
    if not np.array_equal(a[inf], b[inf]) or \
            not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    if not fa.any():
        return 0.0
    d = np.abs(a[fa] - b[fa]) / np.maximum(np.abs(b[fa]), 1.0)
    return float(d.max())


def _old_compare(served, refs):
    """check.compare as it was before the readings moved to checks/."""
    px, rel, frames, clouds = 0, 0.0, 0, 0
    for k, outs in served.items():
        r = refs[k]
        for o in outs:
            dm = np.asarray(o["dmap"])
            if dm.shape != r["dmap"].shape:
                px = max(px, r["dmap"].size)
            else:
                px = max(px, int((dm != r["dmap"]).sum()))
            frames += 1
            if o.get("points") is not None:
                pts = np.asarray(o["points"]).reshape(-1, 3)
                rel = max(rel, _old_points_rel(pts, r["points"])
                          if pts.shape == r["points"].shape
                          else float("inf"))
                clouds += 1
    return {"dmap_px": px, "points_rel": rel, "frames": frames,
            "clouds": clouds}


def _case(name):
    """(served {pair: [output]}, refs {pair: output}) for a named case."""
    rng = np.random.default_rng(5)
    refs = {k: {"dmap": rng.integers(0, 255, (6, 8), dtype=np.uint8),
                "points": rng.normal(size=(48, 3)).astype(np.float32) * 20}
            for k in range(2)}
    for r in refs.values():
        r["points"][3] = np.nan
        r["points"][7, 1] = np.inf
        r["points"][9, 2] = -np.inf
    served = {k: [{"dmap": r["dmap"].copy(), "points": r["points"].copy()},
                  {"dmap": r["dmap"].copy(), "points": None}]
              for k, r in refs.items()}
    o = served[1][0]
    if name == "equal":
        pass
    elif name == "moved":
        o["dmap"][2, :3] += 1
        o["points"][5, 0] *= 1.001
        o["points"][6, 1] += 0.25
    elif name == "dmap_shape":
        o["dmap"] = o["dmap"][:, :-1]
    elif name == "points_shape":
        o["points"] = o["points"][:-1]
    elif name == "points_grid":
        # a (pc_h, pc_w, 3) cloud of the same points reshapes alike
        o["points"] = o["points"].reshape(6, 8, 3)
    elif name == "nan_for_finite":
        o["points"][0, 0] = np.nan
    elif name == "finite_for_nan":
        o["points"][3, 0] = 1.0
    elif name == "inf_for_finite":
        o["points"][0, 2] = np.inf
    elif name == "inf_sign":
        o["points"][7, 1] = -np.inf
    elif name == "all_nonfinite":
        for outs, r in zip(served.values(), refs.values()):
            r["points"][:] = np.nan
            outs[0]["points"][:] = np.nan
    else:
        raise KeyError(name)
    return served, refs


@pytest.mark.parametrize("name", [
    "equal", "moved", "dmap_shape", "points_shape", "points_grid",
    "nan_for_finite", "finite_for_nan", "inf_for_finite", "inf_sign",
    "all_nonfinite"])
def test_moved_readings_equal_the_old_compare(name):
    served, refs = _case(name)
    old = _old_compare(served, refs)
    config = {"name": "t", "check": {"dmap_px": 0, "points_rel": 0}}
    limits = check.limits_of(config)
    checks = check.modules(limits)
    kept = {k: [check.kept(o, checks, o["points"] is not None)
                for o in outs] for k, outs in served.items()}
    new = check.compare(kept, refs, None, config, "cpu", checks)
    assert new["dmap_px"] == old["dmap_px"]
    assert new["points_rel"] == old["points_rel"]
    assert new["frames"] == old["frames"]
    assert new["kept"] == {"dmap_px": old["frames"],
                           "points_rel": old["clouds"]}


def test_keeper_keeps_the_clouds_it_kept_before():
    """The keeper's draws are consumed as before the readings moved: a
    seed keeps the same frames' clouds."""
    from depthbench import frames
    seed, share = 2**33 + 9, 0.25
    rng = np.random.default_rng([seed, 7])
    old = {}
    checks = check.modules(check.limits_of(
        {"check": {"dmap_px": 0, "points_rel": 0}}))
    keeper = harness.Keeper(seed, share, checks)
    sched = frames.Schedule(8, seed)
    for i in range(300):
        k = sched[i]
        out = {"dmap": i, "points": -i}
        outs = old.setdefault(k, [])
        cloud = not outs or rng.random() < share
        outs.append({"dmap": i, "points": -i if cloud else None})
        keeper.keep(k, out)
    new = {k: [{"dmap": o["dmap_px"], "points": o["points_rel"]}
               for o in outs] for k, outs in keeper.served.items()}
    assert new == old


def test_limits_name_what_has_no_module():
    with pytest.raises(ValueError, match="no_such_reading"):
        check.limits_of({"name": "t", "check": {
            "dmap_px": 0, "points_rel": 0, "no_such_reading": 1}})
    with pytest.raises(ValueError, match="points_rel"):
        check.limits_of({"name": "t", "check": {"dmap_px": 0}})
    lim = check.limits_of({"name": "t", "check": {"points_rel": 0.5,
                                                  "dmap_px": 2}})
    assert list(lim.items()) == [("dmap_px", 2.0), ("points_rel", 0.5)]


# a configuration's own files: a driver that builds the object it serves
# (the stereo engine behind a wrapper that also reports each left frame's
# mean), a reading of that report against the input, a metric of a
# program span, a traffic mix and the configuration
TOY = {
    "drivers/toy_served.py": '''
import time


class Served:
    def __init__(self, engine, bias):
        self.engine, self.bias = engine, bias

    def serve(self, left, right):
        out = self.engine.process_frame(left, right, fetch="host")
        out["left_mean"] = float(left.mean()) + self.bias
        return out

    def close(self):
        self.engine.close()


def build(config, calib_path, device):
    from stereovision_tpu_torch.engine import StereoEngine
    return Served(StereoEngine(calib_path, config["width"], config["height"],
                               subsampling=config["subsampling"],
                               device=device), config["bias"])


def warm(served, pairs, traffic, config):
    for left, right in pairs:
        served.serve(left, right)


def window(served, pairs, schedule, traffic, config, seconds, keep, tracer):
    lat, i = [], 0
    t0 = last = time.perf_counter()
    while i == 0 or last < t0 + seconds:
        k = schedule[i]
        tracer.frame(i)
        sent = time.perf_counter()
        out = served.serve(*pairs[k])
        last = time.perf_counter()
        lat.append(last - sent)
        keep(k, out)
        i += 1
    tracer.close(i)
    return {"frames": i, "attempted": i, "emitted": i, "batch": 1,
            "window_s": last - t0, "latencies_s": lat}
''',
    "checks/left_mean.py": '''
import numpy as np
import torch


def keep(out, cloud):
    return out["left_mean"]


def read(kept, refs, pairs, config, device):
    return max(abs(v - float(np.asarray(pairs[k][0]).mean()))
               for k, vs in kept.items() for v in vs)


def control(pairs, config, device):
    """The mean in bfloat16, the precision below float32."""
    return {k: {"left_mean": float(torch.as_tensor(
                np.asarray(left, np.float32)).mean().to(torch.bfloat16))}
            for k, (left, right) in enumerate(pairs)}
''',
    "metrics/toy_gray_ms.py": '''
from depthbench import program

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "entry points", "frame_ms"


def read(rec):
    assert rec["config"]["name"] == "toy"
    return program.span_ms(rec, "svtt.gray")
''',
    "traffic/toy.json": {"entry": "toy_served", "pairs": 3,
                         "points_share": 0.5, "trace_start": 1,
                         "trace_frames": 2},
}


def _toy(tmp_path, monkeypatch):
    """The toy configuration's files in tmp_path, searched before
    depthbench/; -> its benchmark description."""
    monkeypatch.setattr(lookup, "DIRS", [str(tmp_path), lookup.HERE])
    for rel, body in TOY.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body if isinstance(body, str) else json.dumps(body))
    config = harness.load_json(os.path.join(ROOT, "depthbench", "configs",
                                            "kitti_full.json"))
    config.update(name="toy", bias=0.0,
                  check=dict(config["check"], left_mean=1e-9))
    (tmp_path / "toy.json").write_text(json.dumps(config))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    return {"configs": [{"name": "toy", "source": "-", "reduced": [],
                         "file": str(tmp_path / "toy.json"), "why": "-"}],
            "workloads": [{"name": "toy.live", "config": "toy",
                           "traffic": "toy", "chips": 1, "why": "-"}],
            "end_to_end": [dict(e2e["frame_ms"], workloads=["toy.live"]),
                           e2e["setup_s"]],
            "per_layer": [{"name": "toy_gray_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "entry points", "moves": "frame_ms",
                           "workloads": ["toy.live"]}]}


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("bias", [0.0, 0.5], ids=["sound", "altered"])
def test_a_configuration_brings_its_served_object_and_reading(
        tmp_path, monkeypatch, bias, traced):
    """A cell whose files all lie outside depthbench/ runs through run_cell
    as it stands: its driver's object is served, its reading decides
    correct with the stereo ones, its metric reads the program's spans."""
    bench = _toy(tmp_path, monkeypatch)
    r = harness.run_cell("toy.live", 31415926535, 1.0, traced,
                         time.perf_counter(), device="cpu",
                         overrides=dict(SMALL, bias=bias),
                         log=lambda s: None, bench=bench)
    assert list(r["checks"]) == ["dmap_px", "points_rel", "left_mean",
                                 "missing_frames"]
    assert r["checks"]["dmap_px"]["value"] == 0
    assert r["checks"]["left_mean"]["value"] == pytest.approx(bias)
    assert r["correct"] is (bias == 0.0)
    if traced:
        assert set(r["metrics"]) == {"toy_gray_ms"}
        assert r["metrics"]["toy_gray_ms"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"frame_ms", "setup_s"}


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_the_record_that_metric_files_read(traced):
    """A CPU run's record: the configuration as resolved; in a traced run
    the program's spans and the trace's device seconds by stage and by
    name (empty: the CPU profiler has no device ops).  The new readers
    give ms a frame of the host middle's parts, and nothing for device
    time on the CPU."""
    recs = []
    r = harness.run_cell("kitti_full.live", 2**35 + 3, 1.5, traced,
                         time.perf_counter(), device="cpu",
                         overrides=dict(SMALL), log=lambda s: None,
                         bench=harness.load_bench(), on_record=recs.append)
    assert r["correct"] is True
    rec, = recs
    assert rec["config"]["name"] == "kitti_full"
    assert rec["traffic"]["entry"] == "process_frame"
    assert (rec["config"]["width"], rec["config"]["height"]) == (160, 120)
    if not traced:
        assert "program" not in rec and rec["trace"] == {}
        return
    assert rec["program"]["full"] is False
    names = {s.name for s in rec["program"]["spans"]}
    assert {"svtt.frame", "svtt.host_mid", "svtt.stage_a"} <= names
    assert rec["trace"]["stage_device_s"] == {}
    assert rec["trace"]["device_s_by_name"] == {}
    got = {n: harness.load_module("metrics", n).read(rec)
           for n in NEW_READERS}
    for n in NEW_READERS[:4]:
        assert got[n] > 0, n
    host_mid = harness.load_module("metrics", "host_mid_ms.live").read(rec)
    assert sum(got[n] for n in NEW_READERS[:4]) <= host_mid
    assert got["stage_a_device_ms.live"] is None
    assert got["stage_b_device_ms.live"] is None
    assert set(NEW_READERS[:4]) <= set(r["metrics"])


def test_control_readings_of_a_configuration_with_its_own_files(
        tmp_path, monkeypatch):
    """control.py's readings on the toy configuration: the lower ones from
    run_cell with the driver's own served object, the upper ones from the
    toy reading's own control (its mean in bfloat16) and, for the stereo
    readings, the stereo reference in bfloat16; no control.py edit."""
    bench = _toy(tmp_path, monkeypatch)
    r = control.readings("toy", [2**34 + 1, 2**34 + 2], [2**34 + 3], 0.5,
                         device="cpu", bench=bench,
                         overrides=dict(SMALL, bias=0.0),
                         log=lambda s: None)
    assert r["names"] == ["dmap_px", "points_rel", "left_mean"]
    assert [x["seed"] for x in r["program"]["toy.live"]] == [2**34 + 1,
                                                            2**34 + 2]
    s = control.summarize(r)
    assert s["lower"]["toy.live"] == {"dmap_px": 0, "points_rel": 0.0,
                                      "left_mean": 0.0, "missing_frames": 0}
    assert all(x["correct"] for x in r["program"]["toy.live"])
    limits = check.limits_of(harness.resolve("toy.live", bench)["config"])
    assert s["upper"]["left_mean"] > limits["left_mean"]
    assert s["upper"]["points_rel"] > limits["points_rel"]
