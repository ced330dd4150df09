"""The harness: configurations, mixes, drivers and metrics found by name;
the traffic repeats for a seed; the last line's keys; no run without a
card; no module of JAX or the JAX package loaded by a run."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from depthbench import frames, harness

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
# with the cells, configurations and metrics kept for later (later.json)
LATER = harness.load_bench(later=True)
LIVE = [w["name"] for w in LATER["workloads"] if w["traffic"] == "live"]
SMALL = {"width": 160, "height": 120, "trace_start": 2, "trace_frames": 3}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "depthbench/run.py"]
    assert BENCH["paths"] == ["depthbench"]
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("depthbench/") and \
            os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metric_keys = {"name", "unit", "better", "source"}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_later_json_keeps_the_form():
    """The cells kept for later, merged in, form a whole description:
    names unique, every entry complete, every configuration used, every
    per-layer metric moving an end-to-end metric of each of its cells."""
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in LATER[k]]
    assert len(names) == len(set(names))
    for c in LATER["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in LATER["workloads"])
    for w in LATER["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    keys = {"name", "unit", "better", "source"}
    for m in LATER["end_to_end"]:
        assert set(m) - {"workloads"} == keys | {"bound"}
    cells = [w["name"] for w in LATER["workloads"]]
    for m in LATER["per_layer"]:
        assert set(m) == keys | {"layer", "moves", "workloads"}
        e2e = {e["name"]: e for e in LATER["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(e2e.get("workloads", cells))


@pytest.mark.parametrize("cell", [w["name"] for w in LATER["workloads"]])
def test_cell_resolves_by_name(cell):
    c = harness.resolve(cell, LATER)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["entry"] in ("process_frame", "stream_batched")
    assert callable(c["driver"].warm) and callable(c["driver"].window)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", LATER["end_to_end"] + LATER["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_declares_what_benchmark_json_says(m):
    mod = harness.load_module("metrics", m["name"])
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    if "layer" in m:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    assert callable(mod.read)


def test_every_reader_and_mix_file_is_used_or_kept_for_later():
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "depthbench",
                                                     "metrics"))
             if f.endswith(".py")}
    assert listed <= files
    mixes = {f[:-5] for f in os.listdir(os.path.join(ROOT, "depthbench",
                                                     "traffic"))}
    assert {w["traffic"] for w in BENCH["workloads"]} <= mixes


def test_frame_tail_leaves_out_the_profiled_frames():
    """frame_ms_p95.live: the 95th percentile of the window's latencies
    without the frames that the profiler traced (from the mix's
    trace_start, as many as the trace holds); every frame where nothing
    was traced; nothing where there is no latency."""
    read = harness.load_module("metrics", "frame_ms_p95.live").read
    lat = [0.010 + 0.001 * (i % 20) for i in range(100)]
    slow = lat[:4] + [5.0] * 16 + lat[20:]
    rec = {"latencies_s": slow, "traffic": {"trace_start": 4},
           "trace": {"frames": 16}}
    assert read(rec) == pytest.approx(
        1e3 * np.percentile(lat[:4] + lat[20:], 95))
    assert read(dict(rec, trace={})) == pytest.approx(
        1e3 * np.percentile(slow, 95))
    assert read(dict(rec, trace={})) > 1e3
    assert read({"latencies_s": [], "trace": {}}) is None


def test_unknown_names_raise():
    with pytest.raises(LookupError):
        harness.resolve("kitti_full.nothing")
    with pytest.raises(LookupError):
        harness.load_module("metrics", "no_such_metric")


def test_traffic_repeats_for_a_seed():
    cfg, tr = {"width": 96, "height": 64}, {"pairs": 3}
    a, b = frames.pairs(cfg, tr, 2**33 + 5), frames.pairs(cfg, tr, 2**33 + 5)
    c = frames.pairs(cfg, tr, 2**33 + 6)
    assert len(a) == 3
    for (l1, r1), (l2, r2), (l3, _) in zip(a, b, c):
        assert np.array_equal(l1, l2) and np.array_equal(r1, r2)
        assert not np.array_equal(l1, l3)
    sched = frames.Schedule(3, 2**33 + 5)
    order = [sched[i] for i in range(30)]
    assert order == [frames.Schedule(3, 2**33 + 5)[i] for i in range(30)]
    for turn in range(10):
        assert sorted(order[3 * turn:3 * turn + 3]) == [0, 1, 2]
    assert len({tuple(order[3 * t:3 * t + 3]) for t in range(10)}) > 1


def _run(cell, traced, seconds=1.5):
    import time
    return harness.run_cell(cell, 987654321987, seconds, traced,
                            time.perf_counter(), device="cpu",
                            overrides=dict(SMALL), log=lambda s: None,
                            bench=LATER)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", LIVE)
def test_last_line_keys(cell, traced):
    r = _run(cell, traced)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    c = harness.resolve(cell, LATER)
    want = {m["name"] for m in (c["per_layer"] if traced
                                else c["end_to_end"])}
    assert set(r["metrics"]) <= want
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"} and np.isfinite(v["value"])
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # the end-to-end metrics are all there on the CPU too
        assert set(r["metrics"]) == want
    for name, chk in r["checks"].items():
        assert chk["value"] <= chk["limit"], name
    json.dumps(r, allow_nan=False)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "depthbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_only_benchmark_files_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and depthbench/ gives no
    result (it has no program to run)."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "depthbench"),
                    tmp_path / "depthbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "depthbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_loads_no_jax():
    """A whole run in a fresh process (every cell's driver, the reference,
    a traced stretch) leaves no module whose top-level name is jax,
    jaxlib, flax or stereovision_tpu; stereovision_tpu_torch, whose name
    begins with stereovision_tpu, is loaded and not counted."""
    code = """
import sys, time
sys.path.insert(0, %r)
from depthbench import harness
if __name__ == "__main__":
    for cell in %r:
        harness.run_cell(cell, 5, 1.0, True, time.perf_counter(),
                         device="cpu", overrides=%r, log=lambda s: None)
    top = {m.split(".")[0] for m in sys.modules}
    print(sorted(top & {"jax", "jaxlib", "flax", "stereovision_tpu",
                        "stereovision_tpu_torch"}))
    print(harness.forbidden_modules())
""" % (ROOT, [w["name"] for w in BENCH["workloads"]], SMALL)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "['stereovision_tpu_torch']"
    assert lines[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "stereovision_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stereovision_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "stereovision_tpu.ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cell):
    """A short run of each cell on the card, both modes: correct, the
    cell's metrics, the device named."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for trace in ("0", "1"):
        out = subprocess.run(
            [sys.executable, "depthbench/run.py", "--workload", cell,
             "--seed", "3000000017", "--seconds", "5", "--trace", trace],
            cwd=ROOT, capture_output=True, text=True, timeout=360)
        assert out.returncode == 0, out.stderr[-3000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"] and r["device"]["platform"] == "gpu"
        assert r["device"]["kind"] == torch.cuda.get_device_name()
