"""The port's profiling (stereovision_tpu_torch/profiling.py) held against
the JAX package's.

StageTimer's report line for line, with time.perf_counter replaced by the
same clock in both modules; profile_pipeline on 160x120 engines: JAX's
section names, and each stage's outputs (descriptors, support grid,
geometry, D1 and D2) equal to the JAX stages' on the same seeded pair;
sync; device_trace writing a Chrome trace on the CPU.  The test marked
`cuda` (skipped without a card) asserts that a trace of one
process_frame names the CUDA functions of all four kernels.

The port's spans: off by default (span() the shared no-op, nothing in the
ring, no "svtt." event in a profiler's trace), the tree of each entry
point (names, frame ids, parents, threads, the frame covered by its
children), the host middle's counts against the benchmark's plain
reference, the pool workers' spans brought back, the anchor against the
profiler's clock, the ring's bound, and no torch in the host middle and
its workers.  The JAX
package is imported inside the tests that use it, so that the card's
test run, which has no jax, can collect this file:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import collections
import itertools
import json
import os
import os.path as osp
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from stereovision_tpu_torch import profiling as P
from stereovision_tpu_torch.engine import StereoEngine, StereoVision
from stereovision_tpu_torch.hostlib import geometry, raster
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
W, H = 160, 120
SECTIONS = ["Grayscale", "Descriptor+Support (device)", "Host geometry",
            "Matching+Post (device)"]
# the CUDA functions each kernel's wrapper launches on one frame
KERNEL_FUNCTIONS = {"matching": ["match_keys_kernel"],
                    "support": ["support_scan_kernel"],
                    "lr_check": ["lr_check_kernel"],
                    "speckle_ccl": ["ccl_local", "ccl_border", "ccl_count",
                                    "ccl_apply"]}


def _clock(monkeypatch):
    """time.perf_counter as a clock that moves 1.25 ms, 2.5 ms, ... at
    each reading."""
    ticks = itertools.accumulate(0.00125 * k for k in itertools.count(1))
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def _drive(timer):
    timer.start("Grayscale")
    timer.start("Descriptor")
    timer.start("Support Matches")
    with timer.section("Matching"):
        pass
    timer.start("Descriptor")                  # a section met again
    timer.stop()
    timer.stop()                               # no section open
    with timer.section("Median"):
        pass
    timer.start("Something else")
    return timer.report()


def test_stage_timer_report_equals_jax(monkeypatch, capsys):
    from stereovision_tpu import profiling as J
    _clock(monkeypatch)
    want = _drive(J.StageTimer())
    _clock(monkeypatch)
    got = _drive(P.StageTimer())
    assert got.splitlines() == want.splitlines()
    assert P.StageTimer.GROUPS == J.StageTimer.GROUPS
    assert [l.split()[0] for l in got.splitlines()] == [
        "Grayscale", "Descriptor", "Support", "Matching", "Median",
        "Something", "[Pre", "[Disparity", "[Post", "TOTAL"]
    _clock(monkeypatch)
    t = P.StageTimer()
    t.start("Grayscale")
    t.plot()
    _clock(monkeypatch)
    j = J.StageTimer()
    j.start("Grayscale")
    j.plot()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and out[:3] == out[3:]


def test_sync_waits_on_nothing_on_the_cpu():
    x = torch.ones(3)
    tree = (x, [x, {"a": x}], 1, None)
    assert P.sync(x) is x
    assert P.sync(tree) is tree


def test_profile_pipeline_matches_jax(monkeypatch):
    """The port's sections are JAX's; what each stage computed on the
    same seeded pair equals JAX's (use_pallas=False: its plain path)."""
    import stereovision_tpu.engine as jengine
    from stereovision_tpu import profiling as J

    left, right, _ = stereo_pair(W, H, seed=3)
    got, want = {}, {}

    def spy(store, obj, name):
        real = getattr(obj, name)

        def call(*args):
            out = real(*args)
            store.setdefault(name.lstrip("_"), out)
            return out
        monkeypatch.setattr(obj, name, call)

    eng = StereoEngine(CALIB, W, H, device="cpu")
    for name in ("stage_support", "host_mid", "stage_dense"):
        spy(got, eng.elas, name)
    times = P.profile_pipeline(eng, left, right, n=2)
    with jengine.StereoEngine(CALIB, W, H, use_pallas=False) as je:
        for name in ("_stage_support", "host_mid", "_stage_dense"):
            spy(want, je.elas, name)
        jtimes = J.profile_pipeline(je, left, right, n=1)
    assert list(times) == list(jtimes) == SECTIONS
    assert all(isinstance(v, float) and v > 0 for v in times.values())
    for a, b in zip(got["stage_support"], want["stage_support"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(got["host_mid"]) == sorted(want["host_mid"])
    for k, v in want["host_mid"].items():
        np.testing.assert_array_equal(got["host_mid"][k], v, err_msg=k)
    for a, b in zip(got["stage_dense"], want["stage_dense"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    eng.close()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with P.device_trace(logdir) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(logdir) == [osp.basename(path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_trace_names_the_four_kernels(cuda, tmp_path):
    left, right, _ = stereo_pair(1242, 375, seed=1)
    with StereoEngine(CALIB, 1242, 375) as eng:
        eng.process_frame(left, right)
        with P.device_trace(str(tmp_path)) as path:
            eng.process_frame(left, right)
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat", "").lower() == "kernel"}
    for kernel, functions in KERNEL_FUNCTIONS.items():
        for fn in functions:
            assert any(fn in name for name in names), (kernel, fn)


# ---- the port's spans ------------------------------------------------------

# process_frame's children of svtt.frame, in order
FRAME_CHILDREN = ["svtt.gray", "svtt.stage_a", "svtt.fetch_support",
                  "svtt.host_mid", "svtt.upload_geometry", "svtt.stage_b",
                  "svtt.reproject", "svtt.fetch_dmap", "svtt.fetch_cloud"]
# of svtt.host_mid in process: the filters, then the left image's half and
# the right's (hostlib.geometry.host_side)
HOST_CHILDREN = (["svtt.host_mid.filters"]
                 + ["svtt.host_mid.delaunay", "svtt.host_mid.raster",
                    "svtt.host_mid.span_code"] * 2)


@pytest.fixture
def spans_on():
    """Recording on for the test, the ring empty before and after."""
    P.trace_stop()
    P.trace_drain()
    P.trace_start()
    yield
    P.trace_stop()
    P.trace_drain()


@pytest.fixture(scope="module")
def small():
    eng = StereoEngine(CALIB, W, H, device="cpu")
    pairs = [stereo_pair(W, H, seed=s)[:2] for s in (3, 4, 5)]
    yield eng, pairs
    eng.close()


def _by_id(spans):
    return {s.id: s for s in spans}


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.t0_ns)


def test_spans_are_off_by_default_and_cost_no_record(small):
    """Off: every constructor gives the one shared no-op, which counts and
    records nothing and takes no frame id; a profiler around process_frame
    sees no svtt. event."""
    from torch.profiler import ProfilerActivity, profile
    eng, pairs = small
    P.trace_stop()
    P.trace_drain()
    assert not P.recording()
    ids = P.Ids()
    for sp in (P.span("svtt.x", a=1), P.root("svtt.x", 3), P.frame(ids, "e"),
               P.in_frame(2)):
        assert sp is P.NULL
        with sp as inner:
            assert inner is P.NULL
            P.count(a=1)
            P.record("svtt.y", 1, 2)
            P.ingest([("svtt.z", None, None, 1, 0, 1, {}, 0)], 0)
            inner.add(b=2)
    assert dict(P.NULL.counts) == {}
    assert ids.take() == 0                      # frame() took no id
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.process_frame(*pairs[0])
    assert not [e.name for e in prof.events() if e.name.startswith("svtt.")]
    assert P.trace_drain()["spans"] == []


def _entry(name, eng, pairs):
    """Run frames through the entry point `name`; returns how many."""
    if name == "process_frame":
        for lf, rf in pairs:
            eng.process_frame(lf, rf)
    elif name == "stream":
        list(eng.stream(iter(pairs), lookahead=2))
    elif name == "process_jit":
        from stereovision_tpu_torch.engine import bgr_to_gray
        for lf, rf in pairs:
            eng.elas.process_jit(bgr_to_gray(lf), bgr_to_gray(rf))
    elif name == "generatePointCloud":
        sv = StereoVision(width=W, height=H, defaultCalibFile=True,
                          CAMERA_CALIBRATION_YAML=CALIB, device="cpu")
        sv.engine.elas.frame_ids = eng.elas.frame_ids
        for lf, rf in pairs:
            sv.generatePointCloud(lf, rf)
        sv.close()
    return len(pairs)


@pytest.mark.parametrize("entry", ["process_frame", "stream", "process_jit",
                                   "generatePointCloud"])
def test_span_tree_of_each_entry_point(entry, small, spans_on, capsys):
    """One svtt.frame root a frame (two under stream: the stage A
    dispatched ahead, then the rest), consecutive frame ids, every child on
    its root's thread and in its frame, the host middle's six children,
    and process_frame's nine children in order covering >= 90 % of it."""
    eng, pairs = small
    first = eng.elas.frame_ids.take(0)
    n = _entry(entry, eng, pairs)
    spans = P.trace_drain()["spans"]
    by_id = _by_id(spans)
    roots = [s for s in spans if s.name == "svtt.frame"]
    assert all(s.parent is None for s in roots)
    assert sorted({s.frame_id for s in roots}) == list(range(first,
                                                             first + n))
    assert len(roots) == (2 * n if entry == "stream" else n)
    want = {"process_frame": "process_frame", "stream": "stream",
            "process_jit": "process_jit",
            "generatePointCloud": "process_frame"}[entry]
    assert {s.counts["entry"] for s in roots} == {want}
    me = threading.get_native_id()
    for s in spans:
        assert s.thread_id == me and s.frame_id is not None
        if s.parent is not None:
            assert by_id[s.parent].frame_id == s.frame_id
            assert by_id[s.parent].t0_ns <= s.t0_ns <= s.t1_ns \
                <= by_id[s.parent].t1_ns
    hms = [s for s in spans if s.name == "svtt.host_mid"]
    assert len(hms) == n
    for hm in hms:
        assert [c.name for c in _children(spans, hm)] == HOST_CHILDREN
        assert by_id[hm.parent].name == "svtt.frame"
    names = collections.Counter(s.name for s in spans)
    for stage in ("svtt.stage_a", "svtt.fetch_support", "svtt.stage_b",
                  "svtt.upload_geometry"):
        assert names[stage] == n, stage
    if entry in ("process_frame", "generatePointCloud"):
        for root in roots:
            kids = _children(spans, root)
            assert [k.name for k in kids] == FRAME_CHILDREN
            covered = sum(k.t1_ns - k.t0_ns for k in kids)
            assert covered >= 0.9 * (root.t1_ns - root.t0_ns)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_host_mid_counts_equal_the_reference_load(native, monkeypatch,
                                                  spans_on):
    """svtt.host_mid's counts: the support points, thinning and triangles
    of depthbench's plain reference on the same pairs, runs_max within
    s_max, and native as get_lib() says (0 on the NumPy fallbacks)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from depthbench.reference.pipeline import Reference
    if not native:
        monkeypatch.setattr(raster, "get_lib", lambda: None)
        monkeypatch.setattr(geometry, "get_lib", lambda: None)
    eng = StereoEngine(CALIB, W, H, device="cpu")
    ref = Reference(CALIB, W, H, False, device="cpu")
    pairs = [stereo_pair(W, H, seed=s)[:2] for s in (6, 7)]
    for lf, rf in pairs:
        eng.process_frame(lf, rf)
    counts = [s.counts for s in P.trace_drain()["spans"]
              if s.name == "svtt.host_mid"]
    assert len(counts) == len(pairs)
    for c, (lf, rf) in zip(counts, pairs):
        load = ref.frame(lf, rf)["load"]
        assert (c["support"], c["thinned"], c["tris_l"], c["tris_r"]) == (
            load["support"], load["thinned_from"], load["tris_l"],
            load["tris_r"])
        assert 0 < c["runs_max"] <= eng.elas.s_max
        assert c["native"] == int(raster.get_lib() is not None) == native
    eng.close()


def test_host_mid_counts_thinning_and_span_overflow(spans_on):
    """Where the cap thins the support points, thinned is the count found
    and support the cap; runs_max gives the longest row even past s_max."""
    from stereovision_tpu_torch.params import app_params
    p = app_params()
    d_can = np.full((24, 32), -1, np.int16)
    d_can[::2, ::2] = 7
    d_can[1::2, 1::2] = 9
    with pytest.warns(UserWarning):
        geometry.host_mid(d_can, p, W, H, n_max=40, t_max=100, s_max=2,
                          host_filters=False)
    hm, = [s for s in P.trace_drain()["spans"] if s.name == "svtt.host_mid"]
    found = int((d_can >= 0).sum())
    assert hm.counts["thinned"] == found > 40 - 6
    assert hm.counts["support"] == 40
    assert hm.counts["runs_max"] > 2 and p.add_corners


@pytest.mark.parametrize("subsampling", [False, True],
                         ids=["full", "subsampled"])
def test_span_code_counts_native_and_runs(subsampling, monkeypatch,
                                          spans_on):
    """svtt.host_mid.span_code: native 1 where the C++ coder ran, 0 with
    get_lib forced to None for the span coding (the filters and the
    rasterizer stay native, so both code the same id maps), runs and the
    codes equal both ways."""
    from stereovision_tpu_torch.params import app_params
    p = app_params(subsampling=subsampling)
    v, u = np.mgrid[0:H // p.step, 0:W // p.step]
    d_can = (10 + u // 2 + v // 3).astype(np.int16)
    d_can[::3, 1::4] = -1
    assert raster.get_lib() is not None
    codes, counts = [], []
    for _ in ("native", "numpy"):
        g = geometry.host_mid(d_can, p, W, H, n_max=1024, t_max=2056,
                              s_max=64)
        codes.append([g["tri_l"], g["tri_r"]])
        counts.append([s.counts for s in P.trace_drain()["spans"]
                       if s.name == "svtt.host_mid.span_code"])
        monkeypatch.setattr(geometry, "get_lib", lambda: None)
    assert [c["native"] for c in counts[0]] == [1, 1]
    assert [c["native"] for c in counts[1]] == [0, 0]
    assert [c["runs"] for c in counts[0]] == [c["runs"] for c in counts[1]]
    assert all(c["runs"] > 1 for c in counts[0])
    for a, b in zip(*codes):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("host_workers", ["process", "thread"])
def test_stream_batched_brings_back_the_workers_spans(host_workers, small,
                                                      spans_on):
    """stream_batched: each batch a svtt.batch root on the prefetch thread
    and on the tail worker, the tail's queue wait and stages, and the host
    middle's spans of every frame (from the pool's processes, or the host
    threads) in that frame, first + i."""
    eng, pairs = small
    frames = pairs + pairs[:1]                  # two batches of two
    first = eng.elas.frame_ids.take(0)
    list(eng.stream_batched(iter(frames), batch=2, fetch="host",
                            pipeline_depth=1, host_workers=host_workers))
    assert eng.host_mode == host_workers
    spans = P.trace_drain()["spans"]
    by_id = _by_id(spans)
    roots = [s for s in spans if s.name == "svtt.batch"]
    assert sorted(s.counts["first"] for s in roots) == [
        first, first, first + 2, first + 2]
    assert all(s.parent is None and s.frame_id == s.counts["first"]
               for s in roots)
    me = threading.get_native_id()
    tail_names, pre_names = set(), set()
    for s in spans:
        if s.parent is not None and by_id[s.parent].name == "svtt.batch":
            assert s.thread_id == by_id[s.parent].thread_id != me
            (tail_names if s.name != "svtt.gray" and "upload_images"
             not in s.name and s.name != "svtt.stage_a"
             else pre_names).add(s.name)
    assert pre_names == {"svtt.gray", "svtt.upload_images", "svtt.stage_a"}
    assert tail_names == {"svtt.queue_wait", "svtt.fetch_support",
                          "svtt.host_mid_pool", "svtt.upload_geometry",
                          "svtt.stage_b", "svtt.reproject", "svtt.fetch_dmap",
                          "svtt.fetch_cloud"}
    hms = sorted((s for s in spans if s.name == "svtt.host_mid"),
                 key=lambda s: s.frame_id)
    assert [s.frame_id for s in hms] == list(range(first, first + 4))
    for hm in hms:
        assert [c.name for c in _children(spans, hm)] == HOST_CHILDREN
        assert all(c.thread_id == hm.thread_id and c.frame_id == hm.frame_id
                   for c in _children(spans, hm))
        if host_workers == "process":
            # a worker process's thread, under the tail's pool span
            assert by_id[hm.parent].name == "svtt.host_mid_pool"
        assert hm.thread_id not in {r.thread_id for r in roots}


def test_anchor_maps_spans_onto_the_profilers_clock():
    """A span's buffered interval, on CLOCK_REALTIME through the anchor,
    lies within 200 us of its record_function twin in the profiler's
    events (trace_start_ns() + time_range * 1000)."""
    from torch.profiler import ProfilerActivity, profile
    P.trace_stop()
    P.trace_drain()
    anchor = P.trace_start()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with P.span("svtt.warm"):           # record_function's first use
                pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(5):
                with P.span("svtt.probe.%d" % i):
                    torch.ones(256, 256).sum()
                time.sleep(0.002)
    finally:
        P.trace_stop()
    spans = {s.name: s for s in P.trace_drain()["spans"]}
    start = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()
              if e.name.startswith("svtt.probe.")}
    assert len(events) == 5
    for name, e in events.items():
        s = spans[name]
        assert abs(P.wall_ns(s.t0_ns, anchor)
                   - (start + e.time_range.start * 1000)) < 200_000, name
        assert abs(P.wall_ns(s.t1_ns, anchor)
                   - (start + e.time_range.end * 1000)) < 200_000, name


def test_ring_drops_the_oldest_spans_at_its_length(spans_on):
    for i in range(P.RING + 10):
        P.record("svtt.r", i, i + 1)
    spans = P.trace_drain()["spans"]
    assert len(spans) == P.RING
    assert [s.t0_ns for s in spans[:2]] == [10, 11]
    assert spans[-1].t0_ns == P.RING + 9
    assert P.trace_drain()["spans"] == []


def test_record_ingest_and_frames_across_threads(spans_on):
    """record() takes given times under the innermost span; ingest()
    renumbers another process's spans into a frame, their roots under the
    innermost span; in_frame() hands a frame to another thread; ids are
    consecutive under threads."""
    ids = P.Ids()
    with P.root("svtt.batch", 10, batch=4, first=10) as b:
        P.record("svtt.queue_wait", 5, 9)
        with P.span("svtt.host_mid_pool") as pool:
            P.ingest([("svtt.host_mid", None, None, 77, 1, 8, {"n": 1}, 0),
                      ("svtt.host_mid.filters", None, 0, 77, 2, 3, {}, 1)],
                     11)
        got = []

        def other():
            with P.in_frame(12):
                with P.span("svtt.host_mid") as hm:
                    got.append((hm.frame_id, hm.parent))
            got.append(P.current_frame())
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        P.count(extra=1)
        assert P.current_frame() == 10
    assert P.current_frame() is None
    assert got == [(12, None), None]
    spans = P.trace_drain()["spans"]
    by_name = {s.name: s for s in spans if s.thread_id != 77 and
               s.frame_id != 12}
    assert by_name["svtt.queue_wait"][4:6] == (5, 9)
    assert by_name["svtt.queue_wait"].parent == b.id
    assert by_name["svtt.batch"].counts == {"batch": 4, "first": 10,
                                            "extra": 1}
    w = [s for s in spans if s.thread_id == 77]
    assert [(s.name, s.frame_id) for s in w] == [
        ("svtt.host_mid", 11), ("svtt.host_mid.filters", 11)]
    assert w[0].parent == pool.id and w[1].parent == w[0].id
    assert len({s.id for s in spans}) == len(spans)
    taken = []
    workers = [threading.Thread(target=lambda: taken.extend(
        ids.take(3) for _ in range(200))) for _ in range(4)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=30)
    assert sorted(taken) == list(range(0, 2400, 3))


def test_host_middle_and_its_workers_import_no_torch():
    """profiling, hostlib and a pool worker's traced call load no torch,
    and the worker hands its spans back."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from stereovision_tpu_torch import profiling\n"
        "from stereovision_tpu_torch.hostlib import geometry\n"
        "from stereovision_tpu_torch.params import app_params\n"
        "geometry._pool_init(app_params(), 160, 120, 774, 1556, 64, True)\n"
        "d = np.full((24, 32), -1, np.int16); d[2:20:3, 2:30:3] = 5\n"
        "out = geometry._pool_host_mid(d, True)\n"
        "names = [s[0] for s in out['spans']]\n"
        "assert names[-1] == 'svtt.host_mid', names\n"
        "assert len(names) == 8 and not profiling.recording()\n"
        "assert 'spans' not in geometry._pool_host_mid(d)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('torch', 'jax', 'stereovision_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["process_frame", "process_jit"])
def test_spans_on_the_card(cuda, entry):
    """On the card, with a profiler running: the same frames with spans on
    as off (graph replays included), and device work traced.  The spans of
    the caller's thread show in the profiler's trace as CPU events."""
    from torch.profiler import ProfilerActivity, profile
    from stereovision_tpu_torch.engine import bgr_to_gray
    pairs = [stereo_pair(W, H, seed=s)[:2] for s in (3, 4, 5)]

    def run(eng):
        if entry == "process_frame":
            return [eng.process_frame(l, r)["dmap"] for l, r in pairs]
        return [eng.elas.process_jit(bgr_to_gray(l), bgr_to_gray(r))[0]
                .cpu().numpy() for l, r in pairs]

    with StereoEngine(CALIB, W, H) as eng:
        want = run(eng)
        P.trace_drain()
        P.trace_start()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                got = run(eng)
                torch.cuda.synchronize()
        finally:
            P.trace_stop()
    spans = P.trace_drain()["spans"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    names = collections.Counter(s.name for s in spans)
    assert names["svtt.stage_a"] == names["svtt.stage_b"] == 3
    assert names["svtt.host_mid"] == 3
    cpu = {e.name for e in prof.events()
           if e.device_type.name == "CPU" and e.name.startswith("svtt.")}
    assert {"svtt.stage_a", "svtt.stage_b", "svtt.host_mid"} <= cpu
    assert any(e.device_type.name == "CUDA" for e in prof.events())
