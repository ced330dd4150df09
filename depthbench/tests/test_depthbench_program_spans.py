"""program_spans.py and what it reads: device time by program stage
(trace.stage_device_s) on hand-made profiler events, the readings of a
hand-made record, and a CPU run of the live cell with the program's spans
recorded by the harness."""

import time
from types import SimpleNamespace as NS

import pytest

from depthbench import harness, program_spans, trace

SMALL = {"width": 160, "height": 120, "trace_start": 2, "trace_frames": 3}


def _ev(name, dev, start, end, thread=1, id=0, linked=0, user=False):
    from torch.autograd import DeviceType
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=DeviceType.CUDA if dev else DeviceType.CPU,
              thread=thread, id=id, linked_correlation_id=linked,
              is_user_annotation=user)


def test_stage_device_s_by_correlation_id():
    """A kernel goes to the innermost svtt span around the runtime call
    that launched it (on that call's thread), wherever it ran; a copy
    counts like a kernel; an op with no launching call goes to the span
    around its own start; annotations' device copies and ops under no span
    count for nothing or for ""."""
    events = [
        _ev("svtt.frame", 0, 0, 1000),
        _ev("svtt.stage_a", 0, 10, 100),
        _ev("svtt.stage_b", 0, 200, 400),
        _ev("svtt.host_mid", 0, 100, 200, thread=2),   # another thread
        _ev("cudaLaunchKernel", 0, 50, 55, id=7),
        _ev("cudaMemcpyAsync", 0, 300, 305, id=8),
        _ev("cudaLaunchKernel", 0, 150, 152, id=9),
        _ev("cudaGraphLaunch", 0, 1500, 1502, id=10),
        # K2, launched in stage A, runs during stage B's span
        _ev("support_scan_kernel", 1, 250, 290, id=7),
        _ev("Memcpy DtoH", 1, 310, 320, id=8),
        # launched at 150 on thread 1: the frame, not thread 2's host_mid
        _ev("elementwise_kernel", 1, 160, 165, id=9),
        _ev("graph_kernel", 1, 1510, 1530, id=10),
        # linked to its launching call by the other key
        _ev("linked_kernel", 1, 60, 61, id=99, linked=9),
        # no launching call: the span around its start
        _ev("orphan_kernel", 1, 20, 24),
        _ev("svtt.stage_b", 1, 200, 400, user=True),
    ]
    got, linked, ops = trace.stage_device_s(events)
    assert (linked, ops) == (5, 6)
    assert got == pytest.approx({"svtt.stage_a": 44e-6,
                                 "svtt.stage_b": 10e-6,
                                 "svtt.frame": 6e-6, "": 20e-6})


def test_readings_of_hand_made_spans():
    from stereovision_tpu_torch.profiling import Span
    ms = 1_000_000
    spans = [Span(*s) for s in [
        ("svtt.frame", 0, None, 1, 0, 100 * ms, {"entry": "e"}, 0),
        ("svtt.host_mid", 0, 0, 1, 0, 60 * ms,
         {"support": 9, "native": 1}, 1),
        ("svtt.host_mid.filters", 0, 1, 1, 0, 10 * ms, {}, 2),
        ("svtt.host_mid.delaunay", 0, 1, 1, 10 * ms, 14 * ms, {}, 3),
        ("svtt.host_mid.delaunay", 0, 1, 1, 14 * ms, 20 * ms, {}, 4),
        ("svtt.stage_b", 0, 0, 1, 60 * ms, 90 * ms, {}, 5),
        ("svtt.frame", 1, None, 1, 0, 50 * ms, {"entry": "e"}, 6),
        ("svtt.host_mid", 1, 6, 1, 0, 40 * ms,
         {"support": 11, "native": 1}, 7),
        ("svtt.host_mid.filters", 1, 7, 1, 0, 30 * ms, {}, 8),
    ]]
    rec = {"program": {"spans": spans, "full": False}, "latencies_s": [1],
           "trace": {"frames": 2, "busy_s": 0.009,
                     "stage_device_s": {"svtt.stage_a": 0.001,
                                        "svtt.stage_b": 0.004,
                                        "svtt.reproject": 0.002,
                                        "svtt.fetch_cloud": 0.001,
                                        "": 0.002}}}
    r = program_spans.readings(rec)
    assert r["frames"] == 2
    assert r["host_filters_ms"] == pytest.approx(20.0)
    assert r["host_delaunay_ms"] == pytest.approx(5.0)
    assert r["host_raster_ms"] == 0.0
    assert r["host_mid_ms"] == pytest.approx(50.0)
    assert r["host_mid_counts"] == {"support": [9, 11], "native": [1]}
    assert r["frame_cover"] == pytest.approx([0.8, 0.85])
    assert r["stage_a_device_ms"] == pytest.approx(0.5)
    assert r["stage_b_device_ms"] == pytest.approx(3.0)
    assert r["staged_share_of_ops"] == pytest.approx(0.8)
    rec["trace"] = {}
    r = program_spans.readings(rec)
    assert "stage_device_s" not in r and "stage_a_device_ms" not in r
    # a full ring leaves its oldest frame out
    rec["program"]["full"] = True
    assert program_spans.readings(rec)["host_filters_ms"] == \
        pytest.approx(30.0)


def test_recorded_run_of_the_live_cell_on_the_cpu():
    """The live cell, traced, small, on the CPU: the harness records the
    program's spans into the record; the host middle's split is read, its
    parts lie inside the host middle, run.py's result is unchanged in form;
    after the run recording is off and the harness's functions are its
    own."""
    from stereovision_tpu_torch import profiling as P
    warm, summarize = trace.Tracer.warm, trace.summarize
    bench = harness.load_bench(later=True)
    box = {}
    r = harness.run_cell("kitti_full.live", 2**33 + 11, 1.5, True,
                         time.perf_counter(), device="cpu",
                         overrides=dict(SMALL), log=lambda s: None,
                         bench=bench, on_record=lambda rec: box.update(
                             program=program_spans.readings(rec)))
    assert r["correct"] is True
    assert (trace.Tracer.warm, trace.summarize) == (warm, summarize)
    assert not P.recording()
    prog = box["program"]
    assert prog["frames"] >= SMALL["trace_start"] + SMALL["trace_frames"]
    parts = sum(prog[n[:-len(".live")]] for n in program_spans.READERS[:4])
    assert 0 < parts <= prog["host_mid_ms"]
    assert prog["host_mid_counts"]["native"] in ([0], [1])
    assert prog["frame_cover"][0] >= 0.9
    assert "stage_device_s" not in prog         # no device ops on the CPU
