"""The port's profiling (stereovision_tpu_torch/profiling.py) held against
the JAX package's.

StageTimer's report line for line, with time.perf_counter replaced by the
same clock in both modules; profile_pipeline on 160x120 engines: JAX's
section names, and each stage's outputs (descriptors, support grid,
geometry, D1 and D2) equal to the JAX stages' on the same seeded pair;
sync; device_trace writing a Chrome trace on the CPU.  The test marked
`cuda` (skipped without a card) asserts that a trace of one
process_frame names the CUDA functions of all four kernels.  The JAX
package is imported inside the tests that use it, so that the card's
test run, which has no jax, can collect this file:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import itertools
import json
import os
import os.path as osp
import time

import numpy as np
import pytest
import torch

from stereovision_tpu_torch import profiling as P
from stereovision_tpu_torch.engine import StereoEngine
from stereovision_tpu_torch.synthetic import stereo_pair

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
