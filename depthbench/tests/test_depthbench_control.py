"""The check fails where it should: the control (the reference with its
plane tables and reprojection in bfloat16, in the program's place) and
the faults a cell can have, each planted under the timed path of a whole
run on the CPU at 160x120 with the look for a card skipped:

  a step that returns its state unchanged (stage B hands back its first
  result for every later frame);
  half of a batch left out (the log mix's batched stage B computes the
  first half and repeats it);
  an answer altered where it is produced (one pixel of the display
  disparity moved by 1 in the reprojection).

The exchange between chips has no fault here: every cell takes one chip.
"""

import os
import time

import pytest
import torch

from depthbench import check, control, frames, harness
from depthbench.reference.pipeline import Reference

ROOT = harness.ROOT
SMALL = {"width": 160, "height": 120, "trace_start": 2, "trace_frames": 3}
CALIB = os.path.join(ROOT, "depthbench", "data", "kitti_2011_09_26.yml")


# BENCHMARK.json with the cells kept for later: the subsampled cell and
# the log mix's cells, with their metrics
LATER = harness.load_bench(later=True)


def run(cell, traced=False):
    return harness.run_cell(cell, 424242424242, 1.5, traced,
                            time.perf_counter(), device="cpu",
                            overrides=dict(SMALL), log=lambda s: None,
                            bench=LATER)


@pytest.mark.parametrize("sub", [False, True], ids=["full", "sub"])
def test_control_fails(sub):
    name = "kitti_sub" if sub else "kitti_full"
    config = harness.load_json(os.path.join(ROOT, "depthbench", "configs",
                                            name + ".json"))
    config.update(width=160, height=120)
    limits = check.limits_of(config)
    checks = check.modules(limits)
    ref = Reference(CALIB, 160, 120, sub)
    ps = frames.pairs({"width": 160, "height": 120}, {"pairs": 4}, 31)
    refs = {k: ref.frame(*p) for k, p in enumerate(ps)}

    def compare(outs):
        served = {k: [{n: m.keep(outs[n][k], True)
                       for n, m in checks.items()}] for k in range(len(ps))}
        return check.compare(served, refs, ps, config, "cpu", checks)
    # the control as control.py computes it: the stereo readings have no
    # control of their own, so both read the reference in bfloat16
    r = compare(control.control_outputs(checks, ps, config, "cpu"))
    ok, rows = check.verdict(r, limits, 0)
    assert not ok
    assert r["points_rel"] > limits["points_rel"]
    # and the reference against itself passes
    mine = {k: ref.frame(*p) for k, p in enumerate(ps)}
    assert check.verdict(compare({n: mine for n in checks}), limits, 0)[0]


def _stale(monkeypatch):
    from stereovision_tpu_torch.models.elas import ElasEngine
    real = ElasEngine.stage_dense
    first = {}

    def stage_dense(self, *a, **k):
        out = real(self, *a, **k)
        key = tuple(out[0].shape)
        first.setdefault(key, tuple(t.clone() for t in out))
        return tuple(t.clone() for t in first[key])
    monkeypatch.setattr(ElasEngine, "stage_dense", stage_dense)


def _altered(monkeypatch):
    from stereovision_tpu_torch.engine import StereoEngine
    real = StereoEngine.reproject

    def reproject(self, D1):
        dmap, points = real(self, D1)
        dmap = dmap.clone()
        dmap[..., 5, 5] += 1
        return dmap, points
    monkeypatch.setattr(StereoEngine, "reproject", reproject)


def _half_batch(monkeypatch):
    from stereovision_tpu_torch.models.elas import ElasEngine
    real = ElasEngine.stage_dense_batched

    def stage_dense_batched(self, desc1, desc2, buf):
        h = max(desc1.shape[0] // 2, 1)
        D1, D2 = real(self, desc1[:h].contiguous(), desc2[:h].contiguous(),
                      buf[:h].contiguous())
        idx = torch.arange(desc1.shape[0]) % h
        return D1[idx].contiguous(), D2[idx].contiguous()
    monkeypatch.setattr(ElasEngine, "stage_dense_batched",
                        stage_dense_batched)


FAULTS = {"state_unchanged": _stale, "answer_altered": _altered,
          "half_batch": _half_batch}
CASES = ([(c, f) for c in ("kitti_full.live", "kitti_sub.live")
          for f in ("state_unchanged", "answer_altered")]
         + [(c, f) for c in ("kitti_full.log", "kitti_sub.log")
            for f in ("state_unchanged", "answer_altered", "half_batch")])


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    r = run(cell)
    assert r["correct"] is False
    assert r["checks"]["dmap_px"]["value"] > r["checks"]["dmap_px"]["limit"]


@pytest.mark.parametrize("cell", ["kitti_full.log", "kitti_sub.log"])
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_log_mix_runs_whole(cell, traced):
    """The log mix, kept for later cells, runs through the harness: the
    stream's frames correct, its metrics present, the pool used."""
    r = run(cell, traced)
    assert r["correct"] is True and r["failed"] == 0
    if traced:
        assert "host_mid_ms.log" in r["metrics"]
    else:
        assert set(r["metrics"]) == {"stream_fps", "setup_s"}
