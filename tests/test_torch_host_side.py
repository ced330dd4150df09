"""The host middle's side worker (stereovision_tpu_torch/hostlib/side.py):
geometry.host_mid with the right image's half in a spawned, pinned worker
process, held to the same call with both halves in this process.

  (a) every array and the warnings byte-equal, in their order: synthetic
      support grids at 1242x375 (full resolution and subsampled, with and
      without the host filters) and at 160x120; fewer than 3 points,
      collinear points and empty grids; thinning past n_max; a span
      overflow with a small s_max, also through the warnings module;
  (b) with recording on: the frame's two .delaunay, .raster and
      .span_code spans (the right's from the worker, in the frame), the
      .join span and the count side 1;
  (c) the worker's affinity is one CPU of the process's set, the
      process's own set unchanged; a worker another frame holds is not
      waited for, also by more threads than CPUs; CPU engines start none;
  (d) a worker killed between calls: equal bytes with side 0, on every
      later call; close() ends the worker and can be called twice;
  (e) on the card (marked cuda): process_frame over 8 KITTI-size pairs
      with the worker engaged equals the CPU engine's dmap and cloud.

The workers of (a)-(c) are started once for the module, one a set of
host arguments (a worker takes its engine's once), all at once so that
their imports overlap.

    python -m pytest tests/test_torch_host_side.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_host_side.py
"""

import collections
import os
import os.path as osp
import warnings

import numpy as np
import pytest
import torch

from stereovision_tpu_torch import profiling as P
from stereovision_tpu_torch.engine import StereoEngine
from stereovision_tpu_torch.hostlib import geometry, side
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.params import app_params, robotics_params
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
KEYS = ["pts", "tri_l", "tri_r", "tris_l", "tris_r"]
# name: (params, width, height, s_max in place of the engine's)
CONFIGS = {
    "kitti": (app_params(), 1242, 375, None),
    "kitti_sub": (app_params(subsampling=True), 1242, 375, None),
    "small": (robotics_params(), 160, 120, None),      # no corner points
    "overflow": (app_params(), 160, 120, 2),
}


def _host_args(name):
    p, w, h, s_max = CONFIGS[name]
    args = ElasEngine(p, w, h, device="cpu").host_args
    return args if s_max is None else args[:5] + (s_max,) + args[6:]


def _need_two_cpus():
    if len(os.sched_getaffinity(0)) < 2:
        pytest.skip("the process may use one CPU: no side worker starts")


@pytest.fixture(scope="module")
def workers():
    _need_two_cpus()
    started = {name: side.start(_host_args(name)) for name in CONFIGS}
    try:
        for w in started.values():
            assert w.ready(timeout=120)
        yield started
    finally:
        for w in started.values():
            w.close()


class _Spy:
    """A SideWorker as host_mid sees it, noting whether the worker took
    each frame's half (took) and whether it came back (back)."""

    def __init__(self, worker):
        self.worker, self.took, self.back = worker, [], []

    def submit(self, pts, trace):
        ok = self.worker.submit(pts, trace)
        self.took.append(ok)
        return ok

    def result(self):
        out = self.worker.result()
        self.back.append(out is not None)
        return out


def _grid(name, seed, holes=0.3):
    """A seeded (Hc, Wc) int16 support grid of the configuration: a
    sloped disparity field with +-1 noise and holes (-1)."""
    p, w, h, _ = CONFIGS[name]
    hc, wc = -(-h // p.step), -(-w // p.step)
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:hc, 0:wc]
    d = 20 + u // (3 + seed % 4) + v // 4 + rng.integers(-1, 2, (hc, wc))
    d[rng.random((hc, wc)) < holes] = -1
    return d.astype(np.int16)


def _both(worker, d_can, args):
    """host_mid of d_can in this process, then with the worker: [(arrays,
    notes)] * 2, and whether the worker computed the right half."""
    spy, outs = _Spy(worker), []
    for s in (None, spy):
        notes = []
        outs.append((geometry.host_mid(d_can, *args, notes=notes, side=s),
                     notes))
    return outs, spy.took == spy.back == [True]


def _assert_same(outs):
    (want, want_notes), (got, got_notes) = outs
    assert sorted(want) == sorted(got) == KEYS
    for k in KEYS:
        assert want[k].dtype == got[k].dtype, k
        assert want[k].shape == got[k].shape, k
        assert np.array_equal(want[k], got[k]), k
    assert got_notes == want_notes


# ---- (a) the same bytes -----------------------------------------------------

@pytest.mark.parametrize("name, seed, host_filters", [
    ("kitti", 0, True), ("kitti", 1, True), ("kitti", 2, True),
    ("kitti", 3, False), ("kitti_sub", 4, True), ("kitti_sub", 5, False),
    ("small", 6, True), ("small", 7, False), ("overflow", 8, True)])
def test_side_equals_in_process(workers, name, seed, host_filters):
    """Synthetic grids: every array and the warnings equal, the right half
    from the worker."""
    args = _host_args(name)[:6] + (host_filters,)
    outs, took = _both(workers[name], _grid(name, seed), args)
    assert took
    _assert_same(outs)
    assert (outs[0][0]["tris_r"][:, 0] >= 0).sum() > 100


def _points(kind):
    """A 160x120 robotics grid (no corner points) holding `kind`."""
    d = np.full((24, 32), -1, np.int16)
    if kind == "two":
        d[3, 4], d[10, 20] = 12, 30
    elif kind == "collinear":
        d[7, 2:30] = 15
    elif kind == "column":
        d[2:22, 9] = 20 + 4 * (np.arange(20) % 3)
    return d


@pytest.mark.parametrize("kind", ["empty", "two", "collinear", "column"])
def test_side_equals_in_process_on_degenerate_points(workers, kind):
    """Fewer than 3 points, points on one row (collinear in both images)
    or one column (collinear in the left image only: the right shifts
    each by its disparity), none at all: the same bytes."""
    outs, took = _both(workers["small"], _points(kind), _host_args("small"))
    assert took
    _assert_same(outs)
    g = outs[1][0]
    assert (g["tris_l"] == -1).all()
    assert (g["tris_r"] == -1).all() == (kind != "column")


def test_side_equals_in_process_on_an_empty_kitti_grid(workers):
    """An empty grid under app_params: the six corner points alone."""
    d = np.full(_grid("kitti", 0).shape, -1, np.int16)
    outs, took = _both(workers["kitti"], d, _host_args("kitti"))
    assert took
    _assert_same(outs)
    assert (outs[0][0]["pts"][:, 0] >= 0).sum() == 6


@pytest.mark.parametrize("name, n_max", [("kitti", 500), ("overflow", 40)])
def test_side_equals_in_process_past_n_max(workers, name, n_max):
    """Thinning past the caller's n_max: the thinning warning first, the
    same points and triangles either way."""
    args = _host_args(name)
    args = args[:3] + (n_max,) + args[4:]
    outs, took = _both(workers[name], _grid(name, 9, holes=0.1), args)
    assert took
    _assert_same(outs)
    assert outs[1][1][0].startswith("support points thinned")
    assert outs[1][0]["pts"].shape == (n_max, 3)


def test_span_overflow_warns_in_the_same_order(workers):
    """s_max 2: both images' overflow warnings, the left's first, in notes
    and through the warnings module alike."""
    args = _host_args("overflow")
    d = _grid("overflow", 10)
    outs, took = _both(workers["overflow"], d, args)
    assert took
    _assert_same(outs)
    assert [m.startswith("tri-span overflow") for m in outs[1][1]] == [
        True, True]
    caught = []
    for s in (None, _Spy(workers["overflow"])):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            geometry.host_mid(d, *args, side=s)
        caught.append([str(w.message) for w in got])
    assert caught[0] == caught[1] == outs[1][1]


# ---- (b) spans --------------------------------------------------------------

def test_spans_of_a_frame_with_the_side_worker(workers):
    """Recording on: the frame's host middle holds the filters, two each
    of .delaunay, .raster and .span_code (the right's three from the
    worker's thread, inside the host middle's interval, in its frame),
    one .join, and counts side 1; the bytes equal the sequential call's
    with recording on."""
    args = _host_args("kitti")
    d = _grid("kitti", 11)
    P.trace_stop()
    P.trace_drain()
    P.trace_start()
    try:
        with P.root("svtt.frame", 41):
            want = geometry.host_mid(d, *args)
        with P.root("svtt.frame", 42):
            got = geometry.host_mid(d, *args, side=workers["kitti"])
    finally:
        P.trace_stop()
    spans = P.trace_drain()["spans"]
    for k in KEYS:
        assert np.array_equal(want[k], got[k]), k
    hm = {s.frame_id: s for s in spans if s.name == "svtt.host_mid"}
    assert hm[41].counts["side"] == 0 and hm[42].counts["side"] == 1
    kids = {f: [s for s in spans if s.parent == hm[f].id] for f in hm}
    names = collections.Counter(s.name for s in kids[42])
    assert names == {"svtt.host_mid.filters": 1, "svtt.host_mid.delaunay": 2,
                     "svtt.host_mid.raster": 2, "svtt.host_mid.span_code": 2,
                     "svtt.host_mid.join": 1}
    assert "svtt.host_mid.join" not in {s.name for s in kids[41]}
    here = hm[42].thread_id
    theirs = [s for s in kids[42] if s.thread_id != here]
    assert sorted(s.name for s in theirs) == [
        "svtt.host_mid.delaunay", "svtt.host_mid.raster",
        "svtt.host_mid.span_code"]
    for s in kids[42]:
        assert s.frame_id == 42
        assert hm[42].t0_ns <= s.t0_ns <= s.t1_ns <= hm[42].t1_ns
    codes = sorted(s.counts["runs"] for s in kids[42]
                   if s.name == "svtt.host_mid.span_code")
    assert hm[42].counts["runs_max"] == codes[-1] > 0
    assert hm[42].counts["tris_r"] == hm[41].counts["tris_r"] > 0


# ---- (c) placement and hand-off ---------------------------------------------

def test_the_worker_is_pinned_to_one_cpu(workers):
    """Each worker's affinity is one CPU of the process's set, no two
    workers of the module on one CPU; the process's set is unchanged."""
    mine = os.sched_getaffinity(0)
    cpus = set()
    for w in workers.values():
        assert os.sched_getaffinity(w.pid) == {w.cpu}
        assert w.cpu in mine
        cpus.add(w.cpu)
    assert len(cpus) == min(len(workers), len(mine))
    assert os.sched_getaffinity(0) == mine


def test_a_held_worker_is_not_waited_for(workers):
    """While one frame's half is out, a second submit returns False at
    once (that frame runs in process); the first result comes back."""
    w = workers["small"]
    pts = geometry.support_points(_grid("small", 12), robotics_params(),
                                  160, 120)
    assert w.submit(pts, False)
    try:
        assert not w.submit(pts, False)
    finally:
        out = w.result()
    args = _host_args("small")
    want = geometry.host_side(pts, True, args[0], 160, 120, *args[4:6])
    for a, b in zip(out[:3], want):
        assert np.array_equal(a, b)
    assert w.submit(pts, False)
    assert w.result() is not None


def test_threads_share_one_worker(workers):
    """More threads than CPUs calling host_mid with one worker, the switch
    interval shortened: each call gives the sequential bytes, the worker
    takes some halves, and every thread ends."""
    import sys
    import threading
    args = _host_args("small")
    grids = [_grid("small", 20 + k) for k in range(4)]
    want = [geometry.host_mid(d, *args) for d in grids]
    spy = _Spy(workers["small"])
    bad, n = [], 3 * (os.cpu_count() or 4)

    def run(k):
        for i in range(3):
            got = geometry.host_mid(grids[(k + i) % 4], *args, side=spy)
            if not all(np.array_equal(got[key], want[(k + i) % 4][key])
                       for key in KEYS):
                bad.append((k, i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and len(spy.took) == 3 * n and any(spy.took)
    assert spy.back == [True] * spy.took.count(True)


def test_cpu_engines_start_no_side_worker():
    eng = ElasEngine(app_params(), 160, 120, device="cpu")
    assert eng.side_worker() is None
    eng.close()
    assert eng.side_worker() is None


# ---- (d) a dead worker and close() ------------------------------------------

def test_a_killed_worker_gives_the_same_bytes_in_process():
    """A worker killed between calls: every later call computes the right
    half in process (side 0), with the same bytes; close() then ends the
    worker, and again."""
    _need_two_cpus()
    args = _host_args("small")
    w = side.start(args)
    try:
        assert w.ready(timeout=120)
        d = _grid("small", 13)
        outs, took = _both(w, d, args)
        assert took
        w._proc.kill()
        w._proc.join(timeout=30)
        assert w._proc.exitcode is not None
        P.trace_stop()
        P.trace_drain()
        P.trace_start()
        try:
            after = [_both(w, d, args) for _ in range(2)]
        finally:
            P.trace_stop()
        hms = [s for s in P.trace_drain()["spans"]
               if s.name == "svtt.host_mid"]
        assert [s.counts["side"] for s in hms] == [0] * 4
        for outs_k, took_k in after:
            assert not took_k
            _assert_same(outs_k)
            _assert_same([outs[0], outs_k[1]])
        assert not w.ready()
    finally:
        w.close()
    w.close()
    assert w._proc.exitcode is not None


def test_close_ends_a_live_worker_twice():
    _need_two_cpus()
    w = side.start(_host_args("small"))
    assert w.ready(timeout=120)
    w.close()
    assert w._proc.exitcode == 0
    w.close()
    assert not w.ready()
    assert not w.submit(np.zeros((0, 3), np.int32), False)


# ---- (e) on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side worker is started by "
                    "card engines only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_process_frame_with_the_side_worker_equals_the_cpu(cuda):
    """8 KITTI-size pairs through process_frame on the card, the worker
    ready: each frame's host middle counts side 1, and the dmap and the
    cloud equal the CPU engine's bit for bit."""
    pairs = [stereo_pair(1242, 375, seed=s)[:2] for s in range(31, 39)]
    eng = StereoEngine(CALIB, 1242, 375, device=cuda)
    cpu = StereoEngine(CALIB, 1242, 375, device="cpu")
    try:
        assert cpu.elas.side_worker() is None
        assert eng.elas.side_worker().ready(timeout=120)
        eng.process_frame(*pairs[0])            # captures the graphs
        P.trace_stop()
        P.trace_drain()
        P.trace_start()
        try:
            outs = [eng.process_frame(*pair) for pair in pairs]
        finally:
            P.trace_stop()
        hms = [s for s in P.trace_drain()["spans"]
               if s.name == "svtt.host_mid"]
        assert [s.counts["side"] for s in hms] == [1] * len(pairs)
        for out, pair in zip(outs, pairs):
            ref = cpu.process_frame(*pair)
            np.testing.assert_array_equal(out["dmap"], ref["dmap"])
            np.testing.assert_array_equal(out["points"], ref["points"])
    finally:
        eng.close()
        cpu.close()
    assert eng.elas._side is None
