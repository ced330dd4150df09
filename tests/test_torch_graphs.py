"""The one-dispatch mode (graphs.StageGraph, ElasEngine.process_jit), held
against the JAX package.

On the CPU there is no graph: process_jit runs its two stages eagerly and
must equal the JAX package's process_jit (the pure_callback path, as
tests/test_engine.py runs it) and the port's process bit for bit, at
160x120 in four presets, at full resolution and subsampled.  StageGraph's
capture path and launch accounting run on a stand-in for
torch.cuda.CUDAGraph, as does the pause of the cyclic collector while
captures on two threads overlap.

StereoEngine.process_frame runs its three stages (A, B and the
reprojection) through StageGraph: on the CPU eagerly, equal to
ElasEngine.process followed by reproject in every fetch mode, the root
svtt.frame counting no graph.  On a stand-in whose replays overwrite their
static outputs, process_frame and process_jit, which share one replay
turn (graphs.ReplayTurn), each hand back tensors that outlive the next
frames, give two threads their own frames, and drop their graphs on
close().

The tests marked `cuda` (skipped without a card) capture and replay the
stages on the card: process_jit equal to the eager path, two graph pairs
replayed from two threads, the launch counters after replays,
process_frame's replays equal to the eager stages at
1242x375 (full resolution and subsampled, every fetch mode, the launch
counters alike) and released by close(), and a function that cannot be
captured raising instead of running eagerly.  The JAX package is imported inside the tests that use
it, so that the card's test run, which has no jax, can collect this file:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import dataclasses
import gc
import os.path as osp
import threading

import numpy as np
import pytest
import torch

from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
from stereovision_tpu_torch.graphs import StageGraph
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.ops.cuda import (_lib, ccl_cu, lr_cu,
                                             matching_cu, support_cu)
from stereovision_tpu_torch.params import app_params, robotics_params
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
W, H = 160, 120
# name: (params function, keyword arguments); the same in both packages
PRESETS = {
    "app": ("app_params", {}),
    "robotics": ("robotics_params", {}),
    "app_sub": ("app_params", {"subsampling": True}),
    "robotics_sub": ("robotics_params", {"subsampling": True}),
}
WRAPPERS = {"matching": matching_cu, "support": support_cu,
            "lr_check": lr_cu, "speckle_ccl": ccl_cu}


def _jax_params(name):
    from stereovision_tpu import params as jparams
    fn, kw = PRESETS[name]
    return getattr(jparams, fn)(**kw).replace(disp_max=63)


def _port_params(name):
    fn, kw = PRESETS[name]
    return {"app_params": app_params,
            "robotics_params": robotics_params}[fn](**kw).replace(disp_max=63)


def _gray_pair(seed, w=W, h=H):
    left, right, _ = stereo_pair(w, h, seed)
    return bgr_to_gray(left), bgr_to_gray(right)


def _eq(port, ref):
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


def test_port_presets_are_the_jax_presets():
    for name in PRESETS:
        assert _port_params(name) == params_from_dict(
            dataclasses.asdict(_jax_params(name)))


# ---- StageGraph on the CPU, with a stand-in for the CUDA graph -------------


class StandIn:
    """torch.cuda.CUDAGraph's interface on the CPU: the capture brackets a
    call, which runs eagerly; a replay runs nothing and is counted."""

    def __init__(self, fail_replay=False):
        self.begun = self.ended = self.replays = 0
        self.kwargs = None
        self.fail_replay = fail_replay

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.begun += 1
        self.kwargs = dict(pool=pool, capture_error_mode=capture_error_mode)

    def capture_end(self):
        self.ended += 1

    def replay(self):
        if self.fail_replay:
            raise RuntimeError("CUDA error: an illegal memory access")
        self.replays += 1

    def pool(self):
        return ("pool", id(self))


def test_stage_graph_adds_recorded_launches_at_each_replay():
    """The warm-up launches and counts; the capture records the counts and
    adds none; each replay adds them, runs no Python, copies its inputs
    into the static ones and hands back the static outputs."""
    ns = {"launches": 0, "merges": 0}
    calls = []

    def fn(x):
        calls.append(x.clone())
        _lib.count(ns)
        _lib.count(ns)
        _lib.count(ns, "merges")
        return x * 2, x + 1

    x0 = torch.arange(6.0).reshape(2, 3)
    sg = StageGraph("stage A", fn, (x0,), graph=StandIn)
    assert len(calls) == 2                       # warm-up, capture
    assert ns == {"launches": 2, "merges": 1}    # the warm-up's
    assert sg.counts == [(ns, "launches")] * 2 + [(ns, "merges")]
    assert sg.graph.begun == sg.graph.ended == 1
    assert sg.graph.kwargs == {"pool": None,
                               "capture_error_mode": "thread_local"}
    assert sg.static[0] is x0
    out = sg.outputs
    for k in range(1, 4):
        x = np.full((2, 3), float(k), np.float32)
        assert sg(x) is out
        assert torch.equal(sg.static[0], torch.from_numpy(x))
        assert sg.graph.replays == k
        assert ns == {"launches": 2 + 2 * k, "merges": 1 + k}
    assert len(calls) == 2
    assert sg(sg.static[0]) is out               # read in place
    assert ns == {"launches": 10, "merges": 5}
    b = StageGraph("stage B", lambda y: y * 3, (out[0],), pool=sg.pool,
                   graph=StandIn)
    assert b.graph.kwargs["pool"] == sg.pool
    assert b.static[0] is out[0]
    with pytest.raises(ValueError, match="stage A: an input of"):
        sg(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="stage A: 2 inputs"):
        sg(x0, x0)


def test_stage_graph_capture_and_replay_failures_raise():
    """A capture that fails raises RuntimeError naming the stage, closes
    the capture and never runs the function eagerly in its place; so does
    a failed replay, which adds no counts."""
    ns = {"launches": 0}
    n = [0]

    def fn(x):
        n[0] += 1
        _lib.count(ns)
        if n[0] == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x

    graphs = []

    def make():
        graphs.append(StandIn())
        return graphs[-1]

    with pytest.raises(RuntimeError,
                       match="stage B: CUDA graph capture failed") as info:
        StageGraph("stage B", fn, (torch.zeros(2),), graph=make)
    assert "not permitted" in str(info.value.__cause__)
    assert n[0] == 2 and graphs[0].ended == 1
    assert ns["launches"] == 1
    _lib.count(ns)                       # recording ended with the failure
    assert ns["launches"] == 2

    sg = StageGraph("stage A", lambda x: (_lib.count(ns), x)[1],
                    (torch.zeros(2),),
                    graph=lambda: StandIn(fail_replay=True))
    before = ns["launches"]
    with pytest.raises(RuntimeError,
                       match="stage A: CUDA graph replay failed"):
        sg(torch.ones(2))
    assert ns["launches"] == before


def test_stage_graph_pauses_the_cyclic_collector_while_capturing():
    """The capture runs with Python's cyclic collector off (it would run
    destructors, such as a CUDA graph's, on the capturing thread), and the
    collector is on again after it, also when the capture fails."""
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x

    assert gc.isenabled()
    StageGraph("stage A", fn, (torch.zeros(2),), graph=StandIn)
    assert seen == [True, False] and gc.isenabled()

    def failing(x):
        seen.append(gc.isenabled())
        if len(seen) == 4:
            raise RuntimeError("capture failed")
        return x

    with pytest.raises(RuntimeError, match="capture failed"):
        StageGraph("stage B", failing, (torch.zeros(2),), graph=StandIn)
    assert seen[2:] == [True, False] and gc.isenabled()


@pytest.mark.parametrize("initially_on", [True, False])
def test_overlapping_captures_keep_the_collector_paused(initially_on):
    """Captures on two threads overlap, and the first ends while the
    second is still under way: the collector stays off until the last
    capture ends, and is then as it was before the first."""
    started = {"a": threading.Event(), "b": threading.Event()}
    a_done = threading.Event()
    seen, errors = {}, []

    def capturing(name, other, wait_for_a):
        calls = [0]

        def fn(x):
            calls[0] += 1
            if calls[0] == 2:                    # under capture
                started[name].set()
                assert started[other].wait(60)
                seen[name] = gc.isenabled()
                if wait_for_a:
                    assert a_done.wait(60)
                    seen["b, a's capture over"] = gc.isenabled()
            return x
        return fn

    def run(name, other, wait_for_a):
        try:
            StageGraph("stage " + name, capturing(name, other, wait_for_a),
                       (torch.zeros(2),), graph=StandIn)
            if not wait_for_a:
                seen["a, its capture over"] = gc.isenabled()
                a_done.set()
        except Exception as err:             # reported by the main thread
            errors.append(err)
            a_done.set()

    was_on = gc.isenabled()
    (gc.enable if initially_on else gc.disable)()
    try:
        threads = [threading.Thread(target=run, args=("a", "b", False)),
                   threading.Thread(target=run, args=("b", "a", True))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert seen == {"a": False, "b": False, "a, its capture over": False,
                        "b, a's capture over": False}
        assert gc.isenabled() == initially_on
    finally:
        (gc.enable if was_on else gc.disable)()


def test_stage_graph_is_eager_on_the_cpu():
    """With no graph on the CPU, each call runs the function on its inputs
    (NumPy or tensors) and counts as the function does."""
    ns = {"launches": 0}

    def fn(x):
        _lib.count(ns)
        return x + 1

    sg = StageGraph("stage A", fn, device="cpu")
    assert sg.graph is None and sg.pool is None and ns["launches"] == 0
    assert torch.equal(sg(np.zeros(3, np.int32)),
                       torch.ones(3, dtype=torch.int32))
    assert torch.equal(sg(torch.ones(2)), torch.full((2,), 2.0))
    assert ns["launches"] == 2


def test_recording_is_per_thread():
    """While one thread records a capture, launches of other threads are
    counted as they happen."""
    ns = {"launches": 0}
    with _lib.recording() as rec:
        _lib.count(ns)
        t = threading.Thread(target=lambda: [_lib.count(ns)
                                             for _ in range(5)])
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert rec == [(ns, "launches")]
    assert ns["launches"] == 5
    _lib.add_counts(rec)
    assert ns["launches"] == 6


# ---- process_jit against the JAX package ----------------------------------


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_process_jit_matches_jax_and_process(preset):
    """Two frames through one engine's process_jit: D1 and D2 equal JAX's
    process_jit and the port's process."""
    import jax.numpy as jnp
    from stereovision_tpu.models.elas import ElasEngine as JaxElas
    je = JaxElas(_jax_params(preset), W, H)
    pe = ElasEngine(_port_params(preset), W, H, device="cpu")
    for seed in (3, 4):
        L, R = _gray_pair(seed)
        J1, J2 = je.process_jit(jnp.asarray(L), jnp.asarray(R))
        D1, D2 = pe.process_jit(L, R)
        E1, E2 = pe.process(L, R)
        _eq(D1, J1)
        _eq(D2, J2)
        assert torch.equal(D1, E1) and torch.equal(D2, E2)
    graphs = pe.process_jit.graphs
    assert [g.graph for g in graphs] == [None, None]     # eager on the CPU
    pe.close()
    assert "process_jit" not in vars(pe)


# ---- process_frame's graphs on the CPU --------------------------------------


class Replaying(StandIn):
    """A stand-in whose replay runs its stage's function on the static
    inputs and writes the results into the static outputs, as a CUDA
    graph's replay does: the next replay overwrites what the last gave."""

    stage = None

    def replay(self):
        super().replay()
        sg = self.stage
        outs, new = sg.outputs, sg.fn(*sg.static)
        for dst, src in (zip(outs, new) if isinstance(outs, tuple)
                         else [(outs, new)]):
            dst.copy_(src)


class ReplayingStageGraph(StageGraph):
    """StageGraph on the Replaying stand-in, also on the CPU."""

    def __init__(self, *args, **kwargs):
        kwargs["graph"] = Replaying
        super().__init__(*args, **kwargs)
        self.graph.stage = self


@pytest.fixture
def replaying(monkeypatch):
    """process_frame's graphs made on the Replaying stand-in."""
    from stereovision_tpu_torch import engine as engine_mod
    from stereovision_tpu_torch.models import elas as elas_mod
    monkeypatch.setattr(engine_mod, "StageGraph", ReplayingStageGraph)
    monkeypatch.setattr(elas_mod, "StageGraph", ReplayingStageGraph)


@pytest.fixture(scope="module")
def small():
    eng = StereoEngine(CALIB, W, H, device="cpu")
    pairs = [stereo_pair(W, H, seed=s)[:2] for s in (3, 4, 5)]
    refs = [_eager_frame(eng, *pair) for pair in pairs]
    yield eng, pairs, refs
    eng.close()


def _eager_frame(eng, left, right):
    """The eager stages of one frame: ElasEngine.process, then reproject
    of D1 -> (D1, dmap, points (pc_h, pc_w, 3)), each cloned."""
    D1, _ = eng.elas.process(bgr_to_gray(left), bgr_to_gray(right))
    dmap, points = eng.reproject(D1)
    return tuple(x.clone() for x in (D1, dmap, points))


def _check_frame(out, ref, fetch):
    """process_frame's output against _eager_frame's: types by fetch mode,
    values bit for bit."""
    D1, dmap, points = (x.cpu() for x in ref)
    assert torch.is_tensor(out["disparity"])
    _eq(out["disparity"], D1.numpy())
    if fetch == "device":
        assert torch.is_tensor(out["dmap"])
    else:
        assert isinstance(out["dmap"], np.ndarray)
    _eq(out["dmap"], dmap.numpy())
    if fetch == "host":
        assert isinstance(out["points"], np.ndarray)
        _eq(out["points"], points.reshape(-1, 3).numpy())
    else:
        assert torch.is_tensor(out["points"])
        _eq(out["points"], points.numpy())


@pytest.mark.parametrize("fetch", ["host", "dmap", "device"])
def test_process_frame_equals_the_eager_stages(small, fetch):
    """On the CPU process_frame's three stages run eagerly (no graph) and
    every frame equals ElasEngine.process followed by reproject."""
    eng, pairs, refs = small
    for pair, ref in zip(pairs, refs):
        _check_frame(eng.process_frame(*pair, fetch=fetch), ref, fetch)
    assert [g.graph for g in eng.frame_turn.graphs] == [None] * 3


def test_process_frame_root_counts_no_graph_on_the_cpu(small):
    """The root svtt.frame carries graphs = 0 on the CPU."""
    from stereovision_tpu_torch import profiling as P
    eng, pairs, _ = small
    P.trace_stop()
    P.trace_drain()
    P.trace_start()
    try:
        eng.process_frame(*pairs[0])
    finally:
        P.trace_stop()
    roots = [s for s in P.trace_drain()["spans"] if s.name == "svtt.frame"]
    assert [r.counts for r in roots] == [{"entry": "process_frame",
                                          "graphs": 0}]


@pytest.mark.parametrize("fetch", ["dmap", "device"])
def test_process_frame_outputs_outlive_the_next_replay(small, replaying,
                                                       fetch):
    """With graphs whose replays reuse their static outputs, the tensors
    that a frame returns keep its values after the next frames' replays
    (the NumPy arrays of a host fetch are copies on the card, views on
    the CPU); each frame replays each graph once; close() drops the
    graphs and the next call captures new ones."""
    _, pairs, refs = small
    eng = StereoEngine(CALIB, W, H, device="cpu")
    outs = [eng.process_frame(*pair, fetch=fetch) for pair in pairs]
    graphs = tuple(eng.frame_turn.graphs)
    # stage A replayed once more for stage B's capture
    assert [g.graph.replays for g in graphs] == [len(pairs) + 1,
                                                 len(pairs), len(pairs)]
    assert graphs[2].static[0] is graphs[1].outputs[0]
    assert graphs[1].graph.kwargs["pool"] == graphs[0].pool
    assert graphs[2].graph.kwargs["pool"] == graphs[0].pool
    for out, (D1, dmap, points) in zip(outs, refs):
        _eq(out["disparity"], D1.numpy())
        _eq(out["points"], points.numpy())
        if fetch == "device":
            _eq(out["dmap"], dmap.numpy())
    eng.close()
    assert eng.frame_turn.graphs == []
    _check_frame(eng.process_frame(*pairs[1], fetch="device"), refs[1],
                 "device")
    assert all(g.graph.begun == 1 and g.graph.replays == 1
               for g in eng.frame_turn.graphs[1:])
    assert not any(a is b for a, b in zip(graphs, eng.frame_turn.graphs))
    eng.close()


@pytest.fixture(scope="module")
def small_jit(small):
    """small's pairs in gray, and ElasEngine.process's (D1, D2) of each,
    cloned."""
    eng, pairs, _ = small
    grays = [tuple(bgr_to_gray(x) for x in pair) for pair in pairs]
    return grays, [tuple(x.clone() for x in eng.elas.process(*g))
                   for g in grays]


def test_process_jit_outputs_outlive_the_next_replay(small_jit, replaying):
    """process_jit takes the same turns on the same stand-in: the D1 and
    D2 that a frame returns keep its values after the next frames'
    replays; each frame replays each graph once; close() drops the
    graphs and the next call captures new ones."""
    grays, refs = small_jit
    elas = ElasEngine(app_params(), W, H, device="cpu")
    outs = [elas.process_jit(*g) for g in grays]
    graphs = tuple(elas.process_jit.graphs)
    assert [g.graph.replays for g in graphs] == [len(grays) + 1,
                                                 len(grays)]
    assert graphs[1].graph.kwargs["pool"] == graphs[0].pool
    for out, ref in zip(outs, refs):
        for a, b in zip(out, ref):
            _eq(a, b.numpy())
    made = elas.process_jit.graphs
    elas.close()
    assert made == [] and "process_jit" not in vars(elas)
    for a, b in zip(elas.process_jit(*grays[1]), refs[1]):
        _eq(a, b.numpy())
    new = elas.process_jit.graphs
    assert new[1].graph.begun == 1 and new[1].graph.replays == 1
    assert not any(a is b for a, b in zip(graphs, new))
    elas.close()


def _two_threads(call):
    """call(t, k) for k = 0, 1, 2 on each of two threads t = 0, 1 at once,
    with a short switch interval -> {(t, k): what the call returned}."""
    import sys
    got, errors = {}, []

    def work(t):
        try:
            for k in range(3):
                got[t, k] = call(t, k)
        except Exception as err:            # reported by the main thread
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 6
    return got


def test_process_frame_two_threads_each_get_their_frames(small, replaying):
    """Two threads call one engine whose graphs reuse their static
    outputs, 3 frames each, with a short switch interval: every frame's
    tensors are that frame's."""
    _, pairs, refs = small
    eng = StereoEngine(CALIB, W, H, device="cpu")

    def call(t, k):
        i = (t + k) % len(pairs)
        return i, eng.process_frame(*pairs[i], fetch="device")

    for i, out in _two_threads(call).values():
        _check_frame(out, refs[i], "device")
    assert [g.graph.replays for g in eng.frame_turn.graphs] == [7, 6, 6]
    eng.close()


def test_process_jit_two_threads_each_get_their_frames(small_jit,
                                                       replaying):
    """process_jit's turn alike: two threads, 3 frames each, every
    frame's D1 and D2 that frame's."""
    grays, refs = small_jit
    elas = ElasEngine(app_params(), W, H, device="cpu")

    def call(t, k):
        i = (t + k) % len(grays)
        return i, elas.process_jit(*grays[i])

    for i, out in _two_threads(call).values():
        for a, b in zip(out, refs[i]):
            _eq(a, b.numpy())
    assert [g.graph.replays for g in elas.process_jit.graphs] == [7, 6]
    elas.close()


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture and replay "
                    "only on the card")
    return torch.device("cuda")


def _zero_counts():
    for m in WRAPPERS.values():
        m.launches = 0


def _counts():
    return {k: m.launches for k, m in WRAPPERS.items()}


def _per_frame(p, n):
    return {"matching": 2 * n, "support": n, "lr_check": n,
            "speckle_ccl": n * (1 if p.postprocess_only_left else 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["app", "robotics_sub"])
def test_process_jit_on_the_card_equals_eager(cuda, preset):
    """process_jit replays both stages from graphs: every frame equal to
    eager process and to the CPU's, launch counts one a frame (K1 two)."""
    p = _port_params(preset)
    eng = ElasEngine(p, W, H, device=cuda)
    cpu = ElasEngine(p, W, H, device="cpu")
    frames = [_gray_pair(s) for s in range(3)]
    eng.process_jit(*frames[0])
    assert all(g.graph is not None for g in eng.process_jit.graphs)
    _zero_counts()
    got = [eng.process_jit(*f) for f in frames]
    torch.cuda.synchronize()
    assert _counts() == _per_frame(p, len(frames))
    for f, (D1, D2) in zip(frames, got):
        E1, E2 = eng.process(*f)
        C1, C2 = cpu.process(*f)
        assert torch.equal(D1, E1) and torch.equal(D2, E2)
        assert torch.equal(D1.cpu(), C1) and torch.equal(D2.cpu(), C2)


@pytest.mark.cuda
def test_graph_pairs_replayed_from_two_threads(cuda):
    """Two graph pairs, each replayed from its own thread on its own
    stream, 4 frames each: every frame equal to eager process."""
    p = _port_params("app")
    eng = ElasEngine(p, W, H, device=cuda)
    pairs = [eng.stage_graphs() for _ in range(2)]
    frames = [_gray_pair(s) for s in range(8)]
    refs = [tuple(x.clone() for x in eng.process(*f)) for f in frames]
    torch.cuda.synchronize()
    got = {}

    def work(t):
        torch.cuda.set_stream(torch.cuda.Stream(cuda))
        stage_a, stage_b = pairs[t]
        for i in range(t, len(frames), 2):
            d1, d2, dc = stage_a(*frames[i])
            buf = eng.pack_geometry(eng.host_mid(dc.cpu().numpy()))
            got[i] = tuple(x.clone() for x in stage_b(d1, d2, buf))
        torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == list(range(len(frames)))
    for i, ref in enumerate(refs):
        assert all(torch.equal(a, b) for a, b in zip(got[i], ref)), i


@pytest.mark.cuda
def test_launch_counters_after_replays(cuda):
    """The capture adds no launch and records the stage's; each replay
    adds them."""
    p = _port_params("app")
    eng = ElasEngine(p, W, H, device=cuda)
    _zero_counts()
    stage_a, stage_b = eng.stage_graphs()
    # the warm-ups launched once, and stage A replayed once for B's
    assert _counts() == {"matching": 2, "support": 2, "lr_check": 1,
                         "speckle_ccl": 1}
    assert sorted(k for _, k in stage_b.counts) == ["launches"] * 4
    f = _gray_pair(1)
    _zero_counts()
    for _ in range(5):
        d1, d2, dc = stage_a(*f)
        stage_b(d1, d2, eng.pack_geometry(eng.host_mid(dc.cpu().numpy())))
    assert _counts() == _per_frame(p, 5)


@pytest.mark.cuda
def test_capture_survives_a_cycle_holding_a_graph(cuda):
    """A CUDA graph whose last reference moves into a reference cycle
    during a capture, with enough allocations after it to start the
    cyclic collector: destroying the graph there would void the capture,
    so the collector waits until the capture is over."""
    victims = [StageGraph("victim", lambda y: y + 1,
                          (torch.ones(4, device=cuda),)).graph]
    calls = [0]

    class Holder:
        pass

    def fn(y):
        calls[0] += 1
        if calls[0] == 2:                # under capture
            h = Holder()
            h.me, h.graph = h, victims.pop()
            del h
            keep = [[] for _ in range(5000)]
            del keep
        return y * 2

    sg = StageGraph("stage", fn, (torch.ones(4, device=cuda),))
    assert not victims
    assert torch.equal(sg(torch.full((4,), 3.0)).cpu(),
                       torch.full((4,), 6.0))
    gc.collect()


@pytest.mark.cuda
def test_uncapturable_function_raises(cuda):
    """A function that reads a value back to the host cannot be captured:
    StageGraph raises, naming the stage, and does not run it eagerly; the
    card stays usable and a capturable function captures after it."""
    calls = [0]

    def bad(x):
        calls[0] += 1
        return x * float(x.sum().item())

    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="probe: CUDA graph capture "
                                           "failed"):
        StageGraph("probe", bad, (x,))
    assert calls[0] == 2                  # the warm-up and the capture
    torch.cuda.synchronize()
    good = StageGraph("good", lambda y: y * 2, (x,))
    assert torch.equal(good(torch.full((4,), 3.0)).cpu(),
                       torch.full((4,), 6.0))


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", [False, True], ids=["full", "sub"])
def test_process_frame_on_the_card_equals_eager(cuda, subsampling):
    """process_frame replays its three graphs: at 1242x375, full
    resolution and subsampled, 3 seeds in every fetch mode, D1, dmap and
    points equal bit for bit to eager ElasEngine.process followed by
    reproject; every svtt.frame counts 3 graphs; the launch counters add
    what the eager path's do."""
    from stereovision_tpu_torch import profiling as P
    kw, kh = 1242, 375
    eng = StereoEngine(CALIB, kw, kh, subsampling=subsampling, device=cuda)
    pairs = [stereo_pair(kw, kh, seed=s)[:2] for s in (11, 12, 13)]
    _zero_counts()
    refs = [_eager_frame(eng, *pair) for pair in pairs]
    torch.cuda.synchronize()
    eager = _counts()
    eng.process_frame(*pairs[0])
    assert all(g.graph is not None for g in eng.frame_turn.graphs)
    P.trace_stop()
    P.trace_drain()
    P.trace_start()
    try:
        for fetch in ("host", "dmap", "device"):
            _zero_counts()
            outs = [eng.process_frame(*pair, fetch=fetch) for pair in pairs]
            torch.cuda.synchronize()
            assert _counts() == eager, fetch
            for out, ref in zip(outs, refs):
                _check_frame(out, ref, fetch)
    finally:
        P.trace_stop()
    roots = [s for s in P.trace_drain()["spans"] if s.name == "svtt.frame"]
    assert [r.counts for r in roots] == [{"entry": "process_frame",
                                          "graphs": 3}] * 9
    eng.close()


@pytest.mark.cuda
def test_process_frame_close_releases_its_graphs(cuda):
    """close() drops process_frame's graphs and their memory; the next
    call captures new ones, and both give the eager frame."""
    eng = StereoEngine(CALIB, W, H, params=_port_params("app"), device=cuda)
    pair = stereo_pair(W, H, seed=1)[:2]
    ref = _eager_frame(eng, *pair)
    first = eng.process_frame(*pair, fetch="device")
    graphs = tuple(eng.frame_turn.graphs)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda)
    eng.close()
    assert eng.frame_turn.graphs == []
    del graphs
    gc.collect()
    assert torch.cuda.memory_allocated(cuda) < held
    second = eng.process_frame(*pair, fetch="device")
    assert all(g.graph is not None for g in eng.frame_turn.graphs)
    for out in (first, second):
        _check_frame(out, ref, "device")
    eng.close()
