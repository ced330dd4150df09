"""The port's streaming paths and batched stages held against the JAX package.

Same NumPy inputs into both, every comparison exact, in the two streamed
configurations at small size: 160x120 under robotics_params(disp_max=63)
and the 192x144 subsampled preset (stage B on the 72x96 lattice).

  (a) each batched glue stage and each batched plain kernel version equals
      jitted jax.vmap of the JAX package's XLA function on a batch of 3;
  (b) the packed geometry is the JAX package's byte for byte, and unpacks
      into the arrays it was packed from;
  (c) host_mid_standalone equals the JAX package's, warnings included;
  (d) stream and stream_batched (5 frames at batch 2, so the last batch is
      padded; threads and the spawn pool; every fetch mode) yield the JAX
      engine's dmap and points, stream_batched those of both of the JAX
      engine's schedules (fused=False, and fused=True, its one-dispatch
      mode, which the port leaves out); the pool falls back to threads
      only when its processes cannot start; stream_batched re-emits the
      workers' warnings and runs again after a call left early;
  (e) close() and the context manager release the worker threads and the
      pool; the launch counters, the pool and the prior table hold under
      many threads.
"""

import dataclasses
import os
import os.path as osp
import subprocess
import sys
import threading
import warnings
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereovision_tpu.engine import StereoEngine as JaxStereo
from stereovision_tpu.models.elas import ElasEngine as JaxElas
from stereovision_tpu.models.elas import host_mid_standalone as j_host_mid
from stereovision_tpu.ops import descriptor as j_desc
from stereovision_tpu.ops import grid as j_grid
from stereovision_tpu.ops import matching as j_match
from stereovision_tpu.ops import planes as j_planes
from stereovision_tpu.ops import postprocess as j_post
from stereovision_tpu.ops import spans as j_spans
from stereovision_tpu.ops import support as j_support
from stereovision_tpu.params import robotics_params as j_robotics_params

from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
from stereovision_tpu_torch.hostlib.geometry import host_mid_standalone
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.ops import descriptor, grid, planes
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.ops import spans
from stereovision_tpu_torch.ops.cuda import (_lib, ccl_cu, lr_cu,
                                             matching_cu, support_cu)
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
MODES = {
    # name: (width, height, JAX parameter set)
    "full": (160, 120, lambda: j_robotics_params(disp_max=63)),
    "sub": (192, 144, lambda: j_robotics_params(disp_max=63,
                                                subsampling=True)),
}
BATCH = 3
FRAMES = 5


def _port(jp):
    return params_from_dict(dataclasses.asdict(jp))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(port, ref):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


def _frames(w, h, n, seed0=20):
    return [stereo_pair(w, h, seed0 + i)[:2] for i in range(n)]


# ---- (a) batched stages against jax.vmap -----------------------------------


@pytest.fixture(scope="module", params=sorted(MODES))
def batch_stages(request):
    """A batch of 3 frames through jitted jax.vmap of each XLA stage, and
    the port's parameters and engine for the same mode."""
    w, h, make = MODES[request.param]
    jp = make()
    p = _port(jp)
    je = JaxElas(jp, w, h)
    pe = ElasEngine(p, w, h, device="cpu")
    pairs = np.stack([[bgr_to_gray(lf), bgr_to_gray(rf)]
                      for lf, rf in _frames(w, h, BATCH)])
    vm = lambda f: jax.jit(jax.vmap(f))  # noqa: E731
    desc = vm(vm(j_desc.compute_descriptor))(jnp.asarray(pairs))
    desc1, desc2 = desc[:, 0], desc[:, 1]
    d_can = vm(lambda a, b: j_support.support_matches(
        a, b, jp, apply_filters=False))(desc1, desc2)
    gs = [je.host_mid(np.asarray(d_can[i])) for i in range(BATCH)]
    g = {k: np.stack([x[k] for x in gs]) for k in gs[0]}
    pts = jnp.asarray(g["pts"])
    fit = vm(j_planes.fit_plane_tables)
    planes_l, _ = fit(pts, jnp.asarray(g["tris_l"]))
    _, planes_r = fit(pts, jnp.asarray(g["tris_r"]))
    Ho, Wo = jp.out_shape(w, h)
    tid_l = vm(lambda s: j_spans.expand_tri_spans(s, Wo))(
        jnp.asarray(g["tri_l"]))
    tid_r = vm(lambda s: j_spans.expand_tri_spans(s, Wo))(
        jnp.asarray(g["tri_r"]))
    grid_l = vm(lambda q: j_grid.build_grid_mask(q, jp, w, h, False))(pts)
    grid_r = vm(lambda q: j_grid.build_grid_mask(q, jp, w, h, True))(pts)
    D1 = vm(lambda a, b, t, pl, gm: j_match.compute_disparity(
        a, b, t, pl, gm, jp, right_image=False))(desc1, desc2, tid_l,
                                                 planes_l, grid_l)
    D2 = vm(lambda a, b, t, pl, gm: j_match.compute_disparity(
        a, b, t, pl, gm, jp, right_image=True))(desc2, desc1, tid_r,
                                                planes_r, grid_r)
    L1, L2 = vm(lambda a, b: j_post.lr_consistency_check(a, b, jp))(D1, D2)
    S1 = vm(lambda x: j_post.remove_small_segments(x, jp))(L1)
    G1 = vm(lambda x: j_post.gap_interpolation(x, jp))(S1)
    A1 = vm(lambda x: j_post.adaptive_mean(x, jp))(G1)
    M1 = vm(lambda x: j_post.median_filter(x, jp))(A1)
    # stage B's output: the filters the parameter set turns on
    F1 = M1 if jp.filter_median else (A1 if jp.filter_adaptive_mean else G1)
    jstereo = JaxStereo(CALIB, w, h, params=jp, use_pallas=False)
    dmap, points = vm(jstereo._reproject_impl)(F1)
    return dict(jp=jp, p=p, w=w, h=h, Wo=Wo, pe=pe, pairs=pairs,
                desc1=desc1, desc2=desc2, d_can=d_can, g=g, planes_l=planes_l,
                planes_r=planes_r, tid_l=tid_l, tid_r=tid_r, grid_l=grid_l,
                grid_r=grid_r, D1=D1, D2=D2, L1=L1, L2=L2, S1=S1, G1=G1,
                A1=A1, M1=M1, F1=F1, dmap=dmap, points=points)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_batched_stage_a(batch_stages):
    s = batch_stages
    d1, d2, d_can = s["pe"].stage_support_batched(s["pairs"])
    _eq(d1, s["desc1"])
    _eq(d2, s["desc2"])
    _eq(descriptor.texture_sum(d1), jax.vmap(j_desc.texture_sum)(s["desc1"]))
    _eq(d_can, s["d_can"])
    # the plain scan's batch: each frame's own scan
    scan = support_cu.support_scan(d1, d2, s["p"])
    assert scan.shape[:2] == (BATCH, 8)
    for i in range(BATCH):
        _eq(scan[i], support_cu.support_scan(d1[i], d2[i], s["p"]))


def test_batched_plane_fit_spans_and_grid(batch_stages):
    s = batch_stages
    pts = _t(s["g"]["pts"])
    pl, _ = planes.fit_plane_tables(pts, _t(s["g"]["tris_l"]))
    _, pr = planes.fit_plane_tables(pts, _t(s["g"]["tris_r"]))
    _eq(pl, s["planes_l"])
    _eq(pr, s["planes_r"])
    for tag in ("l", "r"):
        _eq(spans.expand_tri_spans(_t(s["g"]["tri_" + tag]), s["Wo"]),
            np.asarray(s["tid_" + tag]).astype(np.int32))
        _eq(grid.build_grid_mask(pts, s["p"], s["w"], s["h"],
                                 right_image=tag == "r"), s["grid_" + tag])


@pytest.mark.parametrize("right", [False, True])
def test_batched_matching(batch_stages, right):
    """The batched pass (plane maps, the plain key scan of a batch, the
    output codes) equals vmap of the JAX pass."""
    s = batch_stages
    tag = "r" if right else "l"
    a, b = (s["desc2"], s["desc1"]) if right else (s["desc1"], s["desc2"])
    D = matching_cu.compute_disparity(
        _t(a), _t(b), _t(s["tid_" + tag]), _t(s["planes_" + tag]),
        _t(s["grid_" + tag]), s["p"], right_image=right)
    _eq(D, s["D2" if right else "D1"])


def test_batched_postprocess(batch_stages):
    s = batch_stages
    p = s["p"]
    o1, o2 = lr_cu.lr_consistency_check(_t(s["D1"]), _t(s["D2"]), p)
    _eq(o1, s["L1"])
    _eq(o2, s["L2"])
    _eq(ccl_cu.remove_small_segments(_t(s["L1"]), p), s["S1"])
    _eq(post.gap_interpolation(_t(s["S1"]), p), s["G1"])
    _eq(post.adaptive_mean(_t(s["G1"]), p), s["A1"])
    _eq(post.median_filter(_t(s["A1"]), p), s["M1"])


def test_batched_stage_b_and_reproject(batch_stages):
    """stage_dense_batched on the packed (B, nbytes) geometry, then the
    frame tail (dmap, resize, Q reprojection) of a batch."""
    s = batch_stages
    pe = s["pe"]
    buf = torch.as_tensor(np.stack([
        pe.pack_geometry({k: s["g"][k][i] for k in s["g"]})
        for i in range(BATCH)]))
    D1, _ = pe.stage_dense_batched(_t(s["desc1"]), _t(s["desc2"]), buf)
    _eq(D1, s["F1"])
    eng = StereoEngine(CALIB, s["w"], s["h"], params=s["p"], device="cpu")
    dmap, points = eng.reproject(D1)
    _eq(dmap, s["dmap"])
    _eq(points, s["points"])


# ---- (b) packed geometry -----------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pack_geometry_matches_jax(mode):
    w, h, make = MODES[mode]
    jp = make()
    je = JaxElas(jp, w, h)
    pe = ElasEngine(_port(jp), w, h, device="cpu")
    assert pe._geo_layout == je._geo_layout
    gs = []
    for lf, rf in _frames(w, h, 2):
        _, _, d_can = je._stage_support(jnp.asarray(bgr_to_gray(lf)),
                                        jnp.asarray(bgr_to_gray(rf)))
        g = je.host_mid(np.asarray(d_can))
        buf = pe.pack_geometry(g)
        assert buf.dtype == np.uint8
        assert buf.tobytes() == je.pack_geometry(g).tobytes()
        for arr, ref in zip(pe.unpack_geometry(torch.as_tensor(buf)),
                            je.unpack_geometry(jnp.asarray(buf))):
            _eq(arr, ref)
        gs.append(g)
    batch = torch.as_tensor(np.stack([pe.pack_geometry(g) for g in gs]))
    for k, arr in zip(("pts", "tris_l", "tris_r", "tri_l", "tri_r"),
                      pe.unpack_geometry(batch)):
        _eq(arr, np.stack([g[k] for g in gs]))
    with pytest.raises(ValueError, match="uint8 buffer"):
        pe.unpack_geometry(batch[:, 1:])


# ---- (c) the host middle of the pool -----------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_mid_standalone_matches_jax(mode):
    w, h, make = MODES[mode]
    jp = make()
    je = JaxElas(jp, w, h)
    pe = ElasEngine(_port(jp), w, h, device="cpu")
    lf, rf = _frames(w, h, 1)[0]
    _, _, d_can = pe.stage_support(bgr_to_gray(lf), bgr_to_gray(rf))
    d_can = d_can.numpy()
    ref = j_host_mid(d_can, jp, w, h, je.n_max, je.t_max, je.s_max)
    out = host_mid_standalone(d_can, *pe.host_args)
    assert sorted(out) == sorted(ref)
    for k in ("pts", "tris_l", "tris_r", "tri_l", "tri_r"):
        _eq(out[k], ref[k])
    assert out["warnings"] == ref["warnings"] == []


def test_host_mid_standalone_warnings_match_jax():
    """The thinning case of tests/test_engine.py: a dense grid and a tiny
    n_max; the warning is captured, not raised, with the JAX text."""
    jp = j_robotics_params(disp_max=63)
    rng = np.random.default_rng(0)
    d_can = rng.integers(0, 60, (24, 32)).astype(np.float32)
    kw = dict(width=160, height=120, n_max=64, t_max=200, s_max=64,
              host_filters=False)
    ref = j_host_mid(d_can, jp, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = host_mid_standalone(d_can, _port(jp), **kw)
    assert any("thinned" in m for m in out["warnings"])
    assert out["warnings"] == ref["warnings"]
    for k in ("pts", "tris_l", "tris_r", "tri_l", "tri_r"):
        _eq(out[k], ref[k])


def test_host_module_imports_no_torch():
    """The spawn pool's workers import the host middle and not torch."""
    code = ("import sys\n"
            "import stereovision_tpu_torch.hostlib.geometry\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---- (d) the streaming entry points ----------------------------------------


@pytest.fixture(scope="module", params=sorted(MODES))
def streams(request):
    """JAX's stream and stream_batched (batch 2; "batched" unfused, "fused"
    its one-dispatch mode) over the same 5 frames, and a port engine
    (closed at the end)."""
    w, h, make = MODES[request.param]
    jp = make()
    frames = _frames(w, h, FRAMES)
    with JaxStereo(CALIB, w, h, params=jp, use_pallas=False) as je:
        ref_stream = list(je.stream(iter(frames)))
        ref_batched, ref_fused = (
            list(je.stream_batched(iter(frames), batch=2, fetch="host",
                                   host_workers="thread", fused=fused))
            for fused in (False, True))
    eng = StereoEngine(CALIB, w, h, params=_port(jp), device="cpu")
    yield dict(frames=frames, stream=ref_stream, batched=ref_batched,
               fused=ref_fused, eng=eng)
    eng.close()


def _same_frames(outs, refs):
    assert len(outs) == len(refs) == FRAMES
    for o, r in zip(outs, refs):
        assert set(o) == {"dmap", "points", "timings"}
        _eq(o["dmap"], r["dmap"])
        _eq(_np(o["points"]).reshape(-1, 3), r["points"])


@pytest.mark.parametrize("fetch", ["host", "dmap", "device"])
def test_stream_matches_jax(streams, fetch):
    outs = list(streams["eng"].stream(iter(streams["frames"]), fetch=fetch))
    _same_frames(outs, streams["stream"])
    assert isinstance(outs[0]["dmap"], np.ndarray)
    assert isinstance(outs[0]["points"],
                      np.ndarray if fetch == "host" else torch.Tensor)


@pytest.mark.parametrize("jax_schedule", ["batched", "fused"])
@pytest.mark.parametrize("host_workers", ["thread", "process"])
@pytest.mark.parametrize("fetch", ["host", "dmap", "device"])
def test_stream_batched_matches_jax(streams, fetch, host_workers,
                                    jax_schedule):
    """The port's one batched schedule serves the callers of both of the
    JAX engine's: in every fetch mode, with the host middle on threads or
    in the spawn pool, it yields the frames of JAX's stream_batched with
    fused=False ("batched") and with fused=True ("fused")."""
    eng = streams["eng"]
    outs = list(eng.stream_batched(iter(streams["frames"]), batch=2,
                                   fetch=fetch, pipeline_depth=3,
                                   host_workers=host_workers))
    assert eng.host_mode == host_workers
    if host_workers == "process":
        assert eng.elas._host_pool is not None
    _same_frames(outs, streams[jax_schedule])
    kinds = {"host": (np.ndarray, np.ndarray),
             "dmap": (np.ndarray, torch.Tensor),
             "device": (torch.Tensor, torch.Tensor)}[fetch]
    assert isinstance(outs[-1]["dmap"], kinds[0])
    assert isinstance(outs[-1]["points"], kinds[1])
    assert outs[-1]["timings"]["t_t"] > 0


def test_stream_batched_runs_again_after_a_call_left_early(streams):
    """A call closed after its first frame leaves the engine whole: the
    next call gets every frame."""
    eng = streams["eng"]
    run = dict(batch=2, fetch="host", pipeline_depth=3,
               host_workers="thread")
    gen = eng.stream_batched(iter(streams["frames"]), **run)
    next(gen)
    gen.close()
    outs = list(eng.stream_batched(iter(streams["frames"]), **run))
    _same_frames(outs, streams["batched"])


def test_stream_batched_falls_back_to_threads_when_pool_breaks(
        streams, monkeypatch):
    """A pool whose processes cannot start: one warning, the host middle
    on threads for the rest of the call, the same frames, and the broken
    pool shut down once the call is done."""
    eng = streams["eng"]
    calls = []

    def broken(dcs):
        calls.append(len(dcs))
        eng.elas.host_pool()
        raise BrokenProcessPool("a child process terminated abruptly")

    monkeypatch.setattr(eng.elas, "host_mid_parallel", broken)
    with pytest.warns(UserWarning, match="process pool failed") as rec:
        outs = list(eng.stream_batched(iter(streams["frames"]), batch=2,
                                       fetch="host", pipeline_depth=1,
                                       host_workers="process"))
    assert len(calls) == 1
    assert sum("process pool failed" in str(w.message) for w in rec) == 1
    assert eng.host_mode == "thread"
    assert eng.elas._host_pool is None
    _same_frames(outs, streams["batched"])


def test_stream_batched_host_fault_propagates(streams, monkeypatch):
    """A fault of the host middle inside a pool worker is raised to the
    caller, not retried on threads."""
    eng = streams["eng"]

    def faulty(dcs):
        raise ValueError("span code overflow")

    monkeypatch.setattr(eng.elas, "host_mid_parallel", faulty)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="span code overflow"):
            list(eng.stream_batched(iter(streams["frames"]), batch=2,
                                    fetch="host", host_workers="process"))


def test_stream_batched_reemits_worker_warnings():
    """A warning captured in a host worker reaches the caller once a
    frame batch, prefixed as in the JAX package."""
    jp = j_robotics_params(disp_max=63)
    eng = StereoEngine(CALIB, 160, 120, params=_port(jp), device="cpu")
    eng.elas.n_max = 8           # a tiny point cap: support is thinned
    eng.elas.t_max = 2 * 8 + 8
    with pytest.warns(UserWarning, match="host geometry worker: support "
                      "points thinned"):
        outs = list(eng.stream_batched(iter(_frames(160, 120, 3)), batch=2,
                                       fetch="host", host_workers="thread"))
    assert len(outs) == 3
    eng.close()


def test_stream_batched_rejects_bad_arguments():
    eng = StereoEngine(CALIB, 160, 120, params=_port(
        j_robotics_params(disp_max=63)), device="cpu")
    with pytest.raises(ValueError, match="fetch"):
        next(eng.stream_batched(iter([]), fetch="points"))
    with pytest.raises(ValueError, match="host_workers"):
        next(eng.stream_batched(iter([]), host_workers="fork"))
    assert list(eng.stream_batched(iter([]))) == []
    eng.close()


def test_launch_counters_and_shared_state_under_threads():
    """More threads than cores, switching every microsecond: the launch
    counter loses no update, and the process pool and the prior table are
    made once however many threads ask at once."""
    ns = {"launches": 0}
    eng = ElasEngine(_port(j_robotics_params(disp_max=63)), 160, 120,
                     device="cpu")
    pools, priors = [], []

    def work():
        for _ in range(2000):
            _lib.count(ns)
        pools.append(eng.host_pool())
        priors.append(matching_cu.prior_table(eng.p, torch.device("cpu")))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work)
                   for _ in range(4 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ns["launches"] == 2000 * len(threads)
    assert all(p is pools[0] for p in pools)
    assert all(t is priors[0] for t in priors)
    eng.close()
    assert eng._host_pool is None


# ---- (e) lifecycle -------------------------------------------------------------


def test_close_releases_workers_and_pool():
    """As tests/test_engine.py checks for the JAX engine: close() (here
    through the context manager) shuts the executors and the process pool
    down and joins their threads; the engine stays usable."""
    jp = j_robotics_params(disp_max=63)
    frames = _frames(160, 120, 3)
    before = threading.active_count()
    with StereoEngine(CALIB, 160, 120, params=_port(jp),
                      device="cpu") as eng:
        outs = list(eng.stream_batched(iter(frames), batch=2,
                                       host_workers="process"))
        assert len(outs) == 3
        assert eng._executors is not None
        assert eng.elas._host_pool is not None
    assert eng._executors is None
    assert eng.elas._host_pool is None
    assert threading.active_count() <= before + 1
    eng.close()                  # idempotent
    outs = list(eng.stream_batched(iter(frames), batch=2,
                                   host_workers="thread"))
    assert len(outs) == 3 and eng._executors is not None
    eng.close()
    assert eng._executors is None
