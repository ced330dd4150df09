"""The port's host library and its NumPy fallbacks, held against the JAX
package.

  (a) _filter_support_np equals the native sequential filters and the JAX
      package's _filter_support_np exactly, on the robotics 40x50 grid of
      tests/test_ops.py and on a 75x249 app_params() grid (KITTI's);
  (b) rasterize_tri_ids equals the JAX package's ops/planes.py
      rasterize_tri_ids bit for bit, and the native rasterize the JAX
      package's native one, for the left and the right image: a dense
      KITTI-size triangulation (~5,000 points), no triangle, corners that
      share an integer u, a right image whose u - d falls below 0, and
      triangle ids past the engine's t_max.  The two kinds of rasterizer
      are not held equal to each other: g++ may fuse the native one's
      a * u + b into one rounding (an FMA), where NumPy rounds twice; the
      number of pixels where they differ is recorded (`record_property`);
  (c) a failed build (g++ failing, missing, or the library not loading):
      get_lib() gives None and does not try again, and the host middle,
      ElasEngine.process and StereoEngine.process_frame run on NumPy and
      equal the JAX package's under the same failure bit for bit;
  (d) stream_batched(host_workers="thread") under the same failure: the
      host threads fall back too, each frame equal to JAX's;
  (e) the native span coder (hostlib.geometry.tri_span_code, one C++ pass
      over the raw id map) equals the port's NumPy encode_tri_spans of the
      same map masked at t_max and sliced to the output lattice, byte for
      byte, with the same runs count and overflow note, and so does the
      fallback: both KITTI maps, the subsampled lattice, an overflowing
      s_max, runs over 255 columns, a map of -1, a narrow map, ids up to
      0xFFFE, seeded random maps; an id >= 0xFFFF that survives the mask
      raises the same ValueError both ways.

The tests marked `cuda` (skipped without a card) hold the card against
the CPU under a failed build (a test forces get_lib() to None; the spawn
pool's workers build their own library).  On the card, from
the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_hostlib.py

The JAX package is imported inside the CPU tests only: the card's machine
has no jax.
"""

import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

from stereovision_tpu_torch import native
from stereovision_tpu_torch import profiling as P
from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
from stereovision_tpu_torch.hostlib import geometry, raster
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.params import app_params, robotics_params
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
KITTI = (1242, 375)
W, H = 160, 120
GEOMETRY = ("pts", "tris_l", "tris_r", "tri_l", "tri_r")


@pytest.fixture(autouse=True)
def _fresh_lib():
    """Every test finds get_lib() unloaded and leaves it so: a failure
    forced by one test is not remembered by the next."""
    raster.get_lib.cache_clear()
    yield
    raster.get_lib.cache_clear()


def _jax_params(p):
    from stereovision_tpu.params import ElasParams as JaxParams
    return JaxParams(**dataclasses.asdict(p))


def _eq(port, ref):
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


def _gray_pair(w, h, seed):
    left, right, _ = stereo_pair(w, h, seed)
    return bgr_to_gray(left), bgr_to_gray(right)


# ---- (a) the sequential support filters ------------------------------------


def _robotics_grid():
    """tests/test_ops.py:85-94's grid."""
    return np.random.default_rng(5).integers(-1, 30, (40, 50)).astype(
        np.int16)


def _kitti_grid():
    """A 75x249 grid (app_params() at 1242x375): a slanted field with
    jitter, outliers and a quarter of the cells empty."""
    rng = np.random.default_rng(7)
    v, u = np.mgrid[0:75, 0:249]
    d = 10 + u // 3 + v // 2 + rng.integers(-1, 2, u.shape)
    out = rng.random(u.shape) < 0.05
    d[out] = rng.integers(0, 256, int(out.sum()))
    d[rng.random(u.shape) < 0.25] = -1
    return d.astype(np.int16)


FILTER_GRIDS = {"robotics_40x50": (robotics_params, _robotics_grid),
                "app_75x249": (app_params, _kitti_grid)}


@pytest.mark.parametrize("grid", sorted(FILTER_GRIDS))
def test_filter_support_np_matches_native_and_jax(grid):
    from stereovision_tpu.hostlib import raster as j_raster
    make_p, make_grid = FILTER_GRIDS[grid]
    p, d = make_p(), make_grid()
    got = raster._filter_support_np(d.copy(), p)
    _eq(got, j_raster._filter_support_np(d.copy(), _jax_params(p)))
    assert raster.get_lib() is not None
    _eq(got, raster.filter_support_sequential(d, p))
    # both filters had work to do
    assert (got >= 0).sum() > 0 and (got != d).sum() > 0


# ---- (b) the rasterizers ----------------------------------------------------


def _kitti_points(seed):
    """~5,000 support points on the 75x249 candidate lattice of a
    1242x375 frame, disparities up to 255 (u - d < 0 near the left edge),
    u-major as support_points_from_grid emits them, plus the corners."""
    rng = np.random.default_rng(seed)
    uc, vc = np.meshgrid(np.arange(249), np.arange(75), indexing="ij")
    keep = rng.random(uc.shape) < 0.27
    u, v = uc[keep] * 5, vc[keep] * 5
    d = np.clip(20 + u // 10 + (3 * v) // 10
                + rng.integers(-3, 4, u.size), 0, 255)
    pts = np.stack([u, v, d], 1).astype(np.int32)
    return geometry.add_corner_support_points(pts, *KITTI)


def _kitti_dense(right):
    pts = _kitti_points(3)
    return pts, geometry.triangulate(pts, right), KITTI


def _no_triangles(right):
    return _kitti_points(4)[:50], np.zeros((0, 3), np.int32), (160, 120)


def _shared_u(right):
    """Corners with one integer u: vertical edges (AB, BC or AC), a
    triangle on one column, and a triangle whose three corners share one
    u; d = 0, so the right image sees the same."""
    pts = np.array([[10, 5, 0], [10, 40, 0], [30, 20, 0], [30, 60, 0],
                    [50, 5, 0], [10, 70, 0], [50, 50, 0], [31, 90, 0]],
                   np.int32)
    tris = np.array([[0, 1, 2], [2, 3, 4], [0, 1, 5], [4, 6, 2],
                     [3, 7, 2], [1, 3, 5], [6, 7, 4]], np.int32)
    return pts, tris, (64, 96)


def _negative_u(right):
    """Disparities above u: in the right image (u - d) corners fall left
    of column 0, some whole triangles too."""
    pts = np.array([[2, 0, 10], [20, 0, 5], [5, 30, 30], [40, 40, 3],
                    [0, 63, 0], [70, 10, 60], [90, 60, 95]], np.int32)
    tris = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4], [1, 3, 5],
                     [3, 5, 6], [0, 2, 4]], np.int32)
    return pts, tris, (96, 64)


T_MAX = 1000


def _past_t_max(right):
    """Ids up to 3x the engine's t_max: a triangulation repeated, later
    ids overwriting earlier ones (host_mid then clips ids >= t_max)."""
    pts = _kitti_points(5)
    keep = (pts[:, 0] < 320) & (pts[:, 1] < 240)
    pts = pts[keep]
    tris = geometry.triangulate(pts, right)
    reps = -(-3 * T_MAX // len(tris))
    return pts, np.tile(tris, (reps, 1)), (320, 240)


RASTER_CASES = {"kitti_dense": _kitti_dense, "no_triangles": _no_triangles,
                "shared_integer_u": _shared_u, "negative_u": _negative_u,
                "ids_past_t_max": _past_t_max}


@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_rasterize_tri_ids_matches_jax(case, right):
    from stereovision_tpu.ops.planes import rasterize_tri_ids as j_rasterize
    pts, tris, (w, h) = RASTER_CASES[case](right)
    got = raster.rasterize_tri_ids(pts, tris, right, w, h)
    _eq(got, j_rasterize(pts, tris, right, w, h))
    if case == "no_triangles":
        assert (got == -1).all()
    else:
        assert (got >= 0).any()
    if case == "ids_past_t_max":
        assert (got >= T_MAX).any()


@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_native_rasterize_matches_jax_native(case, right, record_property):
    from stereovision_tpu.hostlib import raster as j_raster
    if j_raster.get_lib() is None:
        pytest.skip("the JAX package's native host library does not load")
    pts, tris, (w, h) = RASTER_CASES[case](right)
    assert raster.get_lib() is not None
    got = raster.rasterize(pts, tris, right, w, h)
    _eq(got, j_raster.rasterize(pts, tris, right, w, h))
    # a reading, not a check: pixels where the NumPy rasterizer gives
    # another triangle (or none)
    other = raster.rasterize_tri_ids(pts, tris, right, w, h)
    record_property("numpy_vs_native_pixels", int((got != other).sum()))


# ---- (c) a failed build ------------------------------------------------------


def _fail_build(monkeypatch, tmp_path, how):
    """Make the native library fail `how`; returns the list that counts
    the builds tried."""
    builds = []
    real = native.build_library

    def build(*args, **kw):
        builds.append(args[0])
        if how == "compile_error":
            raise RuntimeError("native build failed: forced")
        if how == "no_compiler":
            raise FileNotFoundError("g++")
        if how == "load_fails":
            return str(tmp_path / "missing.so")
        return real(*args, **kw)

    if how == "no_compiler_on_path":
        # the real build, in an empty build directory, with no g++ to run
        empty = tmp_path / "bin"
        empty.mkdir()
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(native, "build_library", build)
    raster.get_lib.cache_clear()
    return builds


def _jax_without_lib(monkeypatch):
    from stereovision_tpu.hostlib import raster as j_raster
    monkeypatch.setattr(j_raster, "get_lib", lambda: None)


@pytest.mark.parametrize("how", ["compile_error", "no_compiler",
                                 "no_compiler_on_path", "load_fails"])
def test_get_lib_gives_none_once_the_build_fails(monkeypatch, tmp_path, how):
    builds = _fail_build(monkeypatch, tmp_path, how)
    assert raster.get_lib() is None
    assert raster.get_lib() is None
    assert builds == ["svtt_host"]        # the failure is remembered
    p = robotics_params()
    d = _robotics_grid()
    _eq(raster.filter_support_sequential(d, p),
        raster._filter_support_np(d.copy(), p))
    pts, tris, (w, h) = _negative_u(False)
    _eq(raster.rasterize(pts, tris, True, w, h),
        raster.rasterize_tri_ids(pts, tris, True, w, h))
    assert builds == ["svtt_host"]
    raster.get_lib.cache_clear()
    monkeypatch.undo()
    assert raster.get_lib() is not None   # and forgotten on a cache_clear


@pytest.mark.parametrize("subsampling", [False, True],
                         ids=["full", "subsampled"])
def test_host_mid_falls_back_as_jax_does(monkeypatch, tmp_path, subsampling,
                                         record_property):
    """KITTI size, host only: the port's host middle on NumPy equals the
    JAX package's under a None get_lib, every product bit for bit."""
    from stereovision_tpu.models.elas import ElasEngine as JaxElas
    p = app_params(subsampling=subsampling)
    pe = ElasEngine(p, *KITTI, device="cpu")
    _, _, d_can = pe.stage_support(*_gray_pair(*KITTI, seed=0))
    d_can = d_can.numpy()
    native_g = pe.host_mid(d_can)
    _fail_build(monkeypatch, tmp_path, "compile_error")
    _jax_without_lib(monkeypatch)
    g = pe.host_mid(d_can)
    assert raster.get_lib() is None
    ref = JaxElas(_jax_params(p), *KITTI).host_mid(d_can)
    for k in GEOMETRY:
        _eq(g[k], ref[k])
    # a reading: span-code bytes the NumPy rasterizer changed
    record_property("span_bytes_changed", {
        k: int((g[k] != native_g[k]).sum()) for k in ("tri_l", "tri_r")})


@pytest.mark.parametrize("subsampling", [False, True],
                         ids=["full", "subsampled"])
def test_engines_fall_back_as_jax_does(monkeypatch, tmp_path, subsampling):
    """ElasEngine.process (D1, D2) and StereoEngine.process_frame (dmap,
    points) at 160x120 under app_params(), with the library failed in
    both packages."""
    from stereovision_tpu.engine import StereoEngine as JaxStereo
    from stereovision_tpu.models.elas import ElasEngine as JaxElas
    _fail_build(monkeypatch, tmp_path, "no_compiler")
    _jax_without_lib(monkeypatch)
    p = app_params(subsampling=subsampling)
    jp = _jax_params(p)
    left, right, _ = stereo_pair(W, H, seed=4)
    I1, I2 = bgr_to_gray(left), bgr_to_gray(right)
    D1, D2 = ElasEngine(p, W, H, device="cpu").process(I1, I2)
    J1, J2 = JaxElas(jp, W, H).process(I1, I2)
    _eq(D1, J1)
    _eq(D2, J2)
    assert (D1 >= 0).float().mean() > 0.5
    out = StereoEngine(CALIB, W, H, params=p,
                       device="cpu").process_frame(left, right)
    with JaxStereo(CALIB, W, H, params=jp, use_pallas=False) as je:
        ref = je.process_frame(left, right)
    _eq(out["dmap"], ref["dmap"])
    _eq(out["points"], ref["points"])
    assert raster.get_lib() is None


# ---- (d) the host threads of stream_batched ---------------------------------


def _streamed(eng, frames, host_workers):
    return [o["dmap"] for o in eng.stream_batched(
        iter(frames), batch=2, fetch="host", pipeline_depth=1,
        host_workers=host_workers)]


@pytest.mark.parametrize("subsampling", [False, True],
                         ids=["full", "subsampled"])
def test_host_threads_fall_back_as_jax_does(monkeypatch, tmp_path,
                                            subsampling):
    """stream_batched(host_workers="thread") over 3 frames (a padded last
    batch) with the library failed in both packages: the host threads run
    the NumPy filters and rasterizer, each dmap equal to JAX's."""
    from stereovision_tpu.engine import StereoEngine as JaxStereo
    _fail_build(monkeypatch, tmp_path, "no_compiler")
    _jax_without_lib(monkeypatch)
    p = app_params(subsampling=subsampling)
    frames = [stereo_pair(W, H, seed)[:2] for seed in (3, 4, 5)]
    with StereoEngine(CALIB, W, H, params=p, device="cpu") as pe, \
            JaxStereo(CALIB, W, H, params=_jax_params(p),
                      use_pallas=False) as je:
        got = _streamed(pe, frames, "thread")
        ref = _streamed(je, frames, "thread")
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        _eq(a, b)
    assert raster.get_lib() is None


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", [False, True],
                         ids=["full", "subsampled"])
def test_failed_build_on_the_card_equals_cpu(cuda, monkeypatch, tmp_path,
                                             subsampling):
    """With the host library failed, the card's engine runs its host
    middle on NumPy, through process and process_jit, and equals the
    CPU's."""
    _fail_build(monkeypatch, tmp_path, "compile_error")
    p = app_params(subsampling=subsampling)
    I1, I2 = _gray_pair(W, H, seed=4)
    eng = ElasEngine(p, W, H, device=cuda)
    C1, C2 = ElasEngine(p, W, H, device="cpu").process(I1, I2)
    for run in (eng.process, eng.process_jit):
        D1, D2 = run(I1, I2)
        assert torch.equal(D1.cpu(), C1) and torch.equal(D2.cpu(), C2)
    assert raster.get_lib() is None


# ---- (e) the span coder --------------------------------------------------------


def _kitti_map(right):
    pts, tris, (w, h) = _kitti_dense(right)
    return raster.rasterize(pts, tris, right, w, h)


def _past_t_max_map():
    pts, tris, (w, h) = _past_t_max(True)
    return raster.rasterize(pts, tris, True, w, h)


def _runs_map(h, w, lengths, ids, seed):
    """(h, w) int32 rows of runs, each of a length drawn from lengths and
    an id from ids."""
    rng = np.random.default_rng(seed)
    out = np.empty((h, w), np.int32)
    for row in out:
        c = 0
        while c < w:
            n = int(rng.choice(lengths))
            row[c:c + n] = rng.choice(ids)
            c += n
    return out


def _long_runs():
    """Gaps of 255, 256, 510 and 511 columns and more at a row's start, in
    its middle and at its end (there the row's last run)."""
    t = np.zeros((8, 1400), np.int32)
    t[0, 600:] = 1                                    # start: 600 columns
    t[1, :3], t[1, 3:258], t[1, 258:] = 4, 5, 6       # a gap of exactly 255
    t[2, :3], t[2, 3:259], t[2, 259:] = 4, 5, 6       # 256
    t[3, :10], t[3, 10:520], t[3, 520:530] = 7, -1, 8  # middle: 510
    t[3, 530:1041] = 9                                # 511
    t[4, :700] = np.arange(700) // 30                 # end: 700 columns
    t[4, 700:] = 2000                                 # masked at t_max
    t[5] = np.arange(1400) // 300                     # 300 columns a run
    t[6, 1399] = 3                                    # one column at the end
    return t, 1000, 64, 1, t.shape


SPAN_CASES = {
    "kitti_left": lambda: (_kitti_map(False), 7000, 310, 1, (375, 1242)),
    "kitti_right": lambda: (_kitti_map(True), 7000, 310, 1, (375, 1242)),
    "kitti_subsampled": lambda: (_kitti_map(False), 7000, 310, 2,
                                 (187, 621)),
    "subsampled_past_t_max": lambda: (_past_t_max_map(), T_MAX, 64, 2,
                                      (120, 160)),
    "s_max_8": lambda: (_kitti_map(True), 7000, 8, 1, (375, 1242)),
    "long_runs": _long_runs,
    "all_minus_one": lambda: (np.full((375, 1242), -1, np.int32), 100, 310,
                              1, (375, 1242)),
    "all_masked": lambda: (_kitti_map(False), 0, 310, 1, (375, 1242)),
    "narrow": lambda: (_runs_map(30, 100, [1, 3, 40], np.arange(-1, 50), 1),
                       40, 64, 1, (30, 100)),
    "ids_to_fffe": lambda: (_runs_map(20, 900, [1, 7, 300],
                                      [-1, 0, 0xFF00, 0xFFFE], 2),
                            np.iinfo(np.int32).max, 64, 1, (20, 900)),
    "id_ffff_masked": lambda: (_runs_map(20, 900, [20, 90], [0xFFFE, 0xFFFF,
                                                         0x7FFFFFFF], 3),
                               0xFFFF, 64, 1, (20, 900)),
    **{"random_%d" % seed: (lambda seed=seed: (
        _runs_map(37, 1203, [1, 2, 5, 11, 200, 256, 300, 700],
                  np.arange(-1, 3000), seed),
        [2500, 500, 3001][seed % 3], [310, 16, 64][seed % 3],
        1 + seed % 2, [(37, 1203), (18, 601)][seed % 2]))
       for seed in range(10, 14)},
}


def _coded(fn):
    """fn(notes) -> (its code, the runs it counted, its notes)."""
    notes = []
    P.trace_stop()
    P.trace_drain()
    P.trace_start()
    try:
        with P.span("test.span_code") as s:
            code = fn(notes)
    finally:
        P.trace_stop()
        P.trace_drain()
    return code, s.counts.get("runs"), notes


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_native_span_code_equals_encode_tri_spans(case, monkeypatch):
    tri_id, t_max, s_max, step, (ho, wo) = SPAN_CASES[case]()
    lattice = np.where(tri_id >= t_max, -1, tri_id)[::step, ::step][:ho, :wo]
    ref = _coded(lambda notes: geometry.encode_tri_spans(lattice, s_max,
                                                         notes))
    assert ref[0].shape == (ho, s_max, 3)
    assert bool(ref[2]) == (ref[1] > s_max)
    assert ref[2] or case != "s_max_8"
    assert raster.get_lib() is not None
    for _ in ("native", "numpy"):
        got = _coded(lambda notes: geometry.tri_span_code(
            tri_id, t_max, s_max, (ho, wo), step, notes))
        _eq(got[0], ref[0])
        assert got[1:] == ref[1:]
        monkeypatch.setattr(geometry, "get_lib", lambda: None)


@pytest.mark.parametrize("bad", [0xFFFF, 0x10000])
@pytest.mark.parametrize("step", [1, 2])
def test_span_code_rejects_ids_past_the_codec(step, bad, monkeypatch):
    tri_id = np.full((20, 600), 7, np.int32)
    tri_id[10, 300:304] = [0xFFFE, 0xFFFE, bad, bad]
    tri_id[4, :] = 0x7FFFFFFF                          # masked at t_max
    lattice = np.where(tri_id >= 1 << 20, -1, tri_id)[::step, ::step]
    with pytest.raises(ValueError) as ref:
        geometry.encode_tri_spans(lattice, 64)
    assert str(bad) in str(ref.value)
    assert raster.get_lib() is not None
    for _ in ("native", "numpy"):
        with pytest.raises(ValueError) as got:
            geometry.tri_span_code(tri_id, 1 << 20, 64,
                                   lattice.shape, step)
        assert str(got.value) == str(ref.value)
        monkeypatch.setattr(geometry, "get_lib", lambda: None)
