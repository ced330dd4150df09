"""The port across the reference's scale grid (stereovision_tpu_torch/
scales.py: -f 0.5, 0.6, ..., 3.0, full resolution and subsampled, from
2484x750 down to 414x125), held against the JAX package on the CPU.

Every engine is built from the packaged kitti_2011_09_26.yml under
app_params() (D = 256), the port's with device="cpu".  Frames are the
seeded 1242x375 synthetic scene resized to the scale's size by the port's
io/kitti.py:_resize; the same arrays go into both packages.

  - the grid and the batch rule are the JAX sweep's (bench/sweep.py);
  - the calibration at all 26 scales: the scaled K1 and K2, the
    rectification (R1, R2, P1, P2, Q) and its maps, XR and XT, and the
    engines' Q, bit for bit;
  - process_frame's disparity, dmap and points at small scales, bit for
    bit, odd heights and an odd width on the half lattice included.  The
    JAX package's XLA path cannot take an odd width subsampled (its
    matching's SAD image keeps ceil(W / 2) columns against the W // 2
    lattice and raises): there the JAX engine runs its Pallas kernels in
    interpret mode, as its own tests run them on the CPU;
  - stream_batched at the sweep's batch through the spawn pool, every frame
    equal to process_frame;
  - the CLI's -f 3, full and -s 1, from 1242x375 PNGs: the npz and PLY
    dumps equal to the JAX CLI's;
  - the C ABI at scale=3: its cloud equals the JAX engine's.
"""

import contextlib
import ctypes
import io
import os
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.ctypeslib import ndpointer

from stereovision_tpu import cli as jcli
from stereovision_tpu import engine as jengine
from stereovision_tpu.bench.sweep import CUDA_FPS
from stereovision_tpu.engine import StereoEngine as JaxStereo
from stereovision_tpu.io import calibration as jcal
from stereovision_tpu.ops import postprocess as j_post
from stereovision_tpu.params import app_params as j_app_params

from stereovision_tpu_torch import capi, cli, scales
from stereovision_tpu_torch.engine import StereoEngine
from stereovision_tpu_torch.io import calibration as pcal
from stereovision_tpu_torch.io.kitti import _resize
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.params import app_params
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
KW, KH = scales.KITTI_SIZE

# the sweep's batches (bench/sweep.py:75-96), (full, subsampled) by scale
SWEEP_BATCHES = {
    0.5: (2, 4), 0.6: (3, 4), 0.7: (4, 4), 0.8: (5, 4), 0.9: (6, 4),
    1.0: (8, 4), 1.1: (9, 4), 1.2: (11, 5), 1.3: (13, 6), 1.4: (15, 7),
    1.5: (18, 9), 1.6: (20, 10), 1.7: (23, 11), 1.8: (25, 12),
    1.9: (28, 14), 2.0: (32, 16), 2.1: (32, 16), 2.2: (32, 16),
    2.3: (32, 16), 2.4: (32, 16), 2.5: (32, 16), 2.6: (32, 16),
    2.7: (32, 16), 2.8: (32, 16), 2.9: (32, 16), 3.0: (32, 16)}


@pytest.fixture(scope="module")
def jax_stereo():
    """JAX StereoEngines made once per constructor arguments and shared by
    this module's tests (each new one compiles)."""
    made = {}

    def make(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in made:
            made[key] = JaxStereo(*args, **kwargs)
        return made[key]
    yield make
    for eng in made.values():
        eng.close()


@pytest.fixture(scope="module")
def kitti_pairs():
    """Seeded 1242x375 (left, right) BGR pairs, by seed."""
    return {seed: stereo_pair(KW, KH, seed)[:2] for seed in (0, 1)}


def _at(pair, scale):
    w, h = scales.frame_size(scale)
    return tuple(_resize(f, w, h) for f in pair)


def _eq(port, ref):
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        port.shape, ref.shape, port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


def test_grid_is_the_sweeps():
    """52 (scale, subsampling) pairs, those of the reference's log; sizes
    int(1242 / s) x int(375 / s); the batches the sweep's rule gives."""
    assert len(scales.SCALES) == 26
    assert sorted((round(s, 2), sub) for s in scales.SCALES
                  for sub in (0, 1)) == sorted(CUDA_FPS)
    assert scales.frame_size(0.5) == (2484, 750)
    assert scales.frame_size(2.9) == (428, 129)
    assert scales.frame_size(3.0) == (414, 125)
    for s in scales.SCALES:
        w, h = scales.frame_size(s)
        assert (w, h) == (int(1242 / s), int(375 / s))
        assert tuple(scales.sweep_batch(w, h, sub) for sub in (False, True)
                     ) == SWEEP_BATCHES[round(s, 2)], s


@pytest.mark.parametrize("scale", scales.SCALES)
def test_calibration_matches_jax(scale):
    """The scaled intrinsics, the rectification with its maps and the
    engines' Q equal the JAX package's bit for bit: both are float64 (the
    maps float32) from the same NumPy and cv2 calls.  The port's Q on the
    device is that Q cast to float32 once, as the JAX reprojection casts
    it: equal with no tolerance."""
    w, h = scales.frame_size(scale)
    c = pcal.load_calibration(CALIB)
    jc = jcal.load_calibration(CALIB)
    for k in ("K1", "K2"):
        K = pcal.scale_intrinsics(c[k], scale)
        _eq(K, jcal.scale_intrinsics(jc[k], scale))
        np.testing.assert_array_equal(K[:2], c[k][:2] / scale)
    rect = pcal.rectification_from_yaml(CALIB, w, h, scale_factor=scale,
                                        compute_maps=True)
    ref = jcal.rectification_from_yaml(CALIB, w, h, scale_factor=scale,
                                       compute_maps=True)
    for k in ("R1", "R2", "P1", "P2", "Q", "XR", "XT"):
        _eq(getattr(rect, k), getattr(ref, k))
    for k in ("lmap", "rmap"):
        assert getattr(rect, k).shape == (h, w, 2)
        _eq(getattr(rect, k), getattr(ref, k))
    eng = StereoEngine(CALIB, w, h, scale=scale, device="cpu")
    jeng = JaxStereo(CALIB, w, h, scale=scale, use_pallas=False)
    _eq(eng.rect.Q, jeng.rect.Q)
    _eq(eng._rect_t[0], np.asarray(jeng.rect.Q, np.float32))
    eng.close()
    jeng.close()


# (scale, subsampling) run in tier-1: 414x125 both ways (125 rows, 62 on
# the half lattice); 428x129 (odd height); 591x178 subsampled (odd width,
# 89 rows).  The rest of the grid is marked slow (~8 min on 8 cores).
FRAME_CASES = [(3.0, False), (3.0, True), (2.9, False), (2.1, True)]


@pytest.mark.parametrize("scale,subsampling", [
    pytest.param(s, sub, id="%s-%s" % (s, "sub" if sub else "full"),
                 marks=() if (s, sub) in FRAME_CASES else pytest.mark.slow)
    for s in scales.SCALES for sub in (False, True)])
def test_process_frame_matches_jax(kitti_pairs, jax_stereo, scale,
                                   subsampling):
    """disparity, dmap and points bit for bit against the JAX engine at
    that scale; on the half lattice an odd width goes through the JAX
    engine's Pallas kernels (interpret mode), because its XLA path raises
    there."""
    w, h = scales.frame_size(scale)
    left, right = _at(kitti_pairs[0], scale)
    out = StereoEngine(CALIB, w, h, scale=scale, subsampling=subsampling,
                       device="cpu").process_frame(left, right)
    odd_half = subsampling and w % 2 == 1
    if odd_half:
        with pytest.raises(TypeError, match="incompatible shapes"):
            JaxStereo(CALIB, w, h, scale=scale, subsampling=True,
                      use_pallas=False).process_frame(left, right)
    ref = jax_stereo(CALIB, w, h, scale=scale, subsampling=subsampling,
                     use_pallas=odd_half).process_frame(left, right)
    Ho, Wo = (h // 2, w // 2) if subsampling else (h, w)
    assert out["dmap"].shape == (Ho, Wo)
    assert out["points"].shape == (h * w, 3)
    _eq(out["disparity"], ref["disparity"])
    _eq(out["dmap"], ref["dmap"])
    _eq(out["points"], ref["points"])
    assert (out["disparity"] >= 0).float().mean() > 0.8


@pytest.mark.parametrize("shape", [(8, 16384), (625, 2070)])
def test_speckle_plain_past_int32_rekeying(shape):
    """The plain speckle filter (K3's CPU version) on maps whose re-keyed
    labels overflow int32 (n * (max(H, W) + 1) >= 2**31; 2070x625 is the
    frame at -f 0.6): equal to the JAX XLA filter, which falls back to a
    scan without re-keying there."""
    h, w = shape
    rng = np.random.default_rng(3)
    D = np.kron(rng.integers(0, 12, (h // 12 + 1, w // 12 + 1)),
                np.ones((12, 12)))[:h, :w] + rng.integers(0, 2, (h, w))
    D[rng.random((h, w)) < 0.05] = -1
    D = D.astype(np.float32)
    assert h * w * (max(h, w) + 1) >= 2 ** 31
    out = post.remove_small_segments(torch.as_tensor(D), app_params())
    ref = jax.jit(lambda d: j_post.remove_small_segments(
        d, j_app_params()))(jnp.asarray(D))
    _eq(out, ref)
    assert 0.1 < (out.numpy() == -10).mean() < 0.9


def test_stream_batched_at_the_sweeps_batch(kitti_pairs):
    """414x125 subsampled at the sweep's batch (16), 2 batches through the
    spawn pool: every frame's dmap and points equal its process_frame."""
    scale = 3.0
    w, h = scales.frame_size(scale)
    batch = scales.sweep_batch(w, h, True)
    assert batch == 16
    pairs = [_at(kitti_pairs[s], scale) for s in (0, 1)]
    with StereoEngine(CALIB, w, h, scale=scale, subsampling=True,
                      device="cpu") as eng:
        refs = [eng.process_frame(*p) for p in pairs]
        got = list(eng.stream_batched(
            (pairs[i % 2] for i in range(2 * batch)), batch=batch,
            fetch="host", pipeline_depth=3, host_workers="process"))
        assert eng.host_mode == "process"
    assert len(got) == 2 * batch
    for i, out in enumerate(got):
        _eq(out["dmap"], refs[i % 2]["dmap"])
        _eq(out["points"], refs[i % 2]["points"])


@pytest.fixture(scope="module")
def kitti_dir(kitti_pairs, tmp_path_factory):
    """The two 1242x375 pairs in KITTI raw layout (cv2 PNGs)."""
    root = tmp_path_factory.mktemp("kitti_scales")
    for cam, k in (("image_02", 0), ("image_03", 1)):
        (root / cam / "data").mkdir(parents=True)
        for i, seed in enumerate(sorted(kitti_pairs)):
            cv2.imwrite(str(root / cam / "data" / f"{i:010d}.png"),
                        kitti_pairs[seed][k])
    return str(root)


@pytest.mark.parametrize("sub", ["0", "1"])
def test_cli_scale_3_matches_jax(kitti_dir, jax_stereo, monkeypatch,
                                 tmp_path, sub):
    """-f 3 (frames read at 1242x375, resized to 414x125, K divided by 3)
    with -s 0 and -s 1: the npz dumps (display disparity and cloud) and the
    PLY files equal the JAX CLI's (its engine made once for both dumps)."""
    monkeypatch.setattr(jengine, "StereoEngine", jax_stereo)
    for dump in ("npz", "ply"):
        dirs = {}
        for name, run in (("port", lambda a: cli.main(a, device="cpu")),
                          ("jax", jcli.main)):
            out = str(tmp_path / (name + dump))
            with contextlib.redirect_stdout(io.StringIO()):
                assert run(["-k", kitti_dir, "-f", "3", "-s", sub,
                            "--dump", dump, "--out_dir", out]) == 0
            dirs[name] = out
        names = sorted(os.listdir(dirs["port"]))
        assert names == sorted(os.listdir(dirs["jax"])) and len(names) == 2
        for n in names:
            a, b = (osp.join(dirs[k], n) for k in ("port", "jax"))
            if dump == "ply":
                assert open(a, "rb").read() == open(b, "rb").read(), n
                continue
            a, b = np.load(a), np.load(b)
            assert a.files == b.files == ["dmap", "points"]
            assert a["dmap"].shape == ((125, 414) if sub == "0"
                                       else (62, 207))
            for k in a.files:
                _eq(a[k], b[k])


def test_capi_at_scale_3_matches_jax(kitti_pairs, jax_stereo, monkeypatch):
    """generatePointCloud(width=414, height=125, scale=3) through ctypes:
    the float64 cloud equals the JAX engine's at that scale."""
    scale, (w, h) = 3, scales.frame_size(3.0)
    monkeypatch.setattr(capi, "DEVICE", "cpu")
    lib = ctypes.CDLL(capi.library_path(), mode=ctypes.RTLD_GLOBAL)
    lib.generatePointCloud.restype = ndpointer(dtype=ctypes.c_double,
                                               shape=(w * h, 3))
    lib.generatePointCloud.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_bool, ctypes.c_bool, ctypes.c_bool, ctypes.c_bool,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_bool, ctypes.c_bool]
    lib.clean.restype = None
    lib.clean.argtypes = []
    left, right = _at(kitti_pairs[1], scale)
    bgra = [np.concatenate([f, np.full((h, w, 1), 255, np.uint8)], axis=-1)
            for f in (left, right)]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            # a copy: clean() frees the library's buffer
            pts = np.array(lib.generatePointCloud(
                bgra[0].tobytes(), bgra[1].tobytes(), b"", w, h, True,
                False, False, False, scale, 1, b"", b"", b"", False, False))
    finally:
        lib.clean()
    ref = jax_stereo(CALIB, w, h, scale=3.0, subsampling=False,
                     use_pallas=False).process_frame(left, right)["points"]
    _eq(pts, np.asarray(ref).astype(np.float64))
    assert np.isfinite(pts).mean() > 0.9
