"""The PyTorch port's engines held against the JAX package's, end to end.

Same NumPy frames into both: ElasEngine.process (D1, D2) and
StereoEngine.process_frame (dmap, points) must match bit for bit at
160x120 (D = 64, two presets, each at full resolution and subsampled) and
at the main path's full width, 1242x375 under app_params() and
app_params(subsampling=True) (D = 256; ElasEngine.process there in
tests/test_torch_kitti_full.py and tests/test_torch_kitti_subsampled.py,
through elas_full_width_kitti below), with every option of the frame
tail (remove_sky, true_scale_cloud, robot_frame, pc_extrapolation, and the
resize of the half-lattice map to the cloud's size).  Plus: the port
imports neither jax nor stereovision_tpu, its entry points default to the
card and raise without one, and the state converters carry the JAX host
geometry into the port's stage B.
"""

import dataclasses
import os.path as osp
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereovision_tpu.engine import StereoEngine as JaxStereo
from stereovision_tpu.models.elas import ElasEngine as JaxElas
from stereovision_tpu.params import app_params as j_app_params
from stereovision_tpu.params import robotics_params as j_robotics_params

import stereovision_tpu_torch as svt
from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
W, H = 160, 120
PRESETS = {
    "app": lambda: j_app_params().replace(disp_max=63),
    "robotics": lambda: j_robotics_params(disp_max=63),
    "app_sub": lambda: j_app_params(subsampling=True).replace(disp_max=63),
    "robotics_sub": lambda: j_robotics_params(disp_max=63, subsampling=True),
}


def _port(jp):
    return params_from_dict(dataclasses.asdict(jp))


def _eq(port, ref):
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


def _gray_pair(w, h, seed):
    left, right, disp = stereo_pair(w, h, seed)
    return bgr_to_gray(left), bgr_to_gray(right), disp


def _check_sanity(D1, disp, valid_frac):
    """Enough of D1 valid, and its median error against the true
    disparity at the output lattice's pixels <= 1."""
    D1 = D1.numpy()
    Ho, Wo = D1.shape
    step = disp.shape[1] // Wo
    truth = disp[::step, ::step][:Ho, :Wo]
    valid = D1 >= 0
    assert valid.mean() > valid_frac
    assert np.median(np.abs(D1[valid] - truth[valid])) <= 1


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stereovision_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'stereovision_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules\n"
        "           if k.startswith('stereovision_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = svt.app_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasEngine(p, W, H)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoEngine(CALIB, W, H)
    assert ElasEngine(p, W, H, device="cpu").device.type == "cpu"


def test_params_from_dict_round_trip():
    for make in PRESETS.values():
        jp = make()
        assert dataclasses.asdict(_port(jp)) == dataclasses.asdict(jp)
    assert _port(j_app_params()) == svt.app_params()
    with pytest.raises(ValueError):
        params_from_dict({"disp_max": 63})


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_stage_b_from_jax_geometry(preset):
    """The JAX host_mid products, carried over in the port's packed
    upload, give the port's stage B the JAX engine's D1 and D2."""
    jp = PRESETS[preset]()
    I1, I2, _ = _gray_pair(W, H, seed=11)
    je = JaxElas(jp, W, H)
    desc1, desc2, d_can = je._stage_support(jnp.asarray(I1), jnp.asarray(I2))
    g = je.host_mid(np.asarray(d_can))
    ref = je._stage_dense(desc1, desc2, *(jnp.asarray(g[k]) for k in
                          ("pts", "tris_l", "tris_r", "tri_l", "tri_r")))
    pe = ElasEngine(_port(jp), W, H, device="cpu")
    geo = pe.upload_geometry(g)
    # span codes on the output lattice, the run cap sized by full width
    assert geo[3].shape == (pe.Ho, pe.s_max, 3) == (je.Ho, je.s_max, 3)
    D1, D2 = pe.stage_dense(torch.as_tensor(np.array(desc1)),
                            torch.as_tensor(np.array(desc2)), *geo)
    _eq(D1, ref[0])
    _eq(D2, ref[1])


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_elas_process_matches_jax(preset):
    jp = PRESETS[preset]()
    I1, I2, disp = _gray_pair(W, H, seed=4)
    ref = JaxElas(jp, W, H).process(I1, I2)
    D1, D2 = ElasEngine(_port(jp), W, H, device="cpu").process(I1, I2)
    _eq(D1, ref[0])
    _eq(D2, ref[1])
    _check_sanity(D1, disp, 0.6)


def elas_full_width_kitti(subsampling):
    """The main path's full width: 1242x375, app_params(), D = 256, at full
    resolution or on the (187, 621) half lattice.  Each mode is the test
    test_elas_process_full_width_kitti of a file of its own
    (tests/test_torch_kitti_full.py, tests/test_torch_kitti_subsampled.py),
    so that the test runner's workers share the two (~4 min each on one
    core)."""
    w, h = 1242, 375
    I1, I2, disp = _gray_pair(w, h, seed=0)
    ref = JaxElas(j_app_params(subsampling=subsampling), w, h).process(I1, I2)
    D1, D2 = ElasEngine(svt.app_params(subsampling=subsampling), w, h,
                        device="cpu").process(I1, I2)
    assert D1.shape == ((187, 621) if subsampling else (h, w))
    _eq(D1, ref[0])
    _eq(D2, ref[1])
    _check_sanity(D1, disp, 0.8)


def test_process_frame_full_width_subsampled():
    """StereoEngine(subsampling=True).process_frame at 1242x375: the
    (187, 621) dmap and the (375 * 1242, 3) cloud, resized from it, match
    the JAX engine bit for bit."""
    w, h = 1242, 375
    left, right, _ = stereo_pair(w, h, seed=0)
    ref = JaxStereo(CALIB, w, h, subsampling=True,
                    use_pallas=False).process_frame(left, right)
    out = StereoEngine(CALIB, w, h, subsampling=True,
                       device="cpu").process_frame(left, right)
    assert out["dmap"].shape == (187, 621)
    assert out["points"].shape == (h * w, 3)
    _eq(out["disparity"], ref["disparity"])
    _eq(out["dmap"], ref["dmap"])
    _eq(out["points"], ref["points"])


FRAME_OPTIONS = {
    "default": {},
    "sky_metric": {"remove_sky": True, "true_scale_cloud": True},
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("opts", sorted(FRAME_OPTIONS))
def test_process_frame_matches_jax(opts, preset):
    """dmap (round half to even, x4, clipped uint8) and the Q-reprojected
    points (of the dmap resized to the frame's size under subsampling)
    match bit for bit."""
    kw = FRAME_OPTIONS[opts]
    jp = PRESETS[preset]()
    left, right, _ = stereo_pair(W, H, seed=8)
    ref = JaxStereo(CALIB, W, H, params=jp, use_pallas=False,
                    **kw).process_frame(left, right)
    out = StereoEngine(CALIB, W, H, params=_port(jp), device="cpu",
                       **kw).process_frame(left, right)
    assert out["dmap"].dtype == np.uint8
    assert out["dmap"].shape == jp.out_shape(W, H)
    assert out["points"].shape == (H * W, 3)
    _eq(out["dmap"], ref["dmap"])
    _eq(out["points"], ref["points"])
    # zero disparity reprojects to infinity, in both packages; the cloud's
    # pixel (s y, s x) takes a positive weight of dmap[y, x]
    Ho, Wo = out["dmap"].shape
    pts = out["points"].reshape(H, W, 3)[::H // Ho, ::W // Wo][:Ho, :Wo]
    assert np.isfinite(pts[out["dmap"] > 0]).all()


def test_display_disparity_rounds_half_to_even():
    """dmap = uint8(clip(round(4 * D1))): torch.round and jnp.round both
    round half to even, checked on disparities whose 4x is k + 0.5, and
    the Q reprojection of that dmap is bit-exact."""
    rng = np.random.default_rng(2)
    D = (rng.integers(-2, 70, (H, W)) + rng.choice(
        [0.0, 0.125, 0.375, 0.625, 0.875], (H, W))).astype(np.float32)
    jp = j_app_params().replace(disp_max=63)
    ref = JaxStereo(CALIB, W, H, params=jp, use_pallas=False)._reproject(
        jnp.asarray(D))
    dmap, points = StereoEngine(CALIB, W, H, params=_port(jp),
                                device="cpu").reproject(torch.as_tensor(D))
    _eq(dmap, ref[0])
    _eq(points, ref[1])
    halves = torch.tensor([0.125, 0.375, 2.625, 2.875])
    assert StereoEngine(CALIB, W, H, params=_port(jp), device="cpu") \
        .reproject(halves[None, :])[0].tolist() == [[0, 2, 10, 12]]


FLOAT_OPTIONS = {
    # name: (width, height, subsampling, StereoEngine options)
    "robot_frame": (W, H, False, {"robot_frame": True}),
    "pc_extrapolation": (W, H, False, {"pc_extrapolation": 2}),
    "pc_extrapolation_3": (W, H, False, {"pc_extrapolation": 3}),
    "subsampled_kitti": (1242, 375, True, {}),
}


@pytest.mark.parametrize("opts", sorted(FLOAT_OPTIONS))
def test_process_frame_float_options(opts):
    """The float tail matches bit for bit: robot_frame (points @ XR.T + XT,
    a 3-term float32 product) and the resize of dmap to the cloud's size,
    which must compute what jitted jax.image.resize(..., "linear") does
    (its own weights, columns contracted before rows, each output
    fma(w1, x1, w0*x0)): by 2 and 3 at 160x120 (process_frame), and the
    half lattice's (187, 621) -> (375, 1242) at KITTI width (reproject of
    a random map).  A random map goes through reproject in every case;
    NaN (from infinite points times zero rotation entries) counts as equal
    to NaN."""
    w, h, sub, kw = FLOAT_OPTIONS[opts]
    jp = j_app_params(subsampling=sub)
    if w == W:
        jp = jp.replace(disp_max=63)
    ref_eng = JaxStereo(CALIB, w, h, params=jp, use_pallas=False, **kw)
    eng = StereoEngine(CALIB, w, h, params=_port(jp), device="cpu", **kw)
    rng = np.random.default_rng(5)
    D = (rng.integers(-2, 70, jp.out_shape(w, h))
         + rng.random(jp.out_shape(w, h))).astype(np.float32)
    ref = ref_eng._reproject(jnp.asarray(D))
    dmap, points = eng.reproject(torch.as_tensor(D))
    _eq(dmap, ref[0])
    np.testing.assert_array_equal(points.numpy(), np.asarray(ref[1]))
    if w == W:
        left, right, _ = stereo_pair(w, h, seed=9)
        ref = ref_eng.process_frame(left, right)
        out = eng.process_frame(left, right)
        _eq(out["dmap"], ref["dmap"])
        np.testing.assert_array_equal(out["points"],
                                      np.asarray(ref["points"]))
