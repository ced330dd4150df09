"""The PyTorch port's engines held against the JAX package's, end to end.

Same NumPy frames into both: ElasEngine.process (D1, D2) and
StereoEngine.process_frame (dmap, points) must match bit for bit at
160x120 (D = 64, two presets) and at the main path's full width, 1242x375
under app_params() (D = 256), with every option of the frame tail
(remove_sky, true_scale_cloud, robot_frame, pc_extrapolation).  Plus: the
port
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
from stereovision_tpu_torch.convert import (geometry_to_torch,
                                            params_from_dict)
from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.synthetic import stereo_pair

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
W, H = 160, 120
PRESETS = {
    "app": lambda: j_app_params().replace(disp_max=63),
    "robotics": lambda: j_robotics_params(disp_max=63),
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


def test_subsampling_is_not_ported():
    with pytest.raises(NotImplementedError):
        ElasEngine(svt.app_params(subsampling=True), W, H, device="cpu")


def test_params_from_dict_round_trip():
    for make in PRESETS.values():
        jp = make()
        assert dataclasses.asdict(_port(jp)) == dataclasses.asdict(jp)
    assert _port(j_app_params()) == svt.app_params()
    with pytest.raises(ValueError):
        params_from_dict({"disp_max": 63})


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_stage_b_from_jax_geometry(preset):
    """The JAX host_mid products, carried over by convert.py, give the
    port's stage B the JAX engine's D1 and D2."""
    jp = PRESETS[preset]()
    I1, I2, _ = _gray_pair(W, H, seed=11)
    je = JaxElas(jp, W, H)
    desc1, desc2, d_can = je._stage_support(jnp.asarray(I1), jnp.asarray(I2))
    g = je.host_mid(np.asarray(d_can))
    ref = je._stage_dense(desc1, desc2, *(jnp.asarray(g[k]) for k in
                          ("pts", "tris_l", "tris_r", "tri_l", "tri_r")))
    pe = ElasEngine(_port(jp), W, H, device="cpu")
    geo = geometry_to_torch(g, "cpu")
    D1, D2 = pe.stage_dense(torch.as_tensor(np.array(desc1)),
                            torch.as_tensor(np.array(desc2)), *geo.values())
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
    valid = D1.numpy() >= 0
    assert valid.mean() > 0.6
    assert np.median(np.abs(D1.numpy()[valid] - disp[valid])) <= 1


def test_elas_process_full_width_kitti():
    """The main path's full width: 1242x375, app_params(), D = 256."""
    w, h = 1242, 375
    I1, I2, disp = _gray_pair(w, h, seed=0)
    ref = JaxElas(j_app_params(), w, h).process(I1, I2)
    D1, D2 = ElasEngine(svt.app_params(), w, h, device="cpu").process(I1, I2)
    _eq(D1, ref[0])
    _eq(D2, ref[1])
    valid = D1.numpy() >= 0
    assert valid.mean() > 0.8
    assert np.median(np.abs(D1.numpy()[valid] - disp[valid])) <= 1


FRAME_OPTIONS = {
    "default": {},
    "sky_metric": {"remove_sky": True, "true_scale_cloud": True},
}


@pytest.mark.parametrize("opts", sorted(FRAME_OPTIONS))
def test_process_frame_matches_jax(opts):
    """dmap (round half to even, x4, clipped uint8) and the Q-reprojected
    points match bit for bit."""
    kw = FRAME_OPTIONS[opts]
    jp = j_app_params().replace(disp_max=63)
    left, right, _ = stereo_pair(W, H, seed=8)
    ref = JaxStereo(CALIB, W, H, params=jp, use_pallas=False,
                    **kw).process_frame(left, right)
    out = StereoEngine(CALIB, W, H, params=_port(jp), device="cpu",
                       **kw).process_frame(left, right)
    assert out["dmap"].dtype == np.uint8 and out["dmap"].shape == (H, W)
    _eq(out["dmap"], ref["dmap"])
    _eq(out["points"], ref["points"])
    # zero disparity reprojects to infinity, in both packages
    shown = out["dmap"].reshape(-1) > 0
    assert np.isfinite(out["points"][shown]).all()


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


@pytest.mark.parametrize("opts", ["robot_frame", "pc_extrapolation"])
def test_process_frame_float_options(opts):
    """robot_frame (points @ XR.T + XT, a 3-term float32 product) and
    pc_extrapolation=2 (jax.image.resize "linear" against PyTorch's
    bilinear interpolation with align_corners=False: the same half-pixel
    weights 1/4 and 3/4 on small integers) match bit for bit too; NaN
    (from infinite points times zero rotation entries) counts as equal to
    NaN."""
    kw = ({"robot_frame": True} if opts == "robot_frame"
          else {"pc_extrapolation": 2})
    jp = j_app_params().replace(disp_max=63)
    left, right, _ = stereo_pair(W, H, seed=9)
    ref = JaxStereo(CALIB, W, H, params=jp, use_pallas=False,
                    **kw).process_frame(left, right)
    out = StereoEngine(CALIB, W, H, params=_port(jp), device="cpu",
                       **kw).process_frame(left, right)
    _eq(out["dmap"], ref["dmap"])
    np.testing.assert_array_equal(out["points"], np.asarray(ref["points"]))
