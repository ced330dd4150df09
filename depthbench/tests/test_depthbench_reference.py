"""The plain reference against the port's CPU path: display disparity and
cloud equal bit for bit at 160x120 and at 1242x375, full resolution and
subsampled; its rasterizer against the port's native one."""

import os

import numpy as np
import pytest

from depthbench import frames
from depthbench.reference import raster
from depthbench.reference.pipeline import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CALIB = os.path.join(ROOT, "depthbench", "data", "kitti_2011_09_26.yml")


def port_and_reference(W, H, sub, seed):
    from stereovision_tpu_torch.engine import StereoEngine
    L, R = frames.stereo_pair(W, H, seed)
    out = StereoEngine(CALIB, W, H, subsampling=sub,
                       device="cpu").process_frame(L, R)
    return out, Reference(CALIB, W, H, sub).frame(L, R)


@pytest.mark.parametrize("sub", [False, True], ids=["full", "sub"])
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_equals_port_small(sub, seed):
    out, ref = port_and_reference(160, 120, sub, seed)
    assert np.array_equal(out["dmap"], ref["dmap"])
    assert np.array_equal(out["points"], ref["points"], equal_nan=True)


@pytest.mark.parametrize("sub", [False, True], ids=["full", "sub"])
def test_reference_equals_port_kitti(sub):
    out, ref = port_and_reference(1242, 375, sub, 300000000007)
    assert out["dmap"].shape == ((187, 621) if sub else (375, 1242))
    assert np.array_equal(out["dmap"], ref["dmap"])
    assert np.array_equal(out["points"], ref["points"], equal_nan=True)


def test_calibration_is_a_frozen_copy():
    with open(CALIB, "rb") as f, open(os.path.join(
            ROOT, "stereovision_tpu_torch", "data",
            "kitti_2011_09_26.yml"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
def test_rasterizer_equals_native(right):
    """The fused rasterizer equals the port's native one where that library
    builds (g++ -O3 -march=native on a CPU with FMA), and the port's
    separately rounded NumPy one differs from both on some pixels."""
    from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
    from stereovision_tpu_torch.hostlib import geometry
    from stereovision_tpu_torch.hostlib import raster as port
    if port.get_lib() is None:
        pytest.skip("the port's native host library did not build here")
    eng = StereoEngine(CALIB, 1242, 375, device="cpu")
    L, R = frames.stereo_pair(1242, 375, 5)
    _, _, d_can = eng.elas.stage_support(bgr_to_gray(L), bgr_to_gray(R))
    d = port.filter_support_sequential(d_can.numpy(), eng.p)
    assert np.array_equal(d, raster.filter_support_sequential(
        d_can.numpy(), eng.p))
    g = geometry.host_geometry(d, eng.p, 1242, 375, rasterize=port.rasterize)
    tris = g["tris_r" if right else "tris_l"]
    mine = raster.rasterize(g["pts"], tris, right, 1242, 375)
    assert np.array_equal(mine, g["tri_id_r" if right else "tri_id_l"])
    plain = port.rasterize_tri_ids(g["pts"], tris, right, 1242, 375)
    assert (plain != mine).sum() > 0


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); "
            "import depthbench.reference.pipeline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'stereovision_tpu', 'stereovision_tpu_torch', 'jax', "
            "'jaxlib', 'flax'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("n_max", [None, 40], ids=["uncapped", "capped"])
def test_load_counts_equal_port_geometry(n_max):
    """The host middle's load that a run logs (support points, the count
    thinned from at the cap, triangles of each side) is the port's own
    host geometry's, with and without the cap reached."""
    from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
    from stereovision_tpu_torch.hostlib import geometry
    from stereovision_tpu_torch.hostlib import raster as port
    eng = StereoEngine(CALIB, 160, 120, device="cpu")
    L, R = frames.stereo_pair(160, 120, 3)
    ref = Reference(CALIB, 160, 120, False)
    if n_max is not None:
        ref.n_max, ref.t_max = n_max, 2 * n_max + 8
    _, _, d_can = eng.elas.stage_support(bgr_to_gray(L), bgr_to_gray(R))
    d = port.filter_support_sequential(d_can.numpy(), eng.p)
    found = len(geometry.support_points_from_grid(d, eng.p.step))
    g = geometry.host_geometry(d, eng.p, 160, 120, rasterize=port.rasterize,
                               n_cap=ref.n_max, notes=[])
    load = ref.frame(L, R)["load"]
    assert load["support"] == len(g["pts"])
    assert load["tris_l"] == len(g["tris_l"])
    assert load["tris_r"] == len(g["tris_r"])
    assert load["thinned_from"] == (found if n_max else 0)
    assert (load["support"] == n_max) if n_max else (found + 6 < ref.n_max)
