"""The PyTorch port's operators held against the JAX package, stage by stage.

Both packages get the same NumPy inputs: a seeded synthetic scene at
160x120 (textured, slanted ground plus two boxes, so that support points,
Delaunay and plane priors all do real work) run through the JAX engine's
XLA path (use_pallas=False, which tests/test_pallas_kernels.py holds
bit-exact against the Pallas kernels), at full resolution and on the
subsampled half lattice.  Every integer stage and every float stage on the
main path must match bit for bit.

The kernels themselves are held against their plain versions on the card
(tests/test_torch_kernels.py, marked `cuda`, and chip_smoke.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereovision_tpu.models.elas import ElasEngine as JaxElas
from stereovision_tpu.ops import descriptor as j_desc
from stereovision_tpu.ops import grid as j_grid
from stereovision_tpu.ops import matching as j_match
from stereovision_tpu.ops import planes as j_planes
from stereovision_tpu.ops import postprocess as j_post
from stereovision_tpu.ops import reproject as j_reproj
from stereovision_tpu.ops import spans as j_spans
from stereovision_tpu.ops import support as j_support
from stereovision_tpu.params import app_params as j_app_params
from stereovision_tpu.params import robotics_params as j_robotics_params

from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.engine import bgr_to_gray
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.ops import descriptor, grid, planes
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.ops import reproject, spans, support
from stereovision_tpu_torch.ops.cuda import (ccl_cu, lr_cu, matching_cu,
                                             support_cu)
from stereovision_tpu_torch.ops.fma import fma32
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

W, H = 160, 120
PRESETS = {
    "app": lambda: j_app_params().replace(disp_max=63),
    "robotics": lambda: j_robotics_params(disp_max=63),
    "app_sub": lambda: j_app_params(subsampling=True).replace(disp_max=63),
    "robotics_sub": lambda: j_robotics_params(disp_max=63, subsampling=True),
}


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(port, ref):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


@pytest.fixture(scope="module", params=sorted(PRESETS))
def stages(request):
    """Every intermediate of one frame through the JAX XLA path, plus the
    matching port parameter set."""
    jp = PRESETS[request.param]()
    p = params_from_dict(dataclasses.asdict(jp))
    left, right, _ = stereo_pair(W, H, seed=3)
    I1, I2 = bgr_to_gray(left), bgr_to_gray(right)
    je = JaxElas(jp, W, H)
    desc1, desc2, d_can = je._stage_support(jnp.asarray(I1), jnp.asarray(I2))
    g = je.host_mid(np.asarray(d_can))
    pts = jnp.asarray(g["pts"])
    # each stage jitted, as the engine runs it (XLA fuses multiply-adds
    # under jit only)
    fit = jax.jit(j_planes.fit_plane_tables)
    planes_l, _ = fit(pts, jnp.asarray(g["tris_l"]))
    _, planes_r = fit(pts, jnp.asarray(g["tris_r"]))
    Wo = jp.out_shape(W, H)[1]
    expand = jax.jit(j_spans.expand_tri_spans, static_argnums=1)
    tid_l = expand(jnp.asarray(g["tri_l"]), Wo)
    tid_r = expand(jnp.asarray(g["tri_r"]), Wo)
    gridf = jax.jit(lambda pts, right: j_grid.build_grid_mask(
        pts, jp, W, H, right_image=right), static_argnums=1)
    grid_l, grid_r = gridf(pts, False), gridf(pts, True)
    match = jax.jit(lambda a, b, t, pl, gm, right: j_match.compute_disparity(
        a, b, t, pl, gm, jp, right_image=right), static_argnums=5)
    D1 = match(desc1, desc2, tid_l, planes_l, grid_l, False)
    D2 = match(desc2, desc1, tid_r, planes_r, grid_r, True)
    L1, L2 = jax.jit(lambda a, b: j_post.lr_consistency_check(a, b, jp))(
        D1, D2)
    S1 = jax.jit(lambda x: j_post.remove_small_segments(x, jp))(L1)
    G1 = jax.jit(lambda x: j_post.gap_interpolation(x, jp))(S1)
    A1 = jax.jit(lambda x: j_post.adaptive_mean(x, jp))(G1)
    M1 = jax.jit(lambda x: j_post.median_filter(x, jp))(A1)
    return dict(jp=jp, p=p, Wo=Wo, I1=I1, I2=I2, desc1=desc1, desc2=desc2,
                d_can=d_can, g=g, planes_l=planes_l, planes_r=planes_r,
                tid_l=tid_l, tid_r=tid_r, grid_l=grid_l, grid_r=grid_r,
                D1=D1, D2=D2, L1=L1, L2=L2, S1=S1, G1=G1, A1=A1, M1=M1)


def test_descriptor_and_texture(stages):
    for img, ref in ((stages["I1"], stages["desc1"]),
                     (stages["I2"], stages["desc2"])):
        d = descriptor.compute_descriptor(_t(img))
        _eq(d, ref)
        _eq(descriptor.texture_sum(d), j_desc.texture_sum(ref))


def test_support_grid_raw(stages):
    d_can = support_cu.support_matches(_t(stages["desc1"]),
                                       _t(stages["desc2"]), stages["p"],
                                       apply_filters=False)
    _eq(d_can, stages["d_can"])
    assert (np.asarray(stages["d_can"]) >= 0).sum() > 50


def test_support_grid_snapshot_filters(stages):
    ref = j_support.support_matches(stages["desc1"], stages["desc2"],
                                    stages["jp"], apply_filters=True)
    _eq(support.support_matches(_t(stages["desc1"]), _t(stages["desc2"]),
                                stages["p"], apply_filters=True), ref)


def test_host_mid_products(stages):
    """Host filters, support points, Delaunay, rasterization, span codes."""
    g = ElasEngine(stages["p"], W, H, device="cpu").host_mid(
        np.asarray(stages["d_can"]))
    for k in ("pts", "tris_l", "tris_r", "tri_l", "tri_r"):
        _eq(g[k], stages["g"][k])
    assert (g["pts"][:, 2] >= 0).sum() > 20


def test_fit_plane_tables(stages):
    pts = _t(stages["g"]["pts"])
    pl, _ = planes.fit_plane_tables(pts, _t(stages["g"]["tris_l"]))
    _, pr = planes.fit_plane_tables(pts, _t(stages["g"]["tris_r"]))
    _eq(pl, stages["planes_l"])
    _eq(pr, stages["planes_r"])


def test_expand_tri_spans(stages):
    for tag in ("l", "r"):
        tid = spans.expand_tri_spans(_t(stages["g"]["tri_" + tag]),
                                     stages["Wo"])
        _eq(tid, np.asarray(stages["tid_" + tag]).astype(np.int32))


@pytest.mark.parametrize("right", [False, True])
def test_build_grid_mask(stages, right):
    m = grid.build_grid_mask(_t(stages["g"]["pts"]), stages["p"], W, H,
                             right_image=right)
    _eq(m, stages["grid_r" if right else "grid_l"])


@pytest.mark.parametrize("right", [False, True])
def test_matching_pass(stages, right):
    s = stages
    tag = "r" if right else "l"
    desc_self, desc_other = ((s["desc2"], s["desc1"]) if right
                             else (s["desc1"], s["desc2"]))
    D = matching_cu.compute_disparity(
        _t(desc_self), _t(desc_other), _t(s["tid_" + tag]),
        _t(s["planes_" + tag]), _t(s["grid_" + tag]), s["p"],
        right_image=right)
    _eq(D, s["D2" if right else "D1"])
    assert (D.numpy() >= 0).mean() > 0.5


def test_lr_check(stages):
    o1, o2 = lr_cu.lr_consistency_check(_t(stages["D1"]), _t(stages["D2"]),
                                        stages["p"])
    _eq(o1, stages["L1"])
    _eq(o2, stages["L2"])


def test_speckle(stages):
    _eq(ccl_cu.remove_small_segments(_t(stages["L1"]), stages["p"]),
        stages["S1"])


@pytest.mark.parametrize("subsampling", [False, True])
def test_speckle_removes_small_components(subsampling):
    """Segments under speckle_size (200) px go; on the half lattice the
    threshold is int(2 sqrt(200)) = 28 px."""
    jp = j_app_params(subsampling=subsampling)
    p = params_from_dict(dataclasses.asdict(jp))
    assert post.speckle_threshold(p) == (28 if subsampling else 200)
    D = np.full((40, 50), 7.0, np.float32)
    D[5:9, 5:9] = 30.0           # 16 px island: removed
    D[25:30, 10:16] = 50.0       # 30 px island: kept on the half lattice
    D[20, :] = -1.0              # invalid row: -10
    out = post.remove_small_segments(torch.as_tensor(D), p).numpy()
    _eq(out, jax.jit(lambda x: j_post.remove_small_segments(x, jp))(
        jnp.asarray(D)))
    assert (out[5:9, 5:9] == -10).all() and (out[20] == -10).all()
    assert (out[25:30, 10:16] == (50.0 if subsampling else -10.0)).all()


def test_gap_interpolation(stages):
    _eq(post.gap_interpolation(_t(stages["S1"]), stages["p"]), stages["G1"])


def test_adaptive_mean(stages):
    _eq(post.adaptive_mean(_t(stages["G1"]), stages["p"]), stages["A1"])


@pytest.mark.parametrize("subsampling", [False, True])
def test_adaptive_mean_random_fractional_map(subsampling):
    """Arbitrary float inputs exercise the rounding of every product: the
    XLA:CPU contraction fsum = fma(w0, t0, w1*t1), then fma(w_k, t_k,
    fsum), is reproduced exactly, with 8 taps and with the half lattice's
    4 (held against jitted JAX: eager JAX contracts nothing and differs),
    the latter on a map of the subsampled KITTI shape (187, 621)."""
    rng = np.random.default_rng(0)
    shape = (187, 621) if subsampling else (97, 131)
    D = (rng.integers(0, 60, shape) + rng.random(shape)).astype(np.float32)
    D[rng.random(D.shape) < 0.2] = -10.0
    jp = j_app_params(subsampling=subsampling)
    p = params_from_dict(dataclasses.asdict(jp))
    ref = jax.jit(lambda x: j_post.adaptive_mean(x, jp))(jnp.asarray(D))
    _eq(post.adaptive_mean(torch.as_tensor(D), p), ref)


def test_median(stages):
    _eq(post.median_filter(_t(stages["A1"]), stages["p"]), stages["M1"])


def test_reproject_q_rows():
    """Q rows as fma(q2, d, fma(q0, u, q1*v)) + q3: bit-exact points."""
    rng = np.random.default_rng(1)
    dmap = rng.integers(0, 256, (90, 140)).astype(np.uint8)
    Q = np.array([[1, 0, 0, -607.19], [0, 1, 0, -185.22],
                  [0, 0, 0, 721.54], [0, 0, 1.8622, 0]], np.float64)
    ref = jax.jit(lambda d: j_reproj.reproject(d, Q))(jnp.asarray(dmap))
    _eq(reproject.reproject(torch.as_tensor(dmap), Q), ref)


def test_fma32_rounds_once():
    """fma32 keeps the low bits a separately rounded product loses."""
    x = torch.tensor([1 + 2 ** -12], dtype=torch.float32)
    z = torch.tensor([-(1 + 2 ** -11)], dtype=torch.float32)
    assert (x * x + z).item() == 0.0
    assert fma32(x, x, z).item() == 2.0 ** -24


def test_wrappers_do_not_count_cpu_calls(stages):
    counts = [m.launches for m in (support_cu, matching_cu, lr_cu, ccl_cu)]
    lr_cu.lr_consistency_check(_t(stages["D1"]), _t(stages["D2"]),
                               stages["p"])
    ccl_cu.remove_small_segments(_t(stages["L1"]), stages["p"])
    assert [m.launches for m in (support_cu, matching_cu, lr_cu,
                                 ccl_cu)] == counts
