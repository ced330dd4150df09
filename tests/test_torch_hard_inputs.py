"""The oracles of the four kernels held against the JAX package on hard
inputs (tests/hard_inputs.py), bit for bit.

The port's plain versions, `postprocess.remove_small_segments` (K3), the
support scan under `support_matches` (K2), the key scan under
`matching.compute_disparity` (K1) and `postprocess.lr_consistency_check`
(K4), are what the CUDA kernels are held against on the card
(tests/test_torch_kernels.py, chip_smoke.py); here the same NumPy inputs go
through them and through the JAX package's XLA functions, jitted (a batch:
jitted `jax.vmap`).  The speckle maps run at full resolution and with the
half lattice's threshold; the support scan with disp_min > 0 and with
disp_max above the frame's width, on the raw grid (apply_filters=False),
where the scan's minima decide the result; the matching pass, both
images, at full resolution and on the half lattice, on hard masks, plane
tables and descriptors; the L/R check with the full and the half warp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.ops import matching as j_matching
from stereovision_tpu.ops import postprocess as j_post
from stereovision_tpu.ops import support as j_support
from stereovision_tpu.params import app_params as j_app_params

from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.ops.cuda import lr_cu, matching_cu, support_cu

import hard_inputs
from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

MODES = ["full", "subsampled"]


def _params(mode, **kw):
    jp = j_app_params(subsampling=mode == "subsampled").replace(**kw)
    return jp, params_from_dict(dataclasses.asdict(jp))


def _eq(port, ref):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        port.shape, port.dtype, ref.shape, ref.dtype)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


@pytest.mark.parametrize("size", hard_inputs.MAP_SIZES)
@pytest.mark.parametrize("name", sorted(hard_inputs.MAPS))
@pytest.mark.parametrize("mode", MODES)
def test_speckle_hard_maps(mode, name, size):
    jp, p = _params(mode)
    W, H = size
    D = hard_inputs.MAPS[name](H, W, p.speckle_sim_threshold,
                               post.speckle_threshold(p), seed=7)
    ref = jax.jit(lambda x: j_post.remove_small_segments(x, jp))(
        jnp.asarray(D))
    out = post.remove_small_segments(torch.as_tensor(D), p)
    _eq(out, ref)
    kept = out.numpy() >= 0
    if name in ("whole", "serpentine_rows", "serpentine_cols", "stripes_at"):
        assert kept.sum() == (D >= 0).sum()   # one component per band/path
    if name in ("checkerboard", "stripes_above"):
        assert not kept.any()                 # every piece under speckle
    if name == "blobs":
        assert (~kept).sum() == hard_inputs.blobs_removed(
            post.speckle_threshold(p))


@pytest.mark.parametrize("size", hard_inputs.MAP_SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_speckle_batch_frames_do_not_join(mode, size):
    """Frame b's last row repeats in frame b + 1's first row: each half is
    under speckle and goes, as it does frame by frame."""
    jp, p = _params(mode)
    W, H = size
    Ds = hard_inputs.touching_batch(H, W, p.speckle_sim_threshold,
                                    post.speckle_threshold(p), seed=11)
    ref = jax.jit(jax.vmap(lambda x: j_post.remove_small_segments(x, jp)))(
        jnp.asarray(Ds))
    out = post.remove_small_segments(torch.as_tensor(Ds), p)
    _eq(out, ref)
    assert (out.numpy()[:, [0, H - 1]] == -10).all()


@pytest.mark.parametrize("case", hard_inputs.SCAN_CASES,
                         ids=hard_inputs.case_id)
@pytest.mark.parametrize("mode", MODES)
def test_support_raw_grid_hard_ranges(mode, case):
    W, H, d_min, d_max, levels = case
    jp, p = _params(mode, disp_min=d_min, disp_max=d_max)
    desc1, desc2 = hard_inputs.descriptors(H, W, seed=d_max, levels=levels)
    ref = jax.jit(lambda a, b: j_support.support_matches(
        a, b, jp, apply_filters=False))(jnp.asarray(desc1),
                                        jnp.asarray(desc2))
    out = support_cu.support_matches(torch.as_tensor(desc1),
                                     torch.as_tensor(desc2), p,
                                     apply_filters=False)
    _eq(out, ref)
    if levels == 256:
        assert (out.numpy() >= 0).sum() > 20


@pytest.mark.parametrize("case", hard_inputs.MATCH_CASES,
                         ids=hard_inputs.case_id)
@pytest.mark.parametrize("mode", MODES)
def test_matching_hard_inputs(mode, case):
    """Both passes of the matching pass: the port's compute_disparity
    (the plain key scan on the CPU) against the JAX package's.  On the
    half lattice an odd width loses its last column: the JAX function
    takes only even widths there (its SAD image keeps ceil(W / 2)
    columns against a W // 2 lattice)."""
    W, H, disp_max, mask, desc = case
    if mode == "subsampled":
        W -= W % 2
    jp, p = _params(mode, disp_max=disp_max)
    desc1, desc2, passes = hard_inputs.match_inputs(
        W, H, disp_max, mask, desc, mode == "subsampled", p.grid_dims(W, H))
    for (a, b), (tid, planes, gm), right in zip(
            ((desc1, desc2), (desc2, desc1)), passes, (False, True)):
        ref = jax.jit(lambda *x: j_matching.compute_disparity(
            *x, jp, right_image=right))(*map(jnp.asarray,
                                             (a, b, tid, planes, gm)))
        out = matching_cu.compute_disparity(
            *map(torch.as_tensor, (a, b, tid, planes, gm)), p,
            right_image=right)
        _eq(out, ref)
        d = out.numpy()
        assert (d == -10).any()                       # outside triangles
        if mask != "none":
            assert (d >= 0).sum() > d.size // 4


@pytest.mark.parametrize("size", hard_inputs.MAP_SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_lr_check_hard_maps(mode, size):
    """The port's lr_consistency_check (the plain version on the CPU)
    against the JAX package's, both directions."""
    jp, p = _params(mode)
    W, H = size
    D1, D2 = hard_inputs.lr_maps(H, W, 0.5 if p.subsampling else 1.0,
                                 p.lr_threshold, seed=13)
    refs = jax.jit(lambda a, b: j_post.lr_consistency_check(a, b, jp))(
        jnp.asarray(D1), jnp.asarray(D2))
    outs = lr_cu.lr_consistency_check(torch.as_tensor(D1),
                                      torch.as_tensor(D2), p)
    for out, ref in zip(outs, refs):
        _eq(out, ref)
    o1, o2 = (o.numpy() for o in outs)
    assert (o1[0] >= 0).any() and (o1[1] == -10).all()   # column 0; out
    assert (o2[2] >= 0).any() and (o2[3] == -10).all()   # column W-1; out
    # at the threshold kept, one above dropped (columns whose warp stays in)
    assert (o1[4, 10:] == 10).all() and (o1[6, 10:] == 10).all()
    assert (o1[5] == -10).all()
