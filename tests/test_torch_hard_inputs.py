"""The oracles of the speckle kernel (K3) and the support kernel (K2) held
against the JAX package on hard inputs (tests/hard_inputs.py), bit for bit.

The port's plain versions, `postprocess.remove_small_segments` and the
support scan under `support_matches`, are what the CUDA kernels are held
against on the card (tests/test_torch_kernels.py, chip_smoke.py); here
the same NumPy inputs go through them and through the JAX package's XLA
functions, jitted (a batch: jitted `jax.vmap`).  The speckle maps run at
full resolution and with the half lattice's threshold; the support scan
with disp_min > 0 and with disp_max above the frame's width, on the raw
grid (apply_filters=False), where the scan's minima decide the result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.ops import postprocess as j_post
from stereovision_tpu.ops import support as j_support
from stereovision_tpu.params import app_params as j_app_params

from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.ops.cuda import support_cu

import hard_inputs

MODES = ["full", "subsampled"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread a torch call while this module runs: the maps
    are small, the plain CCL iterates many small ops, and a team of
    threads a call on a machine that the other test workers share costs
    far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
