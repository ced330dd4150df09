"""The support filters off the main path, held against the JAX package.

The four filters of ops/filters.py that no stage calls (sobel5x5, blob5x5,
checkerboard5x5, integral_image) bit for bit on random uint8 images at odd
sizes and with a leading batch dimension; and ElasEngine(host_filters=False),
whose snapshot support filters run on the device after K2, bit for bit
against the JAX engine's host_filters=False at full resolution and
subsampled, and through stream_batched's process pool and host threads.
"""

import dataclasses
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereovision_tpu.models.elas as jelas
from stereovision_tpu.ops import filters as jfilters
from stereovision_tpu.params import app_params as j_app_params
from stereovision_tpu.params import robotics_params as j_robotics_params

from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.ops import filters as pfilters
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CALIB = osp.join(ROOT, "stereovision_tpu_torch", "data",
                 "kitti_2011_09_26.yml")
W, H = 160, 120
FRAMES = 3


def _port(jp):
    return params_from_dict(dataclasses.asdict(jp))


def _eq(port, ref):
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        port.shape, ref.shape, port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


# ---- filters ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (37, 53), (120, 160),
                                   (3, 37, 53)])
@pytest.mark.parametrize("name", ["sobel5x5", "blob5x5", "checkerboard5x5",
                                  "integral_image"])
def test_filter_matches_jax(name, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    ref = getattr(jfilters, name)(jnp.asarray(img))
    out = getattr(pfilters, name)(torch.as_tensor(img))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.numpy().dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o.numpy(), r)


# ---- ElasEngine(host_filters=False) ------------------------------------------

PRESETS = {"full": lambda: j_robotics_params(disp_max=63),
           "sub": lambda: j_app_params(subsampling=True).replace(disp_max=63)}


@pytest.mark.parametrize("mode", sorted(PRESETS))
def test_elas_device_filters_match_jax(mode):
    """host_filters=False: K2 then the snapshot support filters on the
    device, no sequential filters on the host: the support grid and D1, D2
    match the JAX engine's host_filters=False bit for bit (and differ from
    the host-filtered grid)."""
    jp = PRESETS[mode]()
    left, right, _ = stereo_pair(W, H, seed=3)
    I1, I2 = bgr_to_gray(left), bgr_to_gray(right)
    je = jelas.ElasEngine(jp, W, H, host_filters=False)
    pe = ElasEngine(_port(jp), W, H, host_filters=False, device="cpu")
    assert pe.host_args[-1] is False
    _, _, j_can = je._stage_support(jnp.asarray(I1), jnp.asarray(I2))
    _, _, p_can = pe.stage_support(I1, I2)
    _eq(p_can, j_can)
    _, _, raw = ElasEngine(_port(jp), W, H, device="cpu").stage_support(
        I1, I2)
    assert not torch.equal(raw, p_can)
    ref = je.process(I1, I2)
    D1, D2 = pe.process(I1, I2)
    _eq(D1, ref[0])
    _eq(D2, ref[1])


def test_stream_batched_pool_gets_host_filters():
    """stream_batched of an engine whose ElasEngine has host_filters=False:
    the spawn pool's workers and the host threads run the host middle
    without the sequential filters, so every frame equals process_frame's
    (which runs ElasEngine.host_mid)."""
    jp = j_robotics_params(disp_max=63)
    frames = [stereo_pair(W, H, seed=30 + i)[:2] for i in range(FRAMES)]
    with StereoEngine(CALIB, W, H, params=_port(jp), device="cpu") as eng:
        eng.elas = ElasEngine(eng.p, W, H, host_filters=False, device="cpu")
        refs = [eng.process_frame(l, r) for l, r in frames]
        for workers in ("process", "thread"):
            outs = list(eng.stream_batched(iter(frames), batch=2,
                                           fetch="host",
                                           host_workers=workers))
            assert eng.host_mode == workers
            assert len(outs) == FRAMES
            for out, ref in zip(outs, refs):
                _eq(out["dmap"], ref["dmap"])
                _eq(out["points"], ref["points"])
    filtered = StereoEngine(CALIB, W, H, params=_port(jp),
                            device="cpu").process_frame(*frames[0])
    assert not np.array_equal(filtered["dmap"], refs[0]["dmap"])
