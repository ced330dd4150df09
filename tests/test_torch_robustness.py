"""The port on degenerate frames, held against the JAX package and, on the
card, against itself on the CPU.

The frames are those of tests/test_robustness.py, at its sizes and seeds
(synthetic.degenerate_frames): a flat 96x64 pair under the robotics preset
(no support point, no triangle, D1 all invalid) and under app_params(),
full resolution and subsampled (only the 6 corner points, planes at
disparity 0); an unrelated 96x64 pair (little survives the L/R check); a
32x24 frame under the robotics preset and under app_params(), whose D =
256 is far above the width.  On the CPU each frame's D1 and D2 equal the
JAX engine's bit for bit, with each JAX test's own assertion, and the
host middle's products equal JAX's; the subsampled support step equals
JAX's support_matches.

The tests marked `cuda` (skipped without a card) run chip_smoke.py's
phase 12 check on each frame: ElasEngine.process, process_jit (CUDA
graphs captured at that size), stage_support_batched +
stage_dense_batched at batch 2 and ShardedStereoPipeline on a (1, 2)
mesh of cuda:0 (the stripe launches of K1, K2, K4 and K3 banded), two
cases on a (1, 5) mesh too (every frame's rows padded): every D1 and D2
equal to the port's on the CPU bit for bit, and each kernel launched.  On the card,
from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_robustness.py

The JAX package is imported inside the CPU tests only: the card's machine
has no jax.
"""

import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.params import robotics_params
from stereovision_tpu_torch.synthetic import degenerate_frames

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CASES = degenerate_frames()
GEOMETRY = ("pts", "tris_l", "tris_r", "tri_l", "tri_r")


def _jax_params(p):
    from stereovision_tpu.params import ElasParams as JaxParams
    return JaxParams(**dataclasses.asdict(p))


def _jax_engine(p, w, h):
    from stereovision_tpu.models.elas import ElasEngine as JaxElas
    return JaxElas(_jax_params(p), w, h)


def _eq(port, ref):
    port = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


# each case's assertion from tests/test_robustness.py, on the port's D1
CHECKS = {
    "flat_robotics": lambda D1: bool((D1 < 0).all()),
    "flat_app": lambda D1: bool((D1 == 0).all()),
    "flat_app_subsampled": lambda D1: bool((D1 == 0).all()),
    "unrelated": lambda D1: float((D1 >= 0).float().mean()) < 0.3,
    "tiny_robotics": lambda D1: tuple(D1.shape) == (24, 32),
    "tiny_app": lambda D1: tuple(D1.shape) == (24, 32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_degenerate_frame_matches_jax(name):
    """ElasEngine.process: D1 and D2 equal the JAX engine's bit for bit."""
    p, L, R = CASES[name]
    h, w = L.shape
    J1, J2 = _jax_engine(p, w, h).process(L, R)
    D1, D2 = ElasEngine(p, w, h, device="cpu").process(L, R)
    _eq(D1, J1)
    _eq(D2, J2)
    assert CHECKS[name](D1), name


@pytest.mark.parametrize("name", ["flat_robotics", "flat_app",
                                  "flat_app_subsampled"])
def test_flat_frames_geometry_matches_jax(name):
    """A flat pair has no support point: the host middle gives no point
    and no triangle (robotics), or only the 6 corner points and their
    triangles (app_params()), equal to JAX's products bit for bit."""
    p, L, R = CASES[name]
    h, w = L.shape
    je = _jax_engine(p, w, h)
    pe = ElasEngine(p, w, h, device="cpu")
    _, _, d_can = pe.stage_support(L, R)
    d_can = d_can.numpy()
    assert (d_can < 0).all()
    g, ref = pe.host_mid(d_can), je.host_mid(d_can)
    for k in GEOMETRY:
        _eq(g[k], ref[k])
    n_pts = int((g["pts"][:, 0] >= 0).sum())
    n_tris = int((g["tris_l"][:, 0] >= 0).sum())
    if p.add_corners:
        assert n_pts == 6 and n_tris > 0
        assert (g["pts"][:6, 2] == 0).all()
    else:
        assert n_pts == 0 and n_tris == 0
        # one run a row, id 0xFFFF (no triangle)
        assert (g["tri_l"][:, 0, 1:] == 0xFF).all()


def test_support_matching_subsampled_step_matches_jax():
    """Subsampling forces the candidate step to 6 (reference
    elas.cpp:376-378): the port's support grid equals JAX's."""
    import jax.numpy as jnp
    from stereovision_tpu.ops import descriptor as j_desc
    from stereovision_tpu.ops import support as j_support
    from stereovision_tpu_torch.ops import descriptor, support
    p = robotics_params(disp_max=31, subsampling=True)
    assert p.step == 6
    h, w = 72, 96
    rng = np.random.default_rng(2)
    L = rng.integers(0, 255, (h, w), dtype=np.uint8)
    R = np.roll(L, -7, axis=1)
    ref = j_support.support_matches(
        j_desc.compute_descriptor(jnp.asarray(L)),
        j_desc.compute_descriptor(jnp.asarray(R)), _jax_params(p),
        apply_filters=False)
    got = support.support_matches(
        descriptor.compute_descriptor(torch.from_numpy(L)),
        descriptor.compute_descriptor(torch.from_numpy(R)), p,
        apply_filters=False)
    _eq(got, ref)
    assert (got >= 0).any()


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _smoke():
    """chip_smoke.py, whose phase 12 checks a degenerate frame on the card
    (check_degenerate)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", osp.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_degenerate_frame_on_the_card_equals_cpu(cuda, name):
    """Each path on the card (process, process_jit, the batched stages,
    the sharded pipeline), D1 and D2 equal to the CPU's bit for bit,
    launch counts those of the path: chip_smoke.py's phase 12 for one
    frame."""
    smoke = _smoke()
    smoke.check_degenerate(name, *CASES[name], smoke.card_line())
