"""The port's CUDA kernels held against their plain PyTorch versions, one
frame and a batch of frames a launch.

Every test here needs the card: it is marked `cuda` and skips without
one.  The inputs are one frame of the port's own pipeline on the CPU (held
against the JAX package by tests/test_torch_ops.py), moved to the card,
and the hard inputs of tests/hard_inputs.py (held against the JAX package
by tests/test_torch_hard_inputs.py): every kernel runs each of them twice,
and the two runs must agree, which a race in the atomics or the shared
tables and windows would break.  At the end, beside the kernels: the
detector's rows on the card against the CPU's, and the C ABI driven by a
C program with no Python of its own (csrc/capi_example.c).
The file imports nothing of JAX, so it also runs where only PyTorch is
installed; tests/conftest.py imports jax, so leave it out there:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereovision_tpu_torch import capi
from stereovision_tpu_torch.engine import bgr_to_gray
from stereovision_tpu_torch.models import yolo
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.ops import matching, support
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.ops.cuda import (ccl_cu, lr_cu, matching_cu,
                                             support_cu)
from stereovision_tpu_torch.params import app_params, robotics_params
from stereovision_tpu_torch.synthetic import darknet_weights, stereo_pair

import hard_inputs
from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

PRESETS = {
    "app": lambda: app_params().replace(disp_max=63),
    "robotics": lambda: robotics_params(disp_max=63),
    "app_sub": lambda: app_params(subsampling=True).replace(disp_max=63),
    "robotics_sub": lambda: robotics_params(disp_max=63, subsampling=True),
}
# a width that is not a multiple of the kernels' 128-thread blocks
SIZES = [(160, 120), (333, 101)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _equal(kernel_out, plain_out):
    assert kernel_out.dtype == plain_out.dtype
    assert torch.equal(kernel_out.cpu(), plain_out.cpu()), \
        "%d elements differ" % int((kernel_out != plain_out).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_kernels_match_plain_versions(cuda, preset, size):
    """K2, K1 (both passes), K4 and K3 on one frame's real inputs, at full
    resolution and on the subsampled half lattice: the kernel's output
    equals the plain version's exactly."""
    p = PRESETS[preset]()
    w, h = size
    eng = ElasEngine(p, w, h, device="cpu")
    left, right, _ = stereo_pair(w, h, seed=3)
    desc1, desc2, d_can = eng.stage_support(bgr_to_gray(left),
                                            bgr_to_gray(right))
    geo = eng.upload_geometry(eng.host_mid(d_can.numpy()))
    passes = eng.dense_inputs(*geo)
    D = [matching.compute_disparity(a, b, *inputs, p, right_image=right)
         for (a, b), inputs, right in zip(((desc1, desc2), (desc2, desc1)),
                                          passes, (False, True))]

    d1, d2 = desc1.to(cuda), desc2.to(cuda)
    launched = support_cu.launches
    _equal(support_cu.support_scan(d1, d2, p), support.support_scan(d1, d2, p))
    assert support_cu.launches == launched + 1

    for (a, b), (tid, planes, gm), right in zip(((d1, d2), (d2, d1)), passes,
                                                (False, True)):
        maps = matching.plane_maps(tid.to(cuda), planes.to(cuda), p)
        gm = gm.to(cuda)
        _equal(matching_cu.match_keys(a, b, *maps, gm, p, right),
               matching.match_keys(a, b, *maps, gm, p, right))

    D1, D2 = D[0].to(cuda), D[1].to(cuda)
    for k, ref in zip(lr_cu.lr_consistency_check(D1, D2, p),
                      post.lr_consistency_check(D1, D2, p)):
        _equal(k, ref)
    L1 = post.lr_consistency_check(D1, D2, p)[0]
    _equal(ccl_cu.remove_small_segments(L1, p),
           post.remove_small_segments(L1, p))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_batched_kernels_match_plain_versions(cuda, preset):
    """The batched modes on a batch of 3 frames of real inputs: each
    kernel launches once a batch (K1 once a pass), and its output equals
    the plain version's batch and the kernel's own single-frame launches,
    exactly."""
    p = PRESETS[preset]()
    w, h = 333, 101
    eng = ElasEngine(p, w, h, device="cpu")
    pairs = np.stack([[bgr_to_gray(lf), bgr_to_gray(rf)] for lf, rf, _ in
                      (stereo_pair(w, h, seed=s) for s in (3, 4, 5))])
    desc1, desc2, d_can = eng.stage_support_batched(pairs)
    buf = torch.as_tensor(np.stack([
        eng.pack_geometry(eng.host_mid(d_can[i].numpy())) for i in range(3)]))
    passes = eng.dense_inputs(*eng.unpack_geometry(buf))
    D = [matching.compute_disparity(a, b, *inputs, p, right_image=right)
         for (a, b), inputs, right in zip(((desc1, desc2), (desc2, desc1)),
                                          passes, (False, True))]

    def once(wrapper, fn, *args):
        before = wrapper.launches
        out = fn(*args)
        assert wrapper.launches == before + 1
        return out

    d1, d2 = desc1.to(cuda), desc2.to(cuda)
    scan = once(support_cu, support_cu.support_scan, d1, d2, p)
    _equal(scan, support.support_scan(d1, d2, p))
    for i in range(3):
        _equal(scan[i], support_cu.support_scan(d1[i].clone(), d2[i].clone(),
                                                p))

    for (a, b), (tid, planes, gm), right in zip(((d1, d2), (d2, d1)), passes,
                                                (False, True)):
        maps = matching.plane_maps(tid.to(cuda), planes.to(cuda), p)
        gm = gm.to(cuda)
        keys = once(matching_cu, matching_cu.match_keys, a, b, *maps, gm, p,
                    right)
        _equal(keys, matching.match_keys(a, b, *maps, gm, p, right))
        for i in range(3):
            # clones: a frame's slice need not be 16-byte aligned
            _equal(keys[i], matching_cu.match_keys(
                a[i], b[i], *(m[i].clone() for m in maps), gm[i], p, right))

    D1, D2 = D[0].to(cuda), D[1].to(cuda)
    checked = once(lr_cu, lr_cu.lr_consistency_check, D1, D2, p)
    for k, ref in zip(checked, post.lr_consistency_check(D1, D2, p)):
        _equal(k, ref)
    L1 = checked[0]
    speckled = once(ccl_cu, ccl_cu.remove_small_segments, L1, p)
    _equal(speckled, post.remove_small_segments(L1, p))
    for i in range(3):
        _equal(speckled[i], ccl_cu.remove_small_segments(L1[i].clone(), p))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _twice(fn, *args):
    """fn run twice on the same inputs: both runs must agree."""
    first, second = fn(*args), fn(*args)
    for a, b in zip(_outputs(first), _outputs(second)):
        _equal(a, b)
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("size", hard_inputs.MAP_SIZES)
@pytest.mark.parametrize("name", sorted(hard_inputs.MAPS))
@pytest.mark.parametrize("subsampling", [False, True])
def test_speckle_kernel_hard_maps(cuda, subsampling, name, size):
    p = app_params(subsampling=subsampling)
    w, h = size
    D = torch.as_tensor(hard_inputs.MAPS[name](
        h, w, p.speckle_sim_threshold, post.speckle_threshold(p),
        seed=7)).to(cuda)
    _equal(_twice(ccl_cu.remove_small_segments, D, p),
           post.remove_small_segments(D, p))


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", [False, True])
def test_speckle_kernel_kitti_single_component(cuda, subsampling):
    """One component over a whole KITTI-size map (1242 x 375, or its half
    lattice): the longest chains the union-find can meet."""
    p = app_params(subsampling=subsampling)
    h, w = p.out_shape(1242, 375)
    D = torch.as_tensor(hard_inputs.whole(
        h, w, p.speckle_sim_threshold, post.speckle_threshold(p),
        seed=5)).to(cuda)
    out = _twice(ccl_cu.remove_small_segments, D, p)
    _equal(out, post.remove_small_segments(D, p))
    assert torch.equal(out, D)


@pytest.mark.cuda
@pytest.mark.parametrize("size", hard_inputs.MAP_SIZES)
@pytest.mark.parametrize("subsampling", [False, True])
def test_speckle_kernel_batch_frames_do_not_join(cuda, subsampling, size):
    p = app_params(subsampling=subsampling)
    w, h = size
    Ds = torch.as_tensor(hard_inputs.touching_batch(
        h, w, p.speckle_sim_threshold, post.speckle_threshold(p),
        seed=11)).to(cuda)
    out = _twice(ccl_cu.remove_small_segments, Ds, p)
    _equal(out, post.remove_small_segments(Ds, p))
    for i in range(len(Ds)):
        _equal(out[i], ccl_cu.remove_small_segments(Ds[i].clone(), p))


@pytest.mark.cuda
@pytest.mark.parametrize("case", hard_inputs.SCAN_CASES,
                         ids=hard_inputs.case_id)
@pytest.mark.parametrize("subsampling", [False, True])
def test_support_kernel_hard_ranges(cuda, subsampling, case):
    """disp_min > 0, disp_max above the frame's width, ties."""
    w, h, d_min, d_max, levels = case
    p = app_params(subsampling=subsampling).replace(disp_min=d_min,
                                                    disp_max=d_max)
    d1, d2 = (torch.as_tensor(x).to(cuda) for x in hard_inputs.descriptors(
        h, w, seed=d_max, levels=levels))
    _equal(_twice(support_cu.launch, d1, d2, p),
           support.support_scan(d1, d2, p))


@pytest.mark.cuda
def test_support_kernel_span_ceiling(cuda):
    """The widest d range whose window fits one block's shared memory runs
    exactly; one d more raises a ValueError before any launch."""
    span = support_cu.max_span()
    assert span >= 256
    p = app_params().replace(disp_min=span - 40, disp_max=span)
    d1, d2 = (torch.as_tensor(x).to(cuda) for x in hard_inputs.descriptors(
        12, span + 21, seed=3))
    _equal(_twice(support_cu.launch, d1, d2, p),
           support.support_scan(d1, d2, p))
    launched = support_cu.launches
    with pytest.raises(ValueError, match="shared memory"):
        support_cu.launch(d1, d2, p.replace(disp_max=span + 1))
    assert support_cu.launches == launched


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", [False, True])
def test_support_kernel_kitti_random_descriptors(cuda, subsampling):
    """Random descriptors at KITTI size, D = 256, one frame and a batch of
    3 (each frame also launched alone)."""
    p = app_params(subsampling=subsampling)
    assert p.disp_num == 256
    pairs = [hard_inputs.descriptors(375, 1242, seed=s) for s in (1, 2, 3)]
    d1 = torch.as_tensor(np.stack([a for a, _ in pairs])).to(cuda)
    d2 = torch.as_tensor(np.stack([b for _, b in pairs])).to(cuda)
    one = _twice(support_cu.support_scan, d1[0], d2[0], p)
    _equal(one, support.support_scan(d1[0], d2[0], p))
    batch = _twice(support_cu.support_scan, d1, d2, p)
    _equal(batch, support.support_scan(d1, d2, p))
    for i in range(3):
        _equal(batch[i], support_cu.support_scan(d1[i], d2[i], p))


@pytest.mark.cuda
@pytest.mark.parametrize("case", hard_inputs.MATCH_CASES,
                         ids=hard_inputs.case_id)
@pytest.mark.parametrize("subsampling", [False, True])
def test_matching_kernel_hard_inputs(cuda, subsampling, case):
    """Grid masks all, none and randomly set; windows at 0 and D - 1,
    centres outside [0, D), slopes that switch the prior off; constant and
    two-level descriptors (ties); disp_max above the width.  Both passes."""
    W, H, disp_max, mask, desc = case
    p = app_params(subsampling=subsampling).replace(disp_max=disp_max)
    desc1, desc2, passes = hard_inputs.match_inputs(
        W, H, disp_max, mask, desc, subsampling, p.grid_dims(W, H))
    d1, d2 = torch.as_tensor(desc1).to(cuda), torch.as_tensor(desc2).to(cuda)
    for (a, b), (tid, planes, gm), right in zip(((d1, d2), (d2, d1)), passes,
                                                (False, True)):
        maps = matching.plane_maps(torch.as_tensor(tid).to(cuda),
                                   torch.as_tensor(planes).to(cuda), p)
        gm = torch.as_tensor(gm).to(cuda)
        _equal(_twice(matching_cu.match_keys, a, b, *maps, gm, p, right),
               matching.match_keys(a, b, *maps, gm, p, right))


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", [False, True])
def test_matching_kernel_kitti_random_descriptors(cuda, subsampling):
    """Random descriptors, masks and plane tables at KITTI size, D = 256,
    both passes, one frame and a batch of 3 (each frame also launched
    alone, from its slice of the batch)."""
    p = app_params(subsampling=subsampling)
    assert p.disp_num == 256
    W, H = 1242, 375
    frames = [hard_inputs.match_inputs(W, H, p.disp_max, "random", "random",
                                       subsampling, p.grid_dims(W, H),
                                       seed=s) for s in (1, 2, 3)]

    def stack(pick):
        return torch.as_tensor(np.stack([pick(f) for f in frames])).to(cuda)

    d1, d2 = stack(lambda f: f[0]), stack(lambda f: f[1])
    for k, (a, b), right in ((0, (d1, d2), False), (1, (d2, d1), True)):
        maps = matching.plane_maps(stack(lambda f: f[2][k][0]),
                                   stack(lambda f: f[2][k][1]), p)
        gm = stack(lambda f: f[2][k][2])
        one = _twice(matching_cu.match_keys, a[0], b[0],
                     *(m[0] for m in maps), gm[0], p, right)
        _equal(one, matching.match_keys(a[0], b[0], *(m[0] for m in maps),
                                        gm[0], p, right))
        batch = _twice(matching_cu.match_keys, a, b, *maps, gm, p, right)
        _equal(batch, matching.match_keys(a, b, *maps, gm, p, right))
        for i in range(3):
            _equal(batch[i], matching_cu.match_keys(
                a[i], b[i], *(m[i] for m in maps), gm[i], p, right))


def _span_inputs(p, W, H, span, device):
    """Descriptors, plane maps and a grid mask for the matching kernel's
    ceiling: candidates at d = span, span - 1, span - 7 and two small ones
    in every cell, a window around span - 1, and descriptors that match at
    d = span - 1 (the first 16 rows), so the farthest columns win."""
    desc1, desc2 = (torch.as_tensor(x).to(device) for x in
                    hard_inputs.descriptors(H, W, seed=5, shift=span - 1))
    gw, gh = p.grid_dims(W, H)
    gm = np.zeros((p.disp_num, gh, gw), bool)
    gm[[3, 40, span - 7, span - 1, span]] = True
    Ho, Wo = p.out_shape(W, H)
    maps = matching.plane_maps(
        torch.zeros((Ho, Wo), dtype=torch.int32, device=device),
        torch.tensor([[0.0, 0.0, span - 0.5, 0.0]], device=device), p)
    return desc1, desc2, maps, torch.as_tensor(gm).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", [False, True])
def test_matching_kernel_span_ceiling(cuda, subsampling):
    """The widest window min(disp_max, W - 3) that fits one block's shared
    memory runs exactly, both passes; one column more raises a ValueError
    before any launch."""
    p = app_params(subsampling=subsampling).replace(disp_max=20000)
    span = matching_cu.max_span(p)
    assert 256 < span < p.disp_max
    prior = matching_cu.prior_table(p, cuda)
    W, H = span + 3, 6
    d1, d2, maps, gm = _span_inputs(p, W, H, span, cuda)
    for a, b, right in ((d1, d2, False), (d2, d1, True)):
        keys = _twice(matching_cu.launch, a, b, *maps, gm, prior, p, right)
        _equal(keys, matching.match_keys(a, b, *maps, gm, p, right))
        # the window's farthest columns decide keys: zeroed, keys move
        far = b.clone()
        if right:
            far[..., W - 10:W - 2] = 0
        else:
            far[..., 2:10] = 0
        moved = matching_cu.launch(a, far, *maps, gm, prior, p, right)
        _equal(moved, matching.match_keys(a, far, *maps, gm, p, right))
        assert not torch.equal(moved, keys)
    d1, d2, maps, gm = _span_inputs(p, W + 1, H, span, cuda)
    launched = matching_cu.launches
    with pytest.raises(ValueError, match="shared memory"):
        matching_cu.launch(d1, d2, *maps, gm, prior, p, False)
    assert matching_cu.launches == launched


@pytest.mark.cuda
@pytest.mark.parametrize("size", hard_inputs.MAP_SIZES)
@pytest.mark.parametrize("subsampling", [False, True])
def test_lr_kernel_hard_maps(cuda, subsampling, size):
    """The codes -1 and -10, warps onto columns 0 and W - 1 and just past
    them, differences at the threshold and one above; full and half warp;
    one frame and the maps twice as a batch of 2."""
    p = app_params(subsampling=subsampling)
    w, h = size
    D1, D2 = (torch.as_tensor(m).to(cuda) for m in hard_inputs.lr_maps(
        h, w, post.lr_warp_scale(p), p.lr_threshold, seed=13))
    for k, ref in zip(_twice(lr_cu.lr_consistency_check, D1, D2, p),
                      post.lr_consistency_check(D1, D2, p)):
        _equal(k, ref)
    B1, B2 = torch.stack([D1, D2.flip(-1)]), torch.stack([D2, D1.flip(-1)])
    for k, ref in zip(_twice(lr_cu.lr_consistency_check, B1, B2, p),
                      post.lr_consistency_check(B1, B2, p)):
        _equal(k, ref)


@pytest.mark.cuda
def test_lr_kernel_width_ceiling(cuda):
    """The widest row whose two maps fit one block's shared memory runs
    exactly; one column more raises a ValueError before any launch."""
    p = app_params()
    W = lr_cu.max_width()
    assert W >= 1242
    D1, D2 = (torch.as_tensor(m).to(cuda) for m in hard_inputs.lr_maps(
        7, W, 1.0, p.lr_threshold, seed=3))
    for k, ref in zip(_twice(lr_cu.launch, D1, D2, p),
                      post.lr_consistency_check(D1, D2, p)):
        _equal(k, ref)
    D1, D2 = (torch.as_tensor(m).to(cuda) for m in hard_inputs.lr_maps(
        7, W + 1, 1.0, p.lr_threshold, seed=3))
    launched = lr_cu.launches
    with pytest.raises(ValueError, match="shared memory"):
        lr_cu.launch(D1, D2, p)
    assert lr_cu.launches == launched


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The launch functions take only CUDA tensors: a CPU tensor handed
    past the wrapper's device dispatch raises before any build or launch."""
    p = app_params()
    with pytest.raises(ValueError, match="CUDA tensor"):
        matching_cu.launch(*(torch.zeros((16, 8, 32), dtype=torch.uint8),) * 2,
                           *(torch.zeros((8, 32), dtype=torch.int32),) * 4,
                           torch.zeros((256, 1, 2), dtype=torch.bool),
                           torch.zeros(256, dtype=torch.int32), p, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        support_cu.launch(*(torch.zeros((16, 8, 32), dtype=torch.uint8),) * 2,
                          p)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lr_cu.launch(*(torch.zeros((8, 32)),) * 2, p)


# ---- detection and the C ABI on the card ---------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_detections(a, b, conf_tol):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        dx, dy = dict(vars(x)), dict(vars(y))
        assert abs(dx.pop("conf") - dy.pop("conf")) <= conf_tol, (x, y)
        assert dx == dy


@pytest.mark.cuda
def test_detector_rows_match_cpu(cuda, tmp_path):
    """The built-in cfg at 608 on two KITTI-size frames: the card's rows
    (cuDNN's TF32 off) against the CPU's within rtol 1e-5, atol 1e-6 (the
    tolerance that holds the port to the JAX package), and the detections
    equal where the decision margins hold."""
    sections = yolo.builtin_yolov4_tiny_cfg()
    wpath = str(tmp_path / "w.weights")
    darknet_weights(wpath, sections, seed=0)
    cpu = yolo.YoloV4Tiny(sections, device="cpu")
    cpu.load_darknet_weights(wpath)
    card = yolo.YoloV4Tiny(sections, device=cuda)
    card.load_darknet_weights(wpath)
    frames = [stereo_pair(1242, 375, seed=s)[0] for s in (1, 2)]
    got, ref = card.rows(frames), cpu.rows(frames)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    tol = float(np.abs(got - ref)[..., 5:].max())
    for k, f in enumerate(frames):
        m = yolo.decision_margins(ref[k], got[k], f.shape[:2])
        if min(m.values()) > 1:
            _same_detections(card._rows_to_dets(got[k], f.shape[:2], 0.5, 0.4),
                             cpu._rows_to_dets(ref[k], f.shape[:2], 0.5, 0.4),
                             tol)


def run_plain_c_program(workdir, width, height, timeout):
    """Build csrc/capi_example.c with gcc -ldl and run it against the C ABI
    library in a subprocess that has no Python of its own, with this
    interpreter's path as its PYTHONPATH -> the CompletedProcess."""
    exe = os.path.join(workdir, "capi_example")
    r = subprocess.run(["gcc", os.path.join(ROOT, "stereovision_tpu_torch",
                                            "csrc", "capi_example.c"),
                        "-o", exe, "-ldl", "-lm"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [ROOT] + sys.path if p and os.path.isdir(p))
    return subprocess.run([exe, capi.library_path(), str(width),
                           str(height)], capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.mark.cuda
def test_capi_plain_c_program(cuda, tmp_path):
    """A C program with no Python of its own dlopens the C ABI library,
    which boots CPython, imports the port and runs two frames, each from a
    new buffer, on the card: finite clouds and each frame's colours."""
    r = run_plain_c_program(str(tmp_path), 160, 120, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "CAPI OK" in r.stdout and "colors=1,1" in r.stdout
