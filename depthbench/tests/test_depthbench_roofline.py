"""roofline.py against chip_smoke.py's arithmetic on the same inputs at a
small size: the support scan's operations, the matching passes'
candidates, and each kernel's bound."""

import os

import numpy as np
import pytest

from depthbench import frames, roofline
from depthbench.reference.pipeline import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CALIB = os.path.join(ROOT, "depthbench", "data", "kitti_2011_09_26.yml")
W, H = 160, 120


@pytest.fixture
def smoke(monkeypatch):
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "W", W)
    monkeypatch.setattr(chip_smoke, "H", H)
    return chip_smoke


@pytest.mark.parametrize("sub", [False, True], ids=["full", "sub"])
def test_counts_equal_chip_smoke(smoke, sub):
    from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
    from stereovision_tpu_torch.ops import matching
    L, R = frames.stereo_pair(W, H, 11)
    ref = Reference(CALIB, W, H, sub).frame(L, R, keep=True)
    eng = StereoEngine(CALIB, W, H, subsampling=sub, device="cpu")
    p = eng.p
    assert roofline.support_ops(p, W, H) == smoke.support_ops(p)
    elas = eng.elas
    desc1, desc2, d_can = elas.stage_support(bgr_to_gray(L), bgr_to_gray(R))
    geo = elas.upload_geometry(elas.host_mid(d_can.numpy()))
    work = roofline.frame_work(p, W, H, ref["passes"])
    for side, (tid, planes, gm) in zip(("K1l", "K1r"),
                                       elas.dense_inputs(*geo)):
        maps = matching.plane_maps(tid, planes, p)
        n = smoke.n_candidates(p, maps, gm, side == "K1r")
        assert work[side][1] == 32 * n > 0
    Ho, Wo = p.out_shape(W, H)
    # chip_smoke's bytes and operations of one frame (its B = 1 rows)
    assert work["K2"] == (2 * 16 * H * W + 8 * -(-H // p.step) * W * 4,
                          smoke.support_ops(p))
    assert work["K3"] == (2 * Ho * Wo * 4, Ho * Wo * 16)
    assert work["K4"] == (4 * Ho * Wo * 4, 2 * Ho * Wo * 8)
    for k, (nbytes, ops) in work.items():
        t, _ = smoke.bound_ms(nbytes, ops)
        assert roofline.bound_s(nbytes, ops) * 1e3 == pytest.approx(t,
                                                                     rel=1e-12)


def test_batched_bounds_and_share():
    """A batch's bound is that of B frames' bytes and operations with one
    prior table; the share is calls times the bound over device time."""
    p = Reference(CALIB, W, H, False).p
    works = [{"K1l": (100.0, 3e6), "K1r": (100.0, 1e6), "K2": (1e9, 10.0),
              "K3": (2e6, 0.0), "K4": (0.0, 6.7e7)},
             {"K1l": (100.0, 5e6), "K1r": (100.0, 3e6), "K2": (3e9, 10.0),
              "K3": (4e6, 0.0), "K4": (0.0, 6.7e7)}]
    b = roofline.call_bounds(p, works, 2)
    assert b["K2"] == pytest.approx(4e9 / roofline.HBM_BYTES_PER_S)
    assert b["K4"] == pytest.approx(2 * 6.7e7 / roofline.OPS_PER_S)
    assert b["K1"] == pytest.approx(0.5 * (8e6 + 4e6) / roofline.OPS_PER_S)
    one = roofline.call_bounds(p, works, 1)
    assert one["K3"] == pytest.approx(3e6 / roofline.HBM_BYTES_PER_S)
    kernels = {"K2": [3, 3 * b["K2"] * 4], "K4": [1, b["K4"] * 4]}
    assert roofline.share(b, kernels) == pytest.approx(25.0)
    assert roofline.share(b, {}) is None


def test_support_ops_by_hand():
    p = Reference(CALIB, W, H, False).p.replace(disp_max=3)
    u = np.arange(W)
    total = 0
    for d in range(4):
        f_rows = set()
        fg = set(u[u >= d + 5]) | set(u[u <= W - d - 5] + d)
        for x in fg:
            f_rows |= {x - 2, x + 2}
        total += 64 * len(f_rows) + len(fg) + int((u >= d + 5).sum()) \
            + int((u <= W - d - 5).sum())
    assert roofline.support_ops(p, W, H) == -(-H // p.step) * total
