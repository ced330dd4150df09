"""The port's detector (stereovision_tpu_torch/models/yolo.py) held against
the JAX package's on the CPU.

The cfg parser and the packaged cfg; the parameters of _init_random and of
a synthesized .weights file, bit for bit; the decoded rows of the forward
against JAX's jitted _fwd (small_cfg(160) and once at 608), within rtol
1e-5, atol 1e-6 (measured: 2.2e-6 relative, 4.3e-6 absolute at most); the
SAME max pool at stride 1; both resize branches; _nms and _rows_to_dets
exact on shared rows; and the whole detect path, compared only after its
decision margins (scores from the threshold, boxes from an integer, the
score order in a class) are asserted to exceed the rows' difference.
The card's rows against the CPU's: tests/test_torch_kernels.py (no JAX).
"""

import dataclasses
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.models import yolo as jyolo

from stereovision_tpu_torch.convert import yolo_params_from_jax
from stereovision_tpu_torch.models import yolo
from stereovision_tpu_torch.models.yolo import YoloV4Tiny
from stereovision_tpu_torch.synthetic import darknet_weights, stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


def small_cfg(size=160):
    """The built-in yolov4-tiny at a small input (as tests/test_yolo_oracle.py
    cuts it): every layer kind, both heads."""
    cfg = yolo.builtin_yolov4_tiny_cfg()
    cfg[0] = dict(cfg[0], width=str(size), height=str(size))
    return cfg


def pair(sections, wpath, seed=0):
    """The JAX detector and the port's (on the CPU) for one cfg, both with
    the weights file at wpath (None: random init from `seed`)."""
    j = jyolo.YoloV4Tiny(sections, seed=seed)
    p = YoloV4Tiny(sections, seed=seed, device="cpu")
    if wpath:
        j.load_darknet_weights(wpath)
        p.load_darknet_weights(wpath)
    return j, p


def jax_rows(j, frames):
    """JAX's rows of a list of BGR frames, through its own preprocessing."""
    imgs = np.stack([jyolo._resize_bilinear(
        np.ascontiguousarray(f[..., ::-1]), j.size, j.size) for f in frames])
    x = jnp.asarray(imgs.astype(np.float32) / 255.0)
    return np.asarray(jnp.concatenate(j._fwd(x), axis=1))


def det_tuples(dets):
    return [dataclasses.astuple(d) for d in dets]


def assert_same_detections(port, ref, conf_tol):
    """Equal name, box and colour; conf within the rows' difference."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        ta, tb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert abs(ta.pop("conf") - tb.pop("conf")) <= conf_tol, (a, b)
        assert ta == tb


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """small_cfg(160) with a synthesized weights file, in both packages."""
    d = tmp_path_factory.mktemp("yolo")
    sections = small_cfg(160)
    wpath = str(d / "synth.weights")
    darknet_weights(wpath, sections, seed=0)
    return sections, wpath, pair(sections, wpath)


# ---- cfg and parameters -----------------------------------------------------

def test_packaged_cfg_is_the_builtin_one():
    pkg = osp.join(ROOT, "stereovision_tpu_torch", "data", "yolo")
    for name in ("yolov4-tiny.cfg", "classes.txt"):
        assert open(osp.join(pkg, name), "rb").read() == open(osp.join(
            ROOT, "stereovision_tpu", "data", "yolo", name), "rb").read()
    parsed = yolo.parse_darknet_cfg(osp.join(pkg, "yolov4-tiny.cfg"))
    assert parsed == yolo.builtin_yolov4_tiny_cfg()
    assert parsed == jyolo.builtin_yolov4_tiny_cfg()
    m = YoloV4Tiny.from_files(device="cpu")
    assert m.class_names == jyolo.YoloV4Tiny.from_files().class_names
    assert len(m.class_names) == 80


def test_cfg_parser_matches_jax(tmp_path):
    cfg = tmp_path / "t.cfg"
    cfg.write_text("# comment\n[net]\nwidth = 416\nheight=416 # trailing\n"
                   "channels=3\nstray line\n\n[convolutional]\n"
                   "batch_normalize=1\nfilters=16\nsize=3\nstride=1\npad=1\n"
                   "activation=leaky\n[yolo]\nanchors = 1,2, 3,4\n")
    got = yolo.parse_darknet_cfg(str(cfg))
    assert got == jyolo.parse_darknet_cfg(str(cfg))
    assert got[0] == {"type": "net", "width": "416", "height": "416",
                      "channels": "3"}
    assert got[2]["anchors"] == "1,2, 3,4"


@pytest.mark.parametrize("seed", [0, 3])
def test_init_random_matches_jax_bit_for_bit(seed):
    j, p = pair(yolo.builtin_yolov4_tiny_cfg(), None, seed)
    state = p.state_dict()
    ref = yolo_params_from_jax(j.params)
    assert sorted(state) == sorted(ref)
    for k, v in ref.items():
        assert state[k].dtype == v.dtype == torch.float32
        assert torch.equal(state[k], v), k
    # yolov4-tiny: 6,053,502 parameters (the JAX package's test)
    n = sum(v.numel() for v in state.values())
    assert n == sum(c.w.size + c.b.size for c in j.params.values())
    assert abs(n - 6_053_502) < 1000


@pytest.mark.parametrize("header", ["v0.2.5", "v0.1.0"])
def test_weights_loader_matches_jax_bit_for_bit(tmp_path, header):
    """Batch norm folded in NumPy float32 as in JAX; both header layouts
    (an int64 seen counter from version 0.2 on, int32 before)."""
    sections = small_cfg(160)
    wpath = str(tmp_path / "w.weights")
    darknet_weights(wpath, sections, seed=5)
    if header == "v0.1.0":
        body = open(wpath, "rb").read()[20:]
        with open(wpath, "wb") as f:
            f.write(np.array([0, 1, 0, 7], np.int32).tobytes() + body)
    j, p = pair(sections, wpath)
    state = p.state_dict()
    for k, v in yolo_params_from_jax(j.params).items():
        assert torch.equal(state[k], v), k
    fresh = YoloV4Tiny(sections, device="cpu")
    assert not torch.equal(fresh.state_dict()["w0"], state["w0"])
    fresh.load_state_dict(yolo_params_from_jax(j.params))
    assert all(torch.equal(fresh.state_dict()[k], v)
               for k, v in state.items())


@pytest.mark.parametrize("extra", [10, -10])
def test_weights_size_mismatch_raises(tmp_path, extra):
    sections = small_cfg(160)
    wpath = str(tmp_path / "bad.weights")
    darknet_weights(wpath, sections, seed=0)
    data = open(wpath, "rb").read()
    with open(wpath, "wb") as f:
        f.write(data + np.zeros(extra, np.float32).tobytes() if extra > 0
                else data[:4 * extra])
    m = YoloV4Tiny(sections, device="cpu")
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with pytest.raises(ValueError):
        m.load_darknet_weights(wpath)
    with pytest.raises(ValueError):
        jyolo.YoloV4Tiny(sections).load_darknet_weights(wpath)
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())


def test_detector_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YoloV4Tiny(small_cfg(160))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YoloV4Tiny.from_files()


# ---- forward ----------------------------------------------------------------

def test_rows_match_jax_small(small):
    """Random images and synthetic frames through both forwards: the
    decoded rows, their (gh, gw, anchor) order included."""
    sections, _, (j, p) = small
    img = np.random.default_rng(11).random((2, 160, 160, 3), np.float32)
    ref = np.concatenate([np.asarray(o) for o in j._fwd(jnp.asarray(img))],
                         axis=1)
    with torch.no_grad():
        got = torch.cat(p(torch.from_numpy(img).permute(0, 3, 1, 2)
                          .contiguous()), dim=1).numpy()
    assert got.shape == ref.shape == (2, 3 * (5 * 5 + 10 * 10), 85)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    frames = [stereo_pair(120, 80, seed=s)[0] for s in (40, 41)]
    np.testing.assert_allclose(p.rows(frames), jax_rows(j, frames),
                               rtol=RTOL, atol=ATOL)


def test_rows_match_jax_608(tmp_path):
    """The built-in cfg at 608x608 on a KITTI-size synthetic frame."""
    sections = yolo.builtin_yolov4_tiny_cfg()
    wpath = str(tmp_path / "w.weights")
    darknet_weights(wpath, sections, seed=0)
    j, p = pair(sections, wpath)
    frames = [stereo_pair(1242, 375, seed=1)[0]]
    got, ref = p.rows(frames), jax_rows(j, frames)
    assert got.shape == (1, 3 * (19 * 19 + 38 * 38), 85)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_maxpool_same_matches_reduce_window():
    """XLA's SAME split (the low side gets total // 2) at every stride and
    size the cfgs use, odd and even inputs: yolov3-tiny's size=2 stride=1
    pads one column on the high side only."""
    rng = np.random.default_rng(0)
    for n_h, n_w in ((7, 9), (8, 8), (13, 5), (1, 4)):
        x = rng.normal(size=(2, 3, n_h, n_w)).astype(np.float32)
        for k, s in ((2, 1), (2, 2), (3, 1), (3, 2), (5, 1), (1, 1)):
            ref = np.asarray(jax.lax.reduce_window(
                jnp.asarray(x.transpose(0, 2, 3, 1)), -jnp.inf, jax.lax.max,
                (1, k, k, 1), (1, s, s, 1), "SAME")).transpose(0, 3, 1, 2)
            got = yolo._maxpool_same(torch.from_numpy(x), k, s).numpy()
            np.testing.assert_array_equal(got, ref)


def test_stride_1_maxpool_cfg_matches_jax():
    """A yolov3-tiny-style tail (size=2 stride=1 max pool on an odd grid)
    and a mish layer through both forwards."""
    cfg = small_cfg(88)[:10] + [
        {"type": "maxpool", "size": "2", "stride": "2"},
        {"type": "maxpool", "size": "2", "stride": "1"},
        {"type": "convolutional", "filters": "16", "size": "3", "stride": "1",
         "pad": "1", "activation": "mish", "batch_normalize": "1"},
        {"type": "convolutional", "filters": "255", "size": "1",
         "stride": "1", "pad": "1", "activation": "linear"},
        {"type": "yolo", "mask": "3,4,5",
         "anchors": "10,14, 23,27, 37,58, 81,82, 135,169, 344,319",
         "classes": "80", "num": "6"}]
    j, p = pair(cfg, None, seed=4)
    img = np.random.default_rng(2).random((1, 88, 88, 3), np.float32)
    ref = np.asarray(j._fwd(jnp.asarray(img))[0])
    with torch.no_grad():
        got = p(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())[0]
    assert got.shape == ref.shape == (1, 3 * 11 * 11, 85)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


# ---- preprocessing ----------------------------------------------------------

def _both_resizes(img, size):
    got = yolo._resize_bilinear(img, size, size, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (size, size, 3)
    return got.numpy(), np.asarray(jyolo._resize_bilinear(img, size, size))


def test_resize_with_cv2_matches_jax():
    img = stereo_pair(1242, 375, seed=3)[0][..., ::-1].copy()
    got, ref = _both_resizes(img, 608)
    assert ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_resize_without_cv2_matches_jax(monkeypatch):
    """cv2 hidden in both packages: jax.image.resize's float32 output, not
    cast back.  Upsampling both axes (the small cfg's 120x80 -> 160) is
    exact; the KITTI frame's shrinking width (1242 -> 608) is not: JAX
    makes the weights in float32 and contracts in its own order, the port
    in float64 (measured: 0.0104 at most on the 0-255 scale)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.ascontiguousarray(stereo_pair(120, 80, seed=4)[0][..., ::-1])
    got, ref = _both_resizes(img, 160)
    assert ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    for seed in (1, 2):
        img = stereo_pair(1242, 375, seed=seed)[0][..., ::-1].copy()
        img[..., 1] = np.random.default_rng(seed).integers(0, 256,
                                                           img.shape[:2])
        got, ref = _both_resizes(img, 608)
        assert np.abs(got - ref).max() <= 0.0125


def test_detect_without_cv2_matches_jax(small, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    _, _, (j, p) = small
    frames = [stereo_pair(120, 80, seed=s)[0] for s in (42, 43)]
    np.testing.assert_allclose(p.rows(frames), jax_rows(j, frames),
                               rtol=RTOL, atol=ATOL)


# ---- post-processing --------------------------------------------------------

def _crowded_rows(seed, n=600, nc=6):
    """Rows with many candidates a class, overlapping boxes, exact score
    ties and boxes of zero width."""
    rng = np.random.default_rng(seed)
    rows = np.empty((n, 5 + nc), np.float32)
    rows[:, 0:2] = rng.random((n, 2))
    rows[:, 2:4] = rng.random((n, 2)) * 0.3
    rows[::37, 2] = 0.0
    rows[:, 4] = rng.random(n)
    rows[:, 5:] = rng.random((n, nc))
    rows[5:40:7, 5] = rows[5, 5]
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_to_dets_and_nms_exact_on_shared_rows(seed):
    rows = _crowded_rows(seed)
    names = ["c%d" % i for i in range(4)]          # fewer names than classes
    j = jyolo.YoloV4Tiny.__new__(jyolo.YoloV4Tiny)
    j.class_names = names
    p = YoloV4Tiny(small_cfg(32), class_names=names, device="cpu")
    for hw, conf, nms in (((375, 1242), 0.5, 0.4), ((80, 120), 0.3, 0.1),
                          ((480, 640), 0.9, 0.7)):
        got = p._rows_to_dets(rows, hw, conf, nms)
        ref = j._rows_to_dets(rows, hw, conf, nms)
        assert len(ref) > 0
        assert det_tuples(got) == det_tuples(ref)
    rng = np.random.default_rng(seed)
    boxes = np.trunc(rng.random((300, 4)) * [600, 300, 80, 60])
    boxes[::11, 3] = 0
    scores = rng.random(300).astype(np.float32)
    for thr in (0.0, 0.4, 1.0):
        assert yolo._nms(boxes, scores, thr) == jyolo._nms(boxes, scores, thr)


def test_decision_margins():
    rows = _crowded_rows(0, n=50, nc=2)
    same = yolo.decision_margins(rows, rows, (80, 120), 0.5)
    assert same == {"scores": np.inf, "boxes": np.inf, "order": np.inf}
    moved = rows.copy()
    k = np.argmin(np.abs(rows[:, 5] - 0.5))
    moved[k, 5] = 1.0 - rows[k, 5]                 # across the threshold
    assert yolo.decision_margins(rows, moved, (80, 120), 0.5)["scores"] < 1


@pytest.mark.parametrize("batch", [1, 3])
def test_detect_matches_jax_after_margins(small, batch):
    """The whole detect path on synthetic frames: margins first (every
    decision further from its threshold than the rows moved it), then the
    detections, equal but for conf (within the rows' difference)."""
    _, _, (j, p) = small
    frames = [stereo_pair(120, 80, seed=s)[0] for s in (40, 41, 42)]
    got_rows, ref_rows = p.rows(frames), jax_rows(j, frames)
    for k, f in enumerate(frames):
        m = yolo.decision_margins(ref_rows[k], got_rows[k], f.shape[:2])
        assert min(m.values()) > 1, m
    tol = float(np.abs(got_rows - ref_rows)[..., 5:].max())
    if batch == 1:
        got = [p.detect(f) for f in frames]
        ref = [j.detect(f) for f in frames]
    else:
        got, ref = p.detect_batch(frames), j.detect_batch(frames)
    assert sum(len(d) for d in ref) > 0
    for a, b in zip(got, ref):
        assert_same_detections(a, b, tol)
