"""The port's multi-device layer (stereovision_tpu_torch/parallel/) held
against the JAX package on the CPU.

Meshes repeat the CPU device ([cpu] * 8, the port's counterpart of the
forced 8-device host platform of tests/conftest.py), so every split runs:
the kernel wrappers cut their inputs into row stripes and run the plain
versions once per shard.  Held bit for bit, -10 padding rows included:
  - the padded ops (true_height, pad_out_rows, true_shape) and
    ElasEngine(row_pad=(1, 1)) at 160x95 against the JAX ones;
  - ShardedStereoPipeline on [cpu] * 8 with tile=2 at 160x96 and 160x95
    under app_params(), and at 256x96 subsampled, against JAX's
    ShardedStereoPipeline(..., make_mesh(8, tile=2)) and against the
    port's single-device engine;
  - the banded speckle filter at 160x95 over 2 and 6 stripes against
    JAX's remove_small_segments, on maps whose components cross every
    stripe edge;
  - each stripe-launch wrapper's split against the unsplit plain version.
The kernels' stripe launches on the card: tests/test_torch_multihost.py
(marked cuda) and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.models.elas import ElasEngine as JaxElas
from stereovision_tpu.ops import descriptor as j_desc
from stereovision_tpu.ops import matching as j_match
from stereovision_tpu.ops import postprocess as j_post
from stereovision_tpu.ops import support as j_support
from stereovision_tpu.parallel.mesh import make_mesh as j_make_mesh
from stereovision_tpu.parallel.shard import ShardedStereoPipeline as JaxSharded
from stereovision_tpu.params import app_params as j_app_params

from stereovision_tpu_torch.convert import params_from_dict
from stereovision_tpu_torch.engine import bgr_to_gray
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.ops import descriptor, matching, support
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.ops.cuda import (ccl_cu, lr_cu, matching_cu,
                                             support_cu)
from stereovision_tpu_torch.parallel import ctx
from stereovision_tpu_torch.parallel.mesh import (Mesh, local_batch_indices,
                                                  make_mesh, multihost_mesh)
from stereovision_tpu_torch.parallel.shard import ShardedStereoPipeline
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _eq(port, ref):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    diff = port != ref
    assert not diff.any(), "%d of %d elements differ" % (diff.sum(), diff.size)


def _port(jp):
    return params_from_dict(dataclasses.asdict(jp))


def _frames(n, w, h, seed=0):
    L, R = [], []
    for s in range(n):
        left, right, _ = stereo_pair(w, h, seed=seed + s)
        L.append(bgr_to_gray(left))
        R.append(bgr_to_gray(right))
    return np.stack(L), np.stack(R)


def _cpu_mesh(n, **kw):
    return make_mesh(devices=[CPU] * n, **kw)


# ---- the mesh --------------------------------------------------------------


def test_mesh_shapes():
    assert _cpu_mesh(8).shape == {"stream": 8, "tile": 1}
    assert _cpu_mesh(8, tile=2).shape == {"stream": 4, "tile": 2}
    assert _cpu_mesh(8, stream=2).shape == {"stream": 2, "tile": 4}
    assert _cpu_mesh(8, n_devices=4, tile=4).shape == {"stream": 1,
                                                       "tile": 4}
    m = _cpu_mesh(4, tile=2)
    assert m.group(1).shape == {"stream": 1, "tile": 2}
    assert all(d == CPU for d in m.devices.ravel())


def test_mesh_rejects_bad_layouts():
    with pytest.raises(ValueError, match="stream 3 x tile 2"):
        _cpu_mesh(8, stream=3, tile=2)
    with pytest.raises(ValueError, match="mixes device types"):
        Mesh([[CPU, torch.device("cuda", 0)]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_multihost_mesh_one_process(tmp_path):
    """multihost_mesh over a one-process gloo group: processes on
    'stream', local devices on 'tile' (a 'tile' axis across two processes:
    tests/test_torch_multihost.py)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://%s" % (
        tmp_path / "store"), world_size=1, rank=0)
    try:
        m = multihost_mesh(local_devices=[CPU] * 2)
        assert m.shape == {"stream": 1, "tile": 2}
        assert list(m.processes) == [0]
        m = multihost_mesh(tile=1, local_devices=[CPU] * 2)
        assert m.shape == {"stream": 2, "tile": 1}
        assert list(local_batch_indices(4, m)) == [0, 1, 2, 3]
        with pytest.raises(ValueError, match="stream 3 x tile 1"):
            multihost_mesh(stream=3, tile=1, local_devices=[CPU] * 2)
    finally:
        dist.destroy_process_group()


def test_shard_kernel_splits_and_concatenates():
    """Batch over 'stream', rows over 'tile' (uneven stripes: the last is
    shorter), one call per shard, outputs concatenated on the input's
    device; an empty stripe is not launched; no context: one call."""
    x = torch.arange(4 * 7 * 3).reshape(4, 7, 3)
    calls = []

    def launch(shard, piece):
        calls.append((shard.stream, shard.tile, tuple(piece.shape)))
        return piece * 2

    spec = ctx.P("stream", "tile", None)
    assert torch.equal(ctx.shard_kernel(launch, (spec,), spec, x), x * 2)
    assert calls == [(0, 0, (4, 7, 3))]
    calls.clear()
    with ctx.kernel_mesh(_cpu_mesh(6, tile=3)):
        assert ctx.row_ranges(7) == [(0, 3), (3, 6), (6, 7)]
        assert ctx.batch_split(4) == 2
        assert torch.equal(ctx.shard_kernel(launch, (spec,), spec, x), x * 2)
        with pytest.raises(ValueError, match="not divisible"):
            ctx.batch_split(3)
    assert calls == [(s, t, (2, r, 3)) for s in range(2)
                     for t, r in enumerate((3, 3, 1))]
    calls.clear()
    with ctx.kernel_mesh(_cpu_mesh(4, tile=4)):
        assert ctx.row_ranges(2) == [(0, 1), (1, 2), (2, 2), (2, 2)]
        y = x[:1, :2]
        assert torch.equal(ctx.shard_kernel(launch, (spec,), spec, y), y * 2)
    assert [c[1] for c in calls] == [0, 1]
    assert ctx.current() is None and ctx.row_multiple() == 1


# ---- the padded ops and ElasEngine(row_pad) ---------------------------------

W, H = 160, 95


@pytest.fixture(scope="module", params=["full", "subsampled"])
def padded(request):
    """One frame at 160x95 with one padding row in and out
    (row_pad=(1, 1)) through the JAX engine's padded stages."""
    jp = j_app_params(subsampling=request.param == "subsampled")
    left, right, _ = stereo_pair(W, H, seed=3)
    I1, I2 = (np.pad(bgr_to_gray(x), ((0, 1), (0, 0)))
              for x in (left, right))
    je = JaxElas(jp, W, H, row_pad=(1, 1))
    desc1, desc2, d_can = je._stage_support(jnp.asarray(I1), jnp.asarray(I2))
    g = je.host_mid(np.asarray(d_can))
    D1, D2 = je._stage_dense(desc1, desc2, *(jnp.asarray(g[k]) for k in (
        "pts", "tris_l", "tris_r", "tri_l", "tri_r")))
    return dict(jp=jp, p=_port(jp), I1=I1, I2=I2, desc1=desc1, desc2=desc2,
                d_can=d_can, g=g, D1=D1, D2=D2)


def test_padded_descriptor(padded):
    for img, ref in ((padded["I1"], padded["desc1"]),
                     (padded["I2"], padded["desc2"])):
        d = descriptor.compute_descriptor(torch.as_tensor(img), H)
        _eq(d, ref)
        _eq(d, jax.jit(lambda x: j_desc.compute_descriptor(x, H))(img))
        assert not d[:, H - 3:].any()


def test_padded_support(padded):
    d1, d2 = (torch.as_tensor(np.array(padded[k]))
              for k in ("desc1", "desc2"))
    for filters in (False, True):
        ref = jax.jit(lambda a, b: j_support.support_matches(
            a, b, padded["jp"], apply_filters=filters, true_height=H))(
                padded["desc1"], padded["desc2"])
        _eq(support_cu.support_matches(d1, d2, padded["p"], filters,
                                       true_height=H), ref)
    _eq(support_cu.support_matches(d1, d2, padded["p"], False,
                                   true_height=H), padded["d_can"])


def test_padded_matching(padded):
    """compute_disparity with pad_out_rows on the padded lattice, both
    passes; a full-lattice tri_id is refused in padded mode, as the JAX
    function asserts."""
    p, jp = padded["p"], padded["jp"]
    eng = ElasEngine(p, W, H, device="cpu", row_pad=(1, 1))
    geo = eng.upload_geometry(padded["g"])
    (tid_l, pl_l, gm_l), (tid_r, pl_r, gm_r) = eng.dense_inputs(*geo)
    d1, d2 = (torch.as_tensor(np.array(padded[k]))
              for k in ("desc1", "desc2"))
    for a, b, tid, pl, gm, right in ((d1, d2, tid_l, pl_l, gm_l, False),
                                     (d2, d1, tid_r, pl_r, gm_r, True)):
        tid = torch.nn.functional.pad(tid, (0, 0, 0, 1), value=-1)
        ref = jax.jit(lambda a, b, t, pl, gm: j_match.compute_disparity(
            a, b, t, pl, gm, jp, right_image=right, true_height=H,
            pad_out_rows=1))(np.asarray(a), np.asarray(b), tid.numpy(),
                             pl.numpy(), gm.numpy())
        D = matching_cu.compute_disparity(a, b, tid, pl, gm, p, right, H, 1)
        _eq(D, ref)
        assert (D[-1] == -10).all()
    with pytest.raises(ValueError, match="lattice-shaped tri_id"):
        matching.compute_disparity(d1, d2, tid_l, pl_l, gm_l, p, False,
                                   true_height=H, pad_out_rows=1)


def test_padded_filters(padded):
    """adaptive_mean and median_filter with true_shape on a map with a
    padding row (its values kept as they are)."""
    p, jp = padded["p"], padded["jp"]
    Ho, Wo = p.out_shape(W, H)
    rng = np.random.default_rng(5)
    D = np.where(rng.random((Ho + 1, Wo)) < 0.8,
                 rng.integers(0, 60, (Ho + 1, Wo)), -10).astype(np.float32)
    for port_fn, jax_fn in ((post.adaptive_mean, j_post.adaptive_mean),
                            (post.median_filter, j_post.median_filter)):
        ref = jax.jit(lambda x: jax_fn(x, jp, true_shape=(Ho, Wo)))(D)
        out = port_fn(torch.as_tensor(D), p, (Ho, Wo))
        _eq(out, ref)
        _eq(out[Ho:], D[Ho:])


def test_elas_engine_row_pad(padded):
    """ElasEngine(row_pad=(1, 1)): stage A on the padded images and stage
    B equal the JAX engine's, the padding row -10; the real rows equal the
    unpadded engine's."""
    p = padded["p"]
    eng = ElasEngine(p, W, H, device="cpu", row_pad=(1, 1))
    desc1, desc2, d_can = eng.stage_support(padded["I1"], padded["I2"])
    _eq(desc1, padded["desc1"])
    _eq(d_can, padded["d_can"])
    D1, D2 = eng.stage_dense(desc1, desc2,
                             *eng.upload_geometry(eng.host_mid(d_can.numpy())))
    _eq(D1, padded["D1"])
    _eq(D2, padded["D2"])
    Ho = p.out_shape(W, H)[0]
    assert D1.shape[0] == Ho + 1 and (D1[Ho:] == -10).all()
    assert (D2[Ho:] == -10).all()
    ref1, ref2 = ElasEngine(p, W, H, device="cpu").process(
        padded["I1"][:H], padded["I2"][:H])
    _eq(D1[:Ho], ref1)
    _eq(D2[:Ho], ref2)


def test_elas_engine_row_pad_zero_changes_nothing():
    p = _port(j_app_params()).replace(disp_max=63)
    L, R = _frames(1, W, H, seed=7)
    a = ElasEngine(p, W, H, device="cpu").process(L[0], R[0])
    b = ElasEngine(p, W, H, device="cpu", row_pad=(0, 0)).process(L[0], R[0])
    for x, y in zip(a, b):
        _eq(x, y)


# ---- the sharded pipeline ---------------------------------------------------

PIPELINES = {"160x96": (160, 96, False), "160x95": (160, 95, False),
             "256x96_subsampled": (256, 96, True)}


@pytest.fixture(scope="module", params=sorted(PIPELINES))
def sharded(request):
    """Four frames through JAX's and the port's ShardedStereoPipeline on
    8 devices with tile=2, and the port's single-device engine."""
    w, h, sub = PIPELINES[request.param]
    jp = j_app_params(subsampling=sub)
    L, R = _frames(4, w, h, seed=11)
    jpipe = JaxSharded(jp, w, h, j_make_mesh(8, tile=2))
    jD1, jD2 = (np.asarray(x) for x in jpipe.run(L, R))
    p = _port(jp)
    with ShardedStereoPipeline(p, w, h, _cpu_mesh(8, tile=2)) as pipe:
        D1, D2 = pipe.run(L, R)
        crop = pipe.crop(D1)
    single = ElasEngine(p, w, h, device="cpu")
    ref = [single.process(L[i], R[i])[0] for i in range(4)]
    return dict(jpipe=jpipe, pipe=pipe, jD1=jD1, jD2=jD2, D1=D1, D2=D2,
                crop=crop, ref=ref)


def test_sharded_pipeline_padding(sharded):
    pipe, jpipe = sharded["pipe"], sharded["jpipe"]
    assert (pipe.pad_in, pipe.pad_out) == (jpipe.pad_in, jpipe.pad_out)
    assert (pipe.Ho, pipe.Wo) == (jpipe.Ho, jpipe.Wo)
    assert tuple(sharded["D1"].shape) == sharded["jD1"].shape
    assert (sharded["D1"][:, pipe.Ho:] == -10).all()
    assert (sharded["D2"][:, pipe.Ho:] == -10).all()


def test_sharded_pipeline_matches_jax(sharded):
    _eq(sharded["D1"], sharded["jD1"])
    _eq(sharded["D2"], sharded["jD2"])


def test_sharded_pipeline_matches_single_device(sharded):
    for i, ref in enumerate(sharded["ref"]):
        _eq(sharded["crop"][i], ref)


def test_sharded_pipeline_height_95_pads():
    """KITTI's 375 rows and 95 do not divide a 2-way tile axis: one
    padding row in and out (JAX's parallel/shard.py)."""
    p = _port(j_app_params())
    pipe = ShardedStereoPipeline(p, 160, 95, _cpu_mesh(8, tile=2))
    assert (pipe.pad_in, pipe.pad_out) == (1, 1)
    pipe = ShardedStereoPipeline(_port(j_app_params(subsampling=True)),
                                 1242, 375, _cpu_mesh(4, tile=2))
    assert (pipe.pad_in, pipe.pad_out, pipe.Ho) == (1, 1, 187)


# ---- the banded speckle filter ----------------------------------------------


def _crossing_map(seed):
    """A 160x95 map of random valid/invalid pixels whose large components
    cross every stripe edge: full-height constant columns and a
    serpentine of constant disparity."""
    rng = np.random.default_rng(seed)
    D = np.where(rng.random((H, W)) < 0.7,
                 rng.integers(0, 64, (H, W)), -10).astype(np.float32)
    D[:, 10] = 30.0
    D[:, 100:103] = 12.0
    D[::6, 40:80] = 20.0          # rungs
    D[:, 40] = 20.0
    D[3::12, 79] = 20.0
    D[:, 140] = np.arange(H) % 2 * 0.5 + 40.0      # |dD| <= 1 all the way
    return D


@pytest.mark.parametrize("tiles", [2, 6])
@pytest.mark.parametrize("subsampling", [False, True])
def test_banded_speckle_matches_jax(tiles, subsampling):
    jp = j_app_params(subsampling=subsampling)
    p = _port(jp)
    for seed in (3, 4):
        D = _crossing_map(seed)
        ref = jax.jit(lambda x: j_post.remove_small_segments(x, jp, 0))(D)
        rows = -(-H // tiles)
        _eq(post.remove_small_segments_banded(torch.as_tensor(D), p, rows),
            ref)
        with ctx.kernel_mesh(_cpu_mesh(tiles, tile=tiles)):
            _eq(ccl_cu.remove_small_segments(torch.as_tensor(D), p), ref)
        # a batch over ('stream', 'tile')
        with ctx.kernel_mesh(_cpu_mesh(2 * tiles, tile=tiles)):
            out = ccl_cu.remove_small_segments(
                torch.as_tensor(np.stack([D, D[::-1].copy()])), p)
        _eq(out[0], ref)
        _eq(out[1], post.remove_small_segments(
            torch.as_tensor(D[::-1].copy()), p))


# ---- each stripe launch's split against the unsplit plain version -----------


@pytest.fixture(scope="module", params=["full", "subsampled"])
def kernel_inputs(request):
    """The kernels' inputs of two frames at 160x95 (the port on the CPU)."""
    p = _port(j_app_params(subsampling=request.param == "subsampled"))
    eng = ElasEngine(p, W, H, device="cpu")
    L, R = _frames(2, W, H, seed=21)
    desc1, desc2, d_can = eng.stage_support_batched(np.stack([L, R], 1))
    geo = eng.upload_geometry([eng.host_mid(x) for x in d_can.numpy()])
    (tid_l, pl_l, gm_l), (tid_r, pl_r, gm_r) = eng.dense_inputs(*geo)
    maps_l = matching.plane_maps(tid_l, pl_l, p)
    maps_r = matching.plane_maps(tid_r, pl_r, p)
    D1 = matching.compute_disparity(desc1, desc2, tid_l, pl_l, gm_l, p, False)
    D2 = matching.compute_disparity(desc2, desc1, tid_r, pl_r, gm_r, p, True)
    return dict(p=p, desc1=desc1, desc2=desc2, maps_l=maps_l, maps_r=maps_r,
                gm_l=gm_l, gm_r=gm_r, D1=D1, D2=D2)


MESHES = {"tile2": (2, 2), "tile3": (3, 3), "stream2_tile2": (4, 2)}
# (mesh, batched): one frame does not split over 'stream'
SPLITS = [("tile2", False), ("tile3", False), ("tile2", True),
          ("tile3", True), ("stream2_tile2", True)]


def _splits(mesh_name):
    n, tiles = MESHES[mesh_name]
    return ctx.kernel_mesh(_cpu_mesh(n, tile=tiles))


@pytest.mark.parametrize("mesh_name,batched", SPLITS)
def test_support_stripes(kernel_inputs, mesh_name, batched):
    k = kernel_inputs
    d1, d2 = (k["desc1"], k["desc2"]) if batched else (k["desc1"][0],
                                                      k["desc2"][0])
    ref = support.support_scan(d1, d2, k["p"])
    with _splits(mesh_name):
        _eq(support_cu.support_scan(d1, d2, k["p"]), ref)
    # the padded frame: rows past the true height are never read
    pad = torch.nn.functional.pad(d1, (0, 0, 0, 3), value=255)
    with _splits(mesh_name):
        _eq(support_cu.support_scan(pad, torch.nn.functional.pad(
            d2, (0, 0, 0, 3), value=255), k["p"], height=H), ref)


@pytest.mark.parametrize("mesh_name,batched", SPLITS)
def test_matching_stripes(kernel_inputs, mesh_name, batched):
    k = kernel_inputs
    for a, b, maps, gm, right in (
            (k["desc1"], k["desc2"], k["maps_l"], k["gm_l"], False),
            (k["desc2"], k["desc1"], k["maps_r"], k["gm_r"], True)):
        args = (a, b, *maps, gm)
        if not batched:
            args = tuple(x[0] for x in args)
        ref = matching.match_keys(*args, k["p"], right)
        with _splits(mesh_name):
            _eq(matching_cu.match_keys(*args, k["p"], right), ref)


@pytest.mark.parametrize("mesh_name,batched", SPLITS)
def test_lr_and_speckle_stripes(kernel_inputs, mesh_name, batched):
    k = kernel_inputs
    D1, D2 = (k["D1"], k["D2"]) if batched else (k["D1"][0], k["D2"][0])
    ref = post.lr_consistency_check(D1, D2, k["p"])
    with _splits(mesh_name):
        out = lr_cu.lr_consistency_check(D1, D2, k["p"])
    _eq(out[0], ref[0])
    _eq(out[1], ref[1])
    with _splits(mesh_name):
        _eq(ccl_cu.remove_small_segments(ref[0], k["p"]),
            post.remove_small_segments(ref[0], k["p"]))


def test_stripe_wrappers_run_once_per_shard(kernel_inputs, monkeypatch):
    """Under a (2, 3) mesh each wrapper runs its per-shard function once
    per shard: 6 calls of the plain scan for a batch of 2 frames split
    over 'stream' and 'tile' (the kernels count one launch each on the
    card)."""
    k = kernel_inputs
    calls = {}

    inside = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            if inside:          # a plain version's own per-frame calls
                return fn(*a, **kw)
            calls[name] = calls.get(name, 0) + 1
            inside.append(name)
            try:
                return fn(*a, **kw)
            finally:
                inside.pop()
        return wrapped

    monkeypatch.setattr(support, "support_scan",
                        spy("support", support.support_scan))
    monkeypatch.setattr(matching, "match_keys",
                        spy("matching", matching.match_keys))
    monkeypatch.setattr(post, "lr_consistency_check",
                        spy("lr", post.lr_consistency_check))
    monkeypatch.setattr(post, "stripe_labels",
                        spy("ccl", post.stripe_labels))
    with ctx.kernel_mesh(_cpu_mesh(6, tile=3)):
        support_cu.support_scan(k["desc1"], k["desc2"], k["p"])
        matching_cu.match_keys(k["desc1"], k["desc2"], *k["maps_l"],
                               k["gm_l"], k["p"], False)
        lr_cu.lr_consistency_check(k["D1"], k["D2"], k["p"])
        ccl_cu.remove_small_segments(k["D1"], k["p"])
    assert calls == {"support": 6, "matching": 6, "lr": 6, "ccl": 6}
