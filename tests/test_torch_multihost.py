"""The port's multi-process launcher and, on the card, its stripe launches.

The launcher (python -m stereovision_tpu_torch.parallel.launch) runs two
worker processes over gloo on the CPU with a `jax` package on their path
whose import raises: each validates its frames against a single-device
engine and reports its result.  The tests marked `cuda` hold each kernel's
stripe launch (K1, K2, K4) and K3's banded mode against its plain version
and against the unsplit launch on meshes that repeat the card
([cuda:0] * 2, [cuda:0] * 4), with one launch per shard; they skip without
a card.  The file imports nothing of JAX, so on the card's machine it runs
without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_multihost.py
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from stereovision_tpu_torch.engine import bgr_to_gray
from stereovision_tpu_torch.models.elas import ElasEngine
from stereovision_tpu_torch.ops import matching, support
from stereovision_tpu_torch.ops import postprocess as post
from stereovision_tpu_torch.ops.cuda import (ccl_cu, lr_cu, matching_cu,
                                             support_cu)
from stereovision_tpu_torch.params import app_params
from stereovision_tpu_torch.parallel import ctx
from stereovision_tpu_torch.parallel.mesh import make_mesh
from stereovision_tpu_torch.parallel.shard import ShardedStereoPipeline
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_without_jax(tmp_path):
    """The environment with a `jax` on PYTHONPATH whose import raises."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        "raise ImportError('the port must not import jax')\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path / "stub"), ROOT])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_process_launcher(tmp_path):
    """Two processes of two CPU devices each: the (2, 2) mesh, a global
    batch of 4, height 95 (padded row sharding), every frame stripe equal
    to the single-device engine's, no jax loaded."""
    out = tmp_path / "mh.json"
    r = subprocess.run(
        [sys.executable, "-m", "stereovision_tpu_torch.parallel.launch",
         "--nproc", "2", "--local-devices", "2", "--steps", "2",
         "--frames-per-host", "2", "--height", "95", "--device", "cpu",
         "--port", str(_free_port()), "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=_env_without_jax(tmp_path))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(out.read_text())
    assert len(res) == 2
    assert {x["process"] for x in res} == {0, 1}
    for x in res:
        assert x["shard_errors"] == 0
        assert x["mesh"] == {"stream": 2, "tile": 2}
        assert x["global_batch"] == 4
        assert x["backend"] == "gloo"


def test_tile_axis_across_processes_is_refused(tmp_path):
    """Two processes of one device each asked for a (1, 2) mesh: the
    'tile' axis would cross processes, which raises NotImplementedError
    in both."""
    code = textwrap.dedent("""
        import sys, torch
        import torch.distributed as dist
        from stereovision_tpu_torch.parallel.mesh import multihost_mesh
        dist.init_process_group("gloo", init_method=sys.argv[1],
                                world_size=2, rank=int(sys.argv[2]))
        try:
            multihost_mesh(stream=1, tile=2,
                           local_devices=[torch.device("cpu")])
        except NotImplementedError as e:
            print("refused:", e)
        dist.destroy_process_group()
    """)
    store = "file://%s" % (tmp_path / "store")
    env = _env_without_jax(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", code, store, str(i)],
                              cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
        assert "refused: a 'tile' axis of 2 across processes" in o, o


# ---- on the card ------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    # module scope: a skip here comes before `inputs` is computed
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=["full", "subsampled"])
def inputs(request, cuda):
    """The kernels' inputs of two frames at 333x101 (an odd width and
    height; the port on the CPU)."""
    w, h = 333, 101
    p = app_params(subsampling=request.param == "subsampled").replace(
        disp_max=63)
    eng = ElasEngine(p, w, h, device="cpu")
    grays = []
    for s in (1, 2):
        left, right, _ = stereo_pair(w, h, seed=s)
        grays.append((bgr_to_gray(left), bgr_to_gray(right)))
    desc1, desc2, d_can = eng.stage_support_batched(np.stack(grays))
    geo = eng.upload_geometry([eng.host_mid(x) for x in d_can.numpy()])
    (tid_l, pl_l, gm_l), (tid_r, pl_r, gm_r) = eng.dense_inputs(*geo)
    maps_l = matching.plane_maps(tid_l, pl_l, p)
    maps_r = matching.plane_maps(tid_r, pl_r, p)
    D1 = matching.compute_disparity(desc1, desc2, tid_l, pl_l, gm_l, p, False)
    D2 = matching.compute_disparity(desc2, desc1, tid_r, pl_r, gm_r, p, True)
    L1, L2 = post.lr_consistency_check(D1, D2, p)
    return dict(p=p, desc1=desc1, desc2=desc2, maps_l=maps_l, maps_r=maps_r,
                gm_l=gm_l, gm_r=gm_r, D1=D1, D2=D2, L1=L1)


# (devices, tile, batched): [cuda:0] * 2 and * 4 over 'tile', and a batch
# over ('stream', 'tile')
LAYOUTS = [(2, 2, False), (4, 4, False), (2, 2, True), (4, 4, True),
           (4, 2, True)]


def _mesh(cuda, n, tile):
    return ctx.kernel_mesh(make_mesh(devices=[cuda] * n, tile=tile))


def _equal(kernel_out, ref):
    assert kernel_out.dtype == ref.dtype
    assert torch.equal(kernel_out.cpu(), ref.cpu()), \
        "%d elements differ" % int((kernel_out.cpu() != ref.cpu()).sum())


def _frames(x, batched):
    return x if batched else x[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile,batched", LAYOUTS)
def test_support_stripes_on_card(cuda, inputs, n, tile, batched):
    p = inputs["p"]
    d1, d2 = (_frames(inputs[k], batched).to(cuda) for k in ("desc1",
                                                             "desc2"))
    whole = support_cu.support_scan(d1, d2, p)
    before = support_cu.launches
    with _mesh(cuda, n, tile):
        out = support_cu.support_scan(d1, d2, p)
    assert support_cu.launches - before == n
    _equal(out, whole)
    _equal(out, support.support_scan(d1.cpu(), d2.cpu(), p))


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile,batched", LAYOUTS)
def test_matching_stripes_on_card(cuda, inputs, n, tile, batched):
    p = inputs["p"]
    for a, b, maps, gm, right in (
            ("desc1", "desc2", "maps_l", "gm_l", False),
            ("desc2", "desc1", "maps_r", "gm_r", True)):
        args = [_frames(x, batched).to(cuda) for x in
                (inputs[a], inputs[b], *inputs[maps], inputs[gm])]
        whole = matching_cu.match_keys(*args, p, right)
        before = matching_cu.launches
        with _mesh(cuda, n, tile):
            out = matching_cu.match_keys(*args, p, right)
        assert matching_cu.launches - before == n
        _equal(out, whole)
        _equal(out, matching.match_keys(*(x.cpu() for x in args), p, right))


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile,batched", LAYOUTS)
def test_lr_stripes_on_card(cuda, inputs, n, tile, batched):
    p = inputs["p"]
    D1, D2 = (_frames(inputs[k], batched).to(cuda) for k in ("D1", "D2"))
    whole = lr_cu.lr_consistency_check(D1, D2, p)
    before = lr_cu.launches
    with _mesh(cuda, n, tile):
        out = lr_cu.lr_consistency_check(D1, D2, p)
    assert lr_cu.launches - before == n
    plain = post.lr_consistency_check(D1.cpu(), D2.cpu(), p)
    for o, w, q in zip(out, whole, plain):
        _equal(o, w)
        _equal(o, q)


def _speckle_maps(inputs, batched):
    """L1 of the inputs, and a map whose components cross every stripe
    edge (constant columns and a full-height ramp of step 0.5)."""
    L1 = _frames(inputs["L1"], batched)
    cross = torch.where(torch.rand(L1.shape, generator=torch.Generator()
                                   .manual_seed(3)) < 0.7, 20.0, -10.0)
    cross[..., :, 7] = 30.0
    cross[..., :, 50:53] = 12.0
    rows = torch.arange(L1.shape[-2], dtype=torch.float32)
    cross[..., :, 90] = 40.0 + rows % 2 * 0.5
    return L1, cross


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile,batched", LAYOUTS)
def test_banded_speckle_on_card(cuda, inputs, n, tile, batched):
    """K3 banded: one stripe launch a shard and one merge; the filtered
    map equals the whole-frame kernel's and the plain version's, run
    twice (a race in the merge's unions would show)."""
    p = inputs["p"]
    for D in _speckle_maps(inputs, batched):
        Dc = D.to(cuda).contiguous()
        whole = ccl_cu.remove_small_segments(Dc, p)
        before = (ccl_cu.launches, ccl_cu.merges)
        with _mesh(cuda, n, tile):
            out = ccl_cu.remove_small_segments(Dc, p)
            again = ccl_cu.remove_small_segments(Dc, p)
        assert (ccl_cu.launches - before[0], ccl_cu.merges - before[1]) == (
            2 * n, 2)
        _equal(out, whole)
        _equal(again, whole)
        _equal(out, post.remove_small_segments(D, p))


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", [False, True])
def test_sharded_pipeline_on_card(cuda, subsampling):
    """ShardedStereoPipeline on [cuda:0] * 4 (stream 2, tile 2) at 333x101
    (one padding row in): every cropped frame equals the single-device
    engine's on the card, padding rows -10."""
    w, h = 333, 101
    p = app_params(subsampling=subsampling).replace(disp_max=63)
    grays = [tuple(bgr_to_gray(x) for x in stereo_pair(w, h, seed=s)[:2])
             for s in range(4)]
    L = np.stack([g[0] for g in grays])
    R = np.stack([g[1] for g in grays])
    single = ElasEngine(p, w, h, device=cuda)
    with ShardedStereoPipeline(p, w, h, make_mesh(devices=[cuda] * 4,
                                                  stream=2)) as pipe:
        D1, _ = pipe.run(L, R)
        assert pipe.pad_in == 1
        assert (D1[:, pipe.Ho:] == -10).all()
        for i in range(4):
            _equal(D1[i, :pipe.Ho], single.process(L[i], R[i])[0])
