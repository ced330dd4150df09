"""The ELAS stereo pipeline in PyTorch (counterpart of
stereovision_tpu/models/elas.py:40-395).

Structure:
  stage A      descriptors + support scan (K2)          device
  host middle  sequential support filters, Delaunay,    host (NumPy/SciPy,
               rasterization, span coding               C++ helpers;
                                                        hostlib/geometry.py;
                                                        on the card the
                                                        right image's half
                                                        in a side worker,
                                                        hostlib/side.py)
  stage B      plane fit, span expansion, grid masks,   device
               matching x2 (K1), L/R check (K4),
               speckle (K3), gap interpolation,
               adaptive mean, median

The engine runs on the card unless it is given device="cpu"; each kernel
wrapper picks the kernel or its plain version from the device its tensors
live on.  Under subsampling (params.subsampling) stage A is unchanged (full
resolution, candidate step forced even) and stage B runs on the
(H//2, W//2) output lattice.

Both device stages take one frame or a batch (a leading batch dimension),
and give each frame its single-frame result: stage_support_batched takes
(B, 2, H, W) image pairs, stage_dense_batched the (B, nbytes) packed
geometry (pack_geometry: one upload a batch).  The host middle runs frame
by frame, in a spawn process pool for the streaming paths (host_pool).

process_jit is the one-dispatch mode (elas.py:404-421): stage A and stage
B each one replay of a CUDA graph (graphs.StageGraph, K1-K4 inside), the
host middle between them.  stage_graphs makes the pair, replay_frame runs
a frame through it; both serve process_jit and StereoEngine.process_frame,
each in turns of a graphs.ReplayTurn.

Spans (profiling.py, while tracing is on): process_jit records each frame
as the root "svtt.frame"; replay_frame records "svtt.stage_a" (graph A's
replay), "svtt.fetch_support", "svtt.host_mid", "svtt.upload_geometry"
(the packing) and "svtt.stage_b" (graph B's replay with its input copy),
none inside a captured function; frame_ids and batch_ids number the frames
and batches of this engine and of its StereoEngine.

row_pad=(in_pad, out_pad) is the row-sharded pipeline's mode
(parallel/shard.py; elas.py:118-132, :210-222, :300-381): stage A takes
images padded to H + in_pad rows, stage B gives maps of Ho + out_pad rows
whose padding rows are -10 and whose real rows equal the unpadded
engine's (each op takes the true shape for its row clamps and regions).
Under a kernel mesh (parallel/ctx.py) the kernels run per shard.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling as P
from ..device import resolve_device
from ..graphs import ReplayTurn, StageGraph
from ..hostlib import geometry, side
from ..hostlib.geometry import _pool_host_mid, _pool_init
from ..ops import postprocess as post
from ..ops.cuda import ccl_cu, lr_cu, matching_cu, support_cu
from ..ops.descriptor import compute_descriptor
from ..ops.grid import build_grid_mask
from ..ops.planes import fit_plane_tables
from ..ops.spans import expand_tri_spans
from ..params import ElasParams
from ..transfer import fetch, upload


class ElasEngine:
    """ELAS pipeline for one image size on one device."""

    def __init__(self, params: ElasParams, width: int, height: int,
                 host_filters: bool = True, device: Optional[str] = None,
                 row_pad: Tuple[int, int] = (0, 0)):
        # host_filters=True: the support filters run on the host with the
        # reference's sequential in-place semantics (hostlib.raster);
        # False: their snapshot versions run on the device after K2
        # (ops.support.support_matches(apply_filters=True))
        self.host_filters = host_filters
        self.row_pad_in, self.row_pad_out = (int(x) for x in row_pad)
        self.p = params
        self.device = resolve_device(device)
        self.width = int(width)
        self.height = int(height)
        step = params.step
        self.Hc = -(-self.height // step)
        self.Wc = -(-self.width // step)
        # static padding caps of the host geometry (as in the JAX engine)
        self.n_max = min(self.Hc * self.Wc + 6, 8192)
        self.t_max = 2 * self.n_max + 8
        self.Ho, self.Wo = params.out_shape(self.width, self.height)
        # runs per span-coded row are set by triangle-edge crossings, which
        # the half lattice keeps: the cap follows the full width
        self.s_max = max(64, min(self.width // 4, self.Wo))
        self._host_pool = None
        self._pool_lock = threading.Lock()
        self.frame_ids, self.batch_ids = P.Ids(), P.Ids()
        # process_jit's turns and its graphs
        self._jit_turn = ReplayTurn(self.device)
        # the host middle's side worker on the card: started here, not
        # waited for (None: not started; False: none can be)
        self._side = None
        self.side_worker()

    # ---- lifecycle ----------------------------------------------------------

    def close(self):
        """Shut down the host geometry process pool and the side worker
        (reference clean(), stereo_vision.cpp:105-114) and release
        process_jit's graphs.  Idempotent; all are made again on demand."""
        self.__dict__.pop("process_jit", None)
        self._jit_turn.close()
        with self._pool_lock:
            pool, self._host_pool = self._host_pool, None
            side_worker, self._side = self._side, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if side_worker:
            side_worker.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def host_args(self) -> tuple:
        """host_mid_standalone's arguments after d_can."""
        return (self.p, self.width, self.height, self.n_max, self.t_max,
                self.s_max, self.host_filters)

    def host_pool(self, workers: int = 4):
        """Process pool running the host middle free of the GIL (scipy's
        Delaunay holds it, so threads barely scale).  Spawn, never fork:
        the parent holds a CUDA context, which a forked child must not
        inherit.  The workers import hostlib.geometry and no torch."""
        with self._pool_lock:
            if self._host_pool is None:
                import concurrent.futures as cf
                import multiprocessing as mp
                self._host_pool = cf.ProcessPoolExecutor(
                    max_workers=workers, mp_context=mp.get_context("spawn"),
                    initializer=_pool_init,
                    initargs=self.host_args)
            return self._host_pool

    def host_mid_parallel(self, d_cans: Sequence[np.ndarray],
                          workers: int = 4):
        """host_mid_standalone over a batch of support grids in the pool's
        worker processes, in order.  While tracing, the workers record
        their host-middle spans, which join this process's ring in frames
        current + 0, 1, ... (the thread's current frame: the batch's
        first)."""
        pool = self.host_pool(workers)
        d_cans = list(d_cans)
        trace = P.recording()
        out = list(pool.map(_pool_host_mid, d_cans, [trace] * len(d_cans)))
        if trace:
            first = P.current_frame()
            for i, g in enumerate(out):
                P.ingest(g.pop("spans", ()),
                         None if first is None else first + i)
        return out

    # ---- device stage A ---------------------------------------------------

    def stage_support(self, I1, I2):
        """(H, W) uint8 gray images (NumPy or tensors) -> (desc1, desc2,
        d_can) on the engine's device; d_can is the (Hc, Wc) int16
        support grid, raw under host_filters (the host applies the
        sequential filters), else filtered on the device."""
        th = self.true_height
        desc1 = compute_descriptor(upload(I1, self.device), th)
        desc2 = compute_descriptor(upload(I2, self.device), th)
        d_can = support_cu.support_matches(
            desc1, desc2, self.p, apply_filters=not self.host_filters,
            true_height=th)
        return desc1, desc2, d_can

    def stage_support_batched(self, pairs, device=None):
        """(B, 2, H, W) uint8 gray image pairs (NumPy or a tensor) ->
        (desc1, desc2, d_can) with a leading batch dimension: one launch
        of K2 for the batch (one a shard under a kernel mesh), on `device`
        (default: the engine's)."""
        th = self.true_height
        desc = compute_descriptor(upload(pairs, device or self.device), th)
        desc1 = desc[:, 0].contiguous()
        desc2 = desc[:, 1].contiguous()
        d_can = support_cu.support_matches(
            desc1, desc2, self.p, apply_filters=not self.host_filters,
            true_height=th)
        return desc1, desc2, d_can

    @property
    def true_height(self) -> int:
        """The ops' true_height: the frame's rows under row padding, else
        0 (the images' own)."""
        return self.height if self.row_pad_in else 0

    # ---- host middle ------------------------------------------------------

    def side_worker(self) -> Optional[side.SideWorker]:
        """On the card, the host middle's side worker (hostlib/side.py),
        started where the engine has none (at construction, after
        close()); None on the CPU, whose engines stay sequential, and
        where the process may use fewer than two CPUs.  A worker that
        died stays the engine's, unused, until close()."""
        if self._side is None and self.device.type == "cuda":
            with self._pool_lock:
                if self._side is None:
                    self._side = side.start(self.host_args) or False
        return self._side or None

    def host_mid(self, d_can: np.ndarray) -> Dict[str, np.ndarray]:
        """Support grid -> padded geometry arrays (fixed shapes): pts
        (n_max, 3) int16, tris_l/r (t_max, 3) int16 and the triangle-id
        maps on the output lattice as span codes tri_l/r (Ho, s_max, 3)
        uint8 (hostlib.geometry.host_mid), the right image's half in the
        side worker where it takes it."""
        return geometry.host_mid(d_can, *self.host_args,
                                 side=self.side_worker())

    # ---- packed geometry transport -----------------------------------------
    #
    # The five geometry arrays of a frame travel as ONE uint8 buffer, laid
    # out byte for byte as the JAX package's (models/elas.py:262-296): one
    # host-to-device copy a frame, or a batch, instead of five.

    @functools.cached_property
    def _geo_layout(self):
        segs = [("pts", (self.n_max, 3), np.int16),
                ("tris_l", (self.t_max, 3), np.int16),
                ("tris_r", (self.t_max, 3), np.int16),
                ("tri_l", (self.Ho, self.s_max, 3), np.uint8),
                ("tri_r", (self.Ho, self.s_max, 3), np.uint8)]
        layout, off = [], 0
        for name, shape, dt in segs:
            nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
            layout.append((name, shape, dt, off, nbytes))
            off += nbytes
        return layout, off

    def pack_geometry(self, g: Dict[str, np.ndarray]) -> np.ndarray:
        """host_mid dict -> one (nbytes,) uint8 buffer."""
        layout, total = self._geo_layout
        buf = np.empty(total, np.uint8)
        for name, shape, dt, off, nbytes in layout:
            buf[off:off + nbytes] = np.ascontiguousarray(
                g[name], dtype=dt).view(np.uint8).ravel()
        return buf

    def unpack_geometry(self, buf: torch.Tensor):
        """(..., nbytes) uint8 tensor -> (pts, tris_l, tris_r, tri_l, tri_r)
        views of it (slices and Tensor.view(dtype)), with buf's leading
        dimensions."""
        layout, total = self._geo_layout
        if buf.dtype != torch.uint8 or buf.shape[-1] != total:
            raise ValueError("expected a (..., %d) uint8 buffer, got %s %s"
                             % (total, tuple(buf.shape), buf.dtype))
        lead = buf.shape[:-1]
        out = []
        for name, shape, dt, off, nbytes in layout:
            seg = buf[..., off:off + nbytes]
            if np.dtype(dt).itemsize > 1:
                seg = seg.view(getattr(torch, np.dtype(dt).name))
            out.append(seg.reshape(*lead, *shape))
        return tuple(out)

    def upload_geometry(self, g):
        """host_mid products -> (pts, tris_l, tris_r, tri_l, tri_r) on the
        engine's device, packed into one upload: a dict gives one frame's
        arrays, a sequence of dicts a batch's."""
        buf = (self.pack_geometry(g) if isinstance(g, dict)
               else np.stack([self.pack_geometry(x) for x in g]))
        return self.unpack_geometry(upload(buf, self.device))

    # ---- device stage B ---------------------------------------------------

    def dense_inputs(self, pts, tris_l, tris_r, tri_l, tri_r):
        """Geometry -> the matching passes' inputs: (tid, planes, grid
        mask) for the left and for the right image."""
        planes_l, _ = fit_plane_tables(pts, tris_l)
        _, planes_r = fit_plane_tables(pts, tris_r)
        tid_l = expand_tri_spans(tri_l, self.Wo)
        tid_r = expand_tri_spans(tri_r, self.Wo)
        grid_l = build_grid_mask(pts, self.p, self.width, self.height,
                                 right_image=False)
        grid_r = build_grid_mask(pts, self.p, self.width, self.height,
                                 right_image=True)
        return (tid_l, planes_l, grid_l), (tid_r, planes_r, grid_r)

    def stage_dense(self, desc1, desc2, pts, tris_l, tris_r, tri_l,
                    tri_r) -> Tuple[torch.Tensor, torch.Tensor]:
        """Descriptors + geometry tensors -> (D1, D2) float32 (Ho, Wo)
        maps of full-resolution disparities (-10 / -1 = invalid); with a
        leading batch dimension on every input, (B, Ho, Wo) maps, each
        kernel launched once for the batch."""
        p = self.p
        (tid_l, *left), (tid_r, *right) = self.dense_inputs(
            pts, tris_l, tris_r, tri_l, tri_r)
        out_pad, th = self.row_pad_out, self.true_height
        if out_pad:
            # the padded lattice: -1 (no triangle) rows, which matching
            # makes -10 and every later stage keeps
            tid_l, tid_r = (torch.nn.functional.pad(t, (0, 0, 0, out_pad),
                                                    value=-1)
                            for t in (tid_l, tid_r))
        pad = dict(true_height=th, pad_out_rows=out_pad)
        D1 = matching_cu.compute_disparity(desc1, desc2, tid_l, *left, p,
                                           right_image=False, **pad)
        D2 = matching_cu.compute_disparity(desc2, desc1, tid_r, *right, p,
                                           right_image=True, **pad)
        D1, D2 = lr_cu.lr_consistency_check(D1, D2, p)
        D1 = ccl_cu.remove_small_segments(D1, p)
        if not p.postprocess_only_left:
            D2 = ccl_cu.remove_small_segments(D2, p)
        D1 = post.gap_interpolation(D1, p)
        if not p.postprocess_only_left:
            D2 = post.gap_interpolation(D2, p)
        tsh = (self.Ho, self.Wo) if out_pad else None
        if p.filter_adaptive_mean:
            D1 = post.adaptive_mean(D1, p, tsh)
            if not p.postprocess_only_left:
                D2 = post.adaptive_mean(D2, p, tsh)
        if p.filter_median:
            D1 = post.median_filter(D1, p, tsh)
            if not p.postprocess_only_left:
                D2 = post.median_filter(D2, p, tsh)
        if out_pad:
            # gap interpolation's border extrapolation may reach the
            # padding rows: make them -10 again
            D1[..., self.Ho:, :] = -10.0
            D2[..., self.Ho:, :] = -10.0
        return D1, D2

    def stage_dense_batched(self, desc1, desc2, buf):
        """(B, 16, H, W) descriptors + the (B, nbytes) packed geometry on
        the device -> (D1, D2) (B, Ho, Wo); without the batch dimension,
        one frame's."""
        return self.stage_dense(desc1, desc2, *self.unpack_geometry(buf))

    # ---- public entry point -----------------------------------------------

    def process(self, I1, I2) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocking single-frame processing.  I1, I2: (H, W) uint8
        grayscale.  Returns (D1, D2) float32 (Ho, Wo) tensors on the
        engine's device."""
        desc1, desc2, d_can = self.stage_support(I1, I2)
        g = self.host_mid(d_can.cpu().numpy())
        return self.stage_dense(desc1, desc2, *self.upload_geometry(g))

    # ---- the one-dispatch mode ------------------------------------------

    def stage_graphs(self, name="process_jit"):
        """Stages A and B of one frame as two graphs.StageGraph sharing one
        memory pool: A(I1, I2) -> (desc1, desc2, d_can) is stage_support,
        B(desc1, desc2, buf) stage_dense on the packed geometry.  On the
        card both are warmed up and captured on a blank frame and the
        geometry the host middle gives it; B reads A's outputs in place.
        On the CPU both run eagerly."""
        dev = self.device
        blank = tuple(torch.zeros((self.height + self.row_pad_in,
                                   self.width), dtype=torch.uint8, device=dev)
                      for _ in range(2))
        a = StageGraph(name + ": stage A", self.stage_support, blank,
                       device=dev)
        if a.graph is None:
            return a, StageGraph(name + ": stage B",
                                 self.stage_dense_batched, device=dev)
        desc1, desc2, d_can = a(*blank)
        buf = self.pack_geometry(self.host_mid(fetch(d_can)))
        return a, StageGraph(name + ": stage B", self.stage_dense_batched,
                             (desc1, desc2, upload(buf, dev)), pool=a.pool)

    def replay_frame(self, graphs, I1, I2):
        """One frame through graphs (A, B, ...) of stage_graphs: graph A,
        one fetch of d_can, the host middle, the packed geometry, graph B
        (the geometry copied into its static buffer).  -> B's static
        outputs (D1, D2), which B's next replay overwrites."""
        stage_a, stage_b = graphs[:2]
        with P.span("svtt.stage_a"):
            desc1, desc2, d_can = stage_a(I1, I2)
        with P.span("svtt.fetch_support"):
            d_can = fetch(d_can)
        g = self.host_mid(d_can)
        with P.span("svtt.upload_geometry"):
            buf = self.pack_geometry(g)
        with P.span("svtt.stage_b"):
            return stage_b(desc1, desc2, buf)

    @functools.cached_property
    def process_jit(self):
        """(I1, I2) -> (D1, D2), as process, with each device stage one
        replay of a CUDA graph (the JAX package's process_jit,
        elas.py:404-421, whose host middle runs in a pure_callback):
        replay_frame in the engine's turns (graphs.ReplayTurn), whose graphs
        (the callable's `graphs`: [A, B] once made) are made at the first
        call; D1 and D2 are clones on the engine's device."""
        turn = self._jit_turn

        def run(I1, I2):
            with turn(self.stage_graphs) as graphs, \
                    P.frame(self.frame_ids, "process_jit"):
                D1, D2 = self.replay_frame(graphs, I1, I2)
                return D1.clone(), D2.clone()

        run.graphs = turn.graphs
        return run
