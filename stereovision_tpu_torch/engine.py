"""StereoEngine: calibrated frames -> disparity + point cloud, with the
reference application's output conventions, and two streaming modes
(counterpart of stereovision_tpu/engine.py:36-488).

  generateDisparityMap  stereo_vision.cpp:296-318 (disparity stored as
                        uint8 = 4x true disparity)
  publishPointCloud     stereo_vision.cpp:222-280 (Q reprojection of the
                        *uint8* disparity)

process_frame is one blocking frame.  On the card it replays its device
work from three CUDA graphs (graphs.StageGraph), captured at its first call
and kept until close(): stage A and stage B (ElasEngine.stage_graphs, run
by ElasEngine.replay_frame as process_jit runs them) and the reprojection
of B's D1, read in place; on the CPU the same three run eagerly.  Its
callers take turns (graphs.ReplayTurn, as process_jit's do).  stream
overlaps frames with a lookahead of stage A, its stages eager;
stream_batched runs batches of frames through the eager batched stages,
each kernel launched once a batch, with a prefetch thread,
`pipeline_depth` tail workers and a spawn process pool for the host
middle.  On the card every thread of the pipeline launches on a CUDA
stream of its own; a tensor made on one thread's stream and read on
another's is ordered by an event and kept from reuse by record_stream.

Spans (profiling.py, while tracing is on).  process_frame and stream
record each frame as the root "svtt.frame" (its id from the ElasEngine's
frame_ids, its count "entry" the entry point; under process_frame also
"graphs", the frame's graph replays: 3 on the card, 0 on the CPU) with the
children "svtt.gray", "svtt.stage_a", "svtt.fetch_support" (the support
grid to the host), "svtt.host_mid", "svtt.upload_geometry" (packing and
the enqueued copy; under process_frame the packing alone, the copy into
graph B's static buffer falling in "svtt.stage_b"), "svtt.stage_b",
"svtt.reproject" (under process_frame with the clones of what it returns
on the device), "svtt.fetch_dmap" and "svtt.fetch_cloud"; stream's stage A
of a frame dispatched ahead is a root "svtt.frame" of its own.
stream_batched records each batch as the root "svtt.batch" (counts batch
and first, its first frame's id) on the prefetch thread ("svtt.gray",
"svtt.upload_images", "svtt.stage_a") and on the tail worker
("svtt.queue_wait" from submission to start, "svtt.fetch_support",
"svtt.host_mid_pool", "svtt.upload_geometry", "svtt.stage_b",
"svtt.reproject", "svtt.fetch_dmap", "svtt.fetch_cloud"); the host
middle's own spans come back from the pool's workers, frame by frame.
"""

from __future__ import annotations

import collections
import os.path as osp
import threading
import time
import warnings
from concurrent.futures import wait as futures_wait
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from . import profiling as P
from .device import resolve_device
from .graphs import ReplayTurn, StageGraph
from .hostlib.geometry import host_mid_standalone
from .io.calibration import Rectification, rectification_from_yaml
from .models.elas import ElasEngine
from .ops.reproject import (apply_robot_transform, box_centroids,
                            linear_taps, reproject, resize_linear)
from .params import ElasParams, app_params
from .transfer import fetch as to_host
from .transfer import upload

DEFAULT_CALIB = osp.join(osp.dirname(osp.abspath(__file__)), "data",
                         "kitti_2011_09_26.yml")


def frame_line(out: Dict) -> str:
    """The reference's per-frame line (stereo_vision.cpp:682-686) for one
    output of process_frame, stream or stream_batched: "(FPS=...) (rows,
    cols) (t_t=..., dmap_t=..., pc_t=...)"."""
    t = out["timings"]
    return ("(FPS=%f) (%d, %d) (t_t=%f, dmap_t=%f, pc_t=%f)"
            % (1 / max(t["t_t"], 1e-9), out["dmap"].shape[0],
               out["dmap"].shape[1], t["t_t"], t["dmap_t"], t["pc_t"]))


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """BGR(A) -> grayscale uint8 with OpenCV's fixed-point BT.601 rounding
    (matches cvtColor(BGRA2GRAY), reference stereo_vision.cpp:338-339)."""
    if img.ndim == 2:
        return img
    b = img[..., 0].astype(np.uint32)
    g = img[..., 1].astype(np.uint32)
    r = img[..., 2].astype(np.uint32)
    y = (4899 * r + 9617 * g + 1868 * b + (1 << 13)) >> 14
    return y.astype(np.uint8)


class StereoEngine:
    """Stereo frames -> disparity map + 3-D point cloud, on the card unless
    device="cpu"."""

    def __init__(self,
                 calibration_yaml: str,
                 width: int,
                 height: int,
                 scale: float = 1.0,
                 pc_extrapolation: int = 1,
                 params: Optional[ElasParams] = None,
                 subsampling: bool = False,
                 true_scale_cloud: bool = False,
                 remove_sky: bool = False,
                 robot_frame: bool = False,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.p = params or app_params(subsampling=subsampling)
        self.remove_sky = remove_sky
        self.width = int(width)
        self.height = int(height)
        self.pc_w = self.width * pc_extrapolation
        self.pc_h = self.height * pc_extrapolation
        self.rect: Rectification = rectification_from_yaml(
            calibration_yaml, self.width, self.height, scale_factor=scale)
        # Q, XR and XT on the device, made here once for every thread (a
        # CUDA graph capture of the reprojection copies nothing from the
        # host)
        self._rect_t = tuple(
            torch.as_tensor(np.asarray(m, np.float32), device=self.device)
            for m in (self.rect.Q, self.rect.XR, self.rect.XT))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.elas = ElasEngine(self.p, self.width, self.height,
                               device=self.device)
        # The reference feeds the uint8 display disparity (4x true) into Q
        # (stereo_vision.cpp:316 + :234-242); true_scale_cloud=True divides
        # by 4 for metric clouds.  robot_frame=True applies the
        # calibration's XR/XT rigid transform (stereo_vision.cu:208-211).
        self.disp_display_scale = 4.0
        self.true_scale_cloud = true_scale_cloud
        self.robot_frame = robot_frame
        self.timings: Dict[str, float] = {}
        self._pc_taps: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        self._executors = None
        # process_frame's turns and its graphs
        self.frame_turn = ReplayTurn(self.device)
        # how the last stream_batched ran its host middle: "process" or,
        # where the pool's processes could not start, "thread"
        self.host_mode: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def _get_executors(self, batch: int, pipeline_depth: int):
        """Engine-owned thread pools of stream_batched, made on first use and
        reused across calls: host-middle threads, `pipeline_depth` tail
        workers and one prefetch thread.  On the card each tail worker and
        the prefetch thread launch on a CUDA stream of their own."""
        import concurrent.futures as cf
        need = max(pipeline_depth, 1)
        if self._executors is not None and self._executors[3] < need:
            for e in self._executors[:3]:
                e.shutdown(wait=False, cancel_futures=True)
            self._executors = None
        if self._executors is None:
            own = dict(initializer=_own_stream, initargs=(self.device,))
            self._executors = (
                cf.ThreadPoolExecutor(max_workers=min(max(batch, 1), 8)),
                cf.ThreadPoolExecutor(max_workers=need, **own),
                cf.ThreadPoolExecutor(max_workers=1, **own),
                need)
        return self._executors[:3]

    def close(self):
        """Release the worker threads, the host geometry processes and the
        graphs.  Idempotent; the engine stays usable (pools and graphs are
        made again on demand)."""
        if self._executors is not None:
            for e in self._executors[:3]:
                e.shutdown(wait=True, cancel_futures=True)
            self._executors = None
        self.frame_turn.close()
        self.elas.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def pc_taps(self, shape) -> tuple:
        """The resize's tap tables (rows, cols) from a dmap of this shape
        to the cloud's (pc_h, pc_w), None for an axis that keeps its size;
        made once a shape, on the engine's device, for every thread."""
        with self._lock:
            if shape not in self._pc_taps:
                taps = tuple(linear_taps(n, m, self.device) if n != m
                             else None
                             for n, m in zip(shape, (self.pc_h, self.pc_w)))
                if self.device.type == "cuda":
                    # other threads' streams read the tables unordered
                    torch.cuda.current_stream().synchronize()
                self._pc_taps[shape] = taps
        return self._pc_taps[shape]

    def reproject(self, D1: torch.Tensor):
        """D1 (..., Ho, Wo) -> (dmap (..., Ho, Wo) uint8 display disparity,
        points (..., pc_h, pc_w, 3) float32), both on D1's device."""
        dmap = torch.clamp(torch.round(D1 * self.disp_display_scale),
                           0, 255).to(torch.uint8)
        if self.remove_sky:
            # zero disparity above ~55% height (reference remove_sky,
            # stereo_vision.cpp:484-490: mask rows [0, H/2*1.1))
            dmap[..., :int(dmap.shape[-2] // 2 * 1.1), :] = 0
        d_for_q = resize_linear(dmap.to(torch.float32),
                                *self.pc_taps(tuple(dmap.shape[-2:])))
        if self.true_scale_cloud:
            d_for_q = d_for_q / self.disp_display_scale
        Q, XR, XT = self._rect_t
        points = reproject(d_for_q, Q)
        if self.robot_frame:
            points = apply_robot_transform(points, XR, XT)
        return dmap, points

    def _run_dense(self, desc1, desc2, d_can):
        """The support grid to the host, the host middle, and stage B with
        the frame tail from its products: the packed geometry goes up in
        one copy.  -> (D1, dmap, points (pc_h, pc_w, 3))."""
        with P.span("svtt.fetch_support"):
            d_can = to_host(d_can)
        g = self.elas.host_mid(d_can)
        with P.span("svtt.upload_geometry"):
            geo = self.elas.upload_geometry(g)
        with P.span("svtt.stage_b"):
            D1, _ = self.elas.stage_dense(desc1, desc2, *geo)
        with P.span("svtt.reproject"):
            dmap, points = self.reproject(D1)
        return D1, dmap, points

    def _make_frame_graphs(self) -> tuple:
        """process_frame's stages as graphs.StageGraph: (A, B, R), A and B
        from ElasEngine.stage_graphs, R the reprojection of B's D1, read in
        place, in A's memory pool.  On the CPU all three call their
        functions."""
        name = "process_frame"
        a, b = self.elas.stage_graphs(name=name)
        if b.graph is None:
            return a, b, StageGraph(name + ": reproject", self.reproject,
                                    device=self.device)
        return a, b, StageGraph(name + ": reproject", self.reproject,
                                b.outputs[:1], pool=a.pool)

    def process_frame(self, left: np.ndarray, right: np.ndarray,
                      fetch: str = "host") -> Dict:
        """left/right: (H, W[, C]) uint8 BGR(A)/gray frames at engine size.
        Returns dict with dmap (uint8 display disparity), disparity (D1
        tensor), points ((pc_h*pc_w, 3) NumPy under fetch="host", else the
        (pc_h, pc_w, 3) tensor) and stage timings.

        fetch: "host" copies dmap and points to NumPy; "dmap" copies only
        the display disparity and leaves the cloud on the device; "device"
        leaves everything on the device.

        The device stages are three graphs (stage A, stage B, the
        reprojection), made at the first call and kept until close(): on
        the card a replay each, whose outputs the next replay overwrites,
        so the tensors handed back are clones.  Calls from several threads
        take turns of frame_turn, whose `graphs` they are."""
        _check_fetch(fetch)
        with self.frame_turn(self._make_frame_graphs) as graphs, \
                P.frame(self.elas.frame_ids, "process_frame") as fr:
            fr.add(graphs=sum(g.graph is not None for g in graphs))
            t0 = time.perf_counter()
            with P.span("svtt.gray"):
                g1 = bgr_to_gray(left)
                g2 = bgr_to_gray(right)
            td = time.perf_counter()
            D1, _ = self.elas.replay_frame(graphs, g1, g2)
            with P.span("svtt.reproject"):
                dmap, points = graphs[2](D1)
                D1 = D1.clone()
                if fetch == "device":
                    dmap = dmap.clone()
                if fetch != "host":
                    points = points.clone()
            if fetch in ("host", "dmap"):
                with P.span("svtt.fetch_dmap"):
                    dmap = to_host(dmap)
            tq = time.perf_counter()
            if fetch == "host":
                with P.span("svtt.fetch_cloud"):
                    points = to_host(points).reshape(-1, 3)
            t1 = time.perf_counter()
            # dmap_t starts after the gray conversion, as the JAX engine's
            self.timings = {"t_t": t1 - t0, "dmap_t": tq - td,
                            "pc_t": t1 - tq}
        return {"dmap": dmap, "disparity": D1, "points": points,
                "timings": dict(self.timings)}

    # -- pipelined streaming path -------------------------------------------

    def stream(self, frames: Iterable[Tuple[np.ndarray, np.ndarray]],
               lookahead: int = 2, fetch: str = "host") -> Iterator[Dict]:
        """Process a stream of (left, right) frames with a software
        pipeline: stage A of the next frames is enqueued ahead, so the
        host middle of frame i overlaps the device's work on the frames
        around it.  Yields {"dmap" (NumPy), "points" ((pc_h*pc_w, 3) NumPy
        under fetch="host", else the (pc_h, pc_w, 3) tensor), "timings"}
        per frame, in order."""
        _check_fetch(fetch)
        frames = iter(frames)
        q = collections.deque()

        def dispatch_a():
            try:
                lf, rf = next(frames)
            except StopIteration:
                return False
            t0 = time.perf_counter()
            with P.frame(self.elas.frame_ids, "stream") as fr:
                with P.span("svtt.gray"):
                    g1, g2 = bgr_to_gray(lf), bgr_to_gray(rf)
                with P.span("svtt.stage_a"):
                    q.append((t0, fr.frame_id,
                              self.elas.stage_support(g1, g2)))
            return True

        for _ in range(lookahead):
            if not dispatch_a():
                break
        while q:
            t0, fid, (desc1, desc2, d_can) = q.popleft()
            with P.root("svtt.frame", fid, entry="stream"):
                _, dmap_dev, points_dev = self._run_dense(desc1, desc2,
                                                          d_can)
                dispatch_a()
                with P.span("svtt.fetch_dmap"):
                    dmap = to_host(dmap_dev)
                tq = time.perf_counter()
                points = points_dev
                if fetch == "host":
                    with P.span("svtt.fetch_cloud"):
                        points = to_host(points_dev).reshape(-1, 3)
                t1 = time.perf_counter()
            # dmap_t: until the display disparity reached the host; pc_t:
            # the cloud's fetch after it (reference stereo_vision.cpp:682)
            self.timings = {"t_t": t1 - t0, "dmap_t": tq - t0,
                            "pc_t": t1 - tq}
            yield {"dmap": dmap, "points": points,
                   "timings": dict(self.timings)}

    # -- batched throughput path --------------------------------------------

    def stream_batched(self, frames: Iterable[Tuple[np.ndarray, np.ndarray]],
                       batch: int = 4, fetch: str = "dmap",
                       pipeline_depth: int = 2,
                       host_workers: str = "process") -> Iterator[Dict]:
        """Throughput mode: frames in batches of `batch`, each kernel
        launched once a batch (K1 once a pass).  The stages of a batch run
        on a tail worker, `pipeline_depth` batches in flight: support grid
        fetch -> host middle (host_workers="process": the engine's spawn
        pool, falling back to threads where the pool's processes cannot
        start; "thread": threads) -> one packed geometry upload -> stage B
        and the frame tail -> output fetch.  Gray conversion, the image
        upload and stage A of the next batches run on a prefetch thread.
        A short last batch is padded with its last frame.  host_mode
        records how the host middle of the last call ran.

        Yields {"dmap", "points", "timings"} per frame, in order: fetch
        "host" gives NumPy dmap and (pc_h*pc_w, 3) points, "dmap" NumPy
        dmap and the (pc_h, pc_w, 3) tensor, "device" both tensors."""
        _check_fetch(fetch)
        if host_workers not in ("process", "thread"):
            raise ValueError("host_workers must be 'process' or 'thread'")
        ex, workers, prefetch = self._get_executors(batch, pipeline_depth)
        it = iter(frames)
        pending = collections.deque()
        cuda = self.device.type == "cuda"
        # this call's host-middle mode; only the caller's thread publishes it
        host_mode = {"mode": host_workers}

        def next_batch():
            fs = []
            for _ in range(batch):
                try:
                    fs.append(next(it))
                except StopIteration:
                    break
            if not fs:
                return None
            n_real = len(fs)
            while len(fs) < batch:      # pad a short tail batch
                fs.append(fs[-1])
            ids = (None, None)
            if P.recording():
                # an id for each frame of the batch, padding included
                ids = (self.elas.batch_ids.take(),
                       self.elas.frame_ids.take(batch))
            with P.root("svtt.batch", ids[1], batch=ids[0], first=ids[1]):
                with P.span("svtt.gray"):
                    pairs = np.stack([[bgr_to_gray(lf), bgr_to_gray(rf)]
                                      for lf, rf in fs])  # (B, 2, H, W)
                t0 = time.perf_counter()
                with P.span("svtt.upload_images"):
                    out = upload(pairs, self.device)      # 1 H2D
                with P.span("svtt.stage_a"):
                    out = self.elas.stage_support_batched(out)
            return t0, n_real, out, _record(cuda), ids

        def host_middle(d_cans):
            dcs = [d_cans[i] for i in range(d_cans.shape[0])]
            if host_mode["mode"] == "process":
                try:
                    return self.elas.host_mid_parallel(dcs)
                except (BrokenProcessPool, OSError) as err:
                    # the pool's processes could not start (a spawned
                    # process re-imports the main script, which fails
                    # where it lacks an `if __name__ == "__main__"` guard):
                    # threads from here on; a fault of the host middle
                    # itself propagates
                    warnings.warn("host geometry process pool failed (%r); "
                                  "running the host middle on threads"
                                  % (err,))
                    host_mode["mode"] = "thread"
            args = self.elas.host_args
            first = P.current_frame()

            def one(i, dc):
                with P.in_frame(None if first is None else first + i):
                    return host_mid_standalone(dc, *args)
            return list(ex.map(one, range(len(dcs)), dcs))

        def run_tail(entry, submitted):
            t0, n, out, ready, (bid, fid) = entry
            with P.root("svtt.batch", fid, batch=bid, first=fid):
                P.record("svtt.queue_wait", submitted,
                         time.perf_counter_ns())
                _wait(cuda, ready, out)
                return tail(t0, n, out)

        def tail(t0, n, out):
            desc1, desc2, d_can = out
            with P.span("svtt.fetch_support"):
                d_can = to_host(d_can)
            with P.span("svtt.host_mid_pool"):
                gs = host_middle(d_can)
            msgs = [m for g in gs for m in g["warnings"]]
            with P.span("svtt.upload_geometry"):
                buf = np.stack([self.elas.pack_geometry(g) for g in gs])
                geo = upload(buf, self.device)                  # 1 H2D
            with P.span("svtt.stage_b"):
                D1, _ = self.elas.stage_dense_batched(desc1, desc2, geo)
            with P.span("svtt.reproject"):
                dmap, points = self.reproject(D1)
            if fetch in ("host", "dmap"):
                with P.span("svtt.fetch_dmap"):
                    dmap = to_host(dmap)
            t_dmap = time.perf_counter()
            if fetch == "host":
                with P.span("svtt.fetch_cloud"):
                    points = to_host(points)
            elif cuda:
                torch.cuda.current_stream().synchronize()
            return t0, n, dmap, points, t_dmap, msgs

        def emit(done):
            t0, n, dmaps, points, t_dmap, msgs = done
            for m in msgs:
                # captured in the host workers (support thinning, span
                # overflow): re-emitted on the caller's side
                warnings.warn("host geometry worker: " + m)
            # tensors made on a worker's stream, read on the caller's
            _wait(cuda, None, (dmaps, points))
            t1 = time.perf_counter()
            # per frame: dmap_t until the batch's display disparities
            # reached the host, pc_t the cloud's fetch after it
            per, dmap_per, pc_per = ((t1 - t0) / n, (t_dmap - t0) / n,
                                     (t1 - t_dmap) / n)
            for i in range(n):
                self.timings = {"t_t": per, "dmap_t": dmap_per,
                                "pc_t": pc_per}
                yield {"dmap": dmaps[i],
                       "points": (points[i].reshape(-1, 3)
                                  if fetch == "host" else points[i]),
                       "timings": dict(self.timings)}

        # stage A of the next batches on the prefetch thread (two ahead),
        # `pipeline_depth` tails in flight, frames yielded in order
        state = {"exhausted": False}

        def pump_a():
            e = next_batch()
            if e is None:
                state["exhausted"] = True
            return e

        a_futs = collections.deque()

        def submit_a():
            if not state["exhausted"]:
                a_futs.append(prefetch.submit(pump_a))

        for _ in range(2):
            submit_a()
        try:
            while a_futs or pending:
                while a_futs and len(pending) < max(pipeline_depth, 1):
                    e = a_futs.popleft().result()
                    submit_a()
                    if e is not None:
                        pending.append(workers.submit(
                            run_tail, e, time.perf_counter_ns()))
                if pending:
                    yield from emit(pending.popleft().result())
        finally:
            self.host_mode = host_mode["mode"]
            if host_mode["mode"] != host_workers:
                # the broken pool goes once the call's batches are done
                # (the next call makes a new one)
                for f in pending:
                    f.cancel()
                futures_wait(pending)
                self.elas.close()

    # -- object fusion -------------------------------------------------------

    def object_positions(self, points, boxes) -> np.ndarray:
        """Mean 3-D position per detection box (reference
        stereo_vision.cpp:261-277).  points: a cloud as the engine returns
        it, NumPy or a tensor, (pc_h*pc_w, 3) or (pc_h, pc_w, 3); boxes:
        (B, 4) [x, y, w, h].  The sums run where the cloud lies.  Returns
        (B, 3) float32 NumPy."""
        if not torch.is_tensor(points):
            points = torch.from_numpy(np.array(points, np.float32))
        pts = points.reshape(self.pc_h, self.pc_w, 3)
        return to_host(box_centroids(pts, boxes))


class StereoVision:
    """Drop-in analogue of the reference pip package's Python class
    `stereo_vision.stereo_vision` (stereo_vision/sv.py:156-192; counterpart
    of stereovision_tpu/engine.py:500-554): the same constructor surface
    plus `device`, and generatePointCloud(left, right) -> (width*height, 3)
    float64 points.  objectTracking=True detects on every left frame and
    tracks the boxes; self.last["objects"] holds the frame's detections and
    the tracker's predicted boxes, self.last["rows"] the detector's decoded
    rows of the frame ((rows, 5 + classes) float32 NumPy).  Spans: the roots
    "svtt.detect" (the detector's spans inside) and "svtt.track" (counts
    boxes, predicted), in the frame id of process_frame's "svtt.frame"."""

    def __init__(self, so_lib_path=None, width=1242, height=375,
                 defaultCalibFile=True, objectTracking=False, graphics=False,
                 display=False, scale=1, pc_extrapolation=1,
                 YOLO_CFG=None, YOLO_WEIGHTS=None, YOLO_CLASSES=None,
                 CAMERA_CALIBRATION_YAML=None, subsampling=False,
                 device: Optional[str] = None):
        if CAMERA_CALIBRATION_YAML is None:
            CAMERA_CALIBRATION_YAML = DEFAULT_CALIB
        self.width, self.height = width, height
        self.engine = StereoEngine(CAMERA_CALIBRATION_YAML, width, height,
                                   scale=scale,
                                   pc_extrapolation=pc_extrapolation,
                                   subsampling=subsampling, device=device)
        self.objectTracking = objectTracking
        self.tracker = None
        self.detector = None
        if objectTracking:
            from .models.bayesian import BayesianTracker
            from .models.yolo import YoloV4Tiny
            self.tracker = BayesianTracker()
            # the JAX class runs without detection where the detector
            # cannot be built (a missing or mismatched file); the port
            # says why.  The files are read on the CPU: a fault of the
            # card propagates from the move below.
            try:
                detector = YoloV4Tiny.from_files(
                    YOLO_CFG, YOLO_WEIGHTS, YOLO_CLASSES, device="cpu")
            except Exception as err:
                warnings.warn("objectTracking: no detector (%r); frames "
                              "are processed without detection" % (err,))
            else:
                self.detector = detector.to(self.engine.device)

    def generatePointCloud(self, left, right) -> np.ndarray:
        res = self.engine.process_frame(left, right)
        self.last = res
        if self.objectTracking and self.detector is not None:
            # the frame's detection and tracking, each a root in the frame
            # of process_frame's "svtt.frame"
            fid = P.last_frame()
            with P.root("svtt.detect", fid):
                rows = self.detector.rows([left])
                dets = self.detector.decode(rows, [left.shape[:2]])[0]
            with P.root("svtt.track", fid) as sp:
                preds = self.tracker.get_predicted_boxes()
                self.tracker.append(dets)
                sp.add(boxes=len(dets), predicted=len(preds))
            self.last["rows"] = rows[0]
            self.last["objects"] = dets + preds
        print(frame_line(res))
        return res["points"].astype(np.float64)

    def close(self):
        """Release the engine's worker threads and processes (reference
        clean(), stereo_vision.cpp:105-114).  Idempotent."""
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.close()

    def __del__(self):
        self.close()


def _check_fetch(fetch: str) -> None:
    if fetch not in ("host", "dmap", "device"):
        raise ValueError("fetch must be 'host', 'dmap' or 'device'")


def _own_stream(device: torch.device) -> None:
    """Thread initializer: on the card, give the thread a CUDA stream of
    its own (the current stream is per thread)."""
    if device.type == "cuda":
        torch.cuda.set_stream(torch.cuda.Stream(device))


def _record(cuda: bool):
    """An event at the end of the current stream's work so far (None off
    the card)."""
    if not cuda:
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _wait(cuda: bool, event, tensors) -> None:
    """Order the current stream after `event` (if any), and mark the
    tensors in `tensors` (nested tuples) as used on it, so that the
    allocator of the stream that made them does not hand their memory out
    while this stream may still read it."""
    if not cuda:
        return
    stream = torch.cuda.current_stream()
    if event is not None:
        stream.wait_event(event)
    todo = [tensors]
    while todo:
        x = todo.pop()
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                x.record_stream(stream)
        elif isinstance(x, (tuple, list)):
            todo.extend(x)
