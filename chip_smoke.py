#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stereovision_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a non-zero
exit code (nothing is caught):

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build: the native host helpers (g++) and the four CUDA kernels (nvcc,
     sm_90a, one process per source, in parallel), timed; then the floor
     line: an empty kernel of the same library timed as the kernels are
     (one call between two events; the mean of 100 calls between one pair
     as the host issues them; the mean of 100 calls queued behind a spin
     kernel that holds the stream, so they run back to back on the card);
  3. a seeded synthetic KITTI-size (1242x375) stereo pair with its true
     disparity (stereovision_tpu_torch/synthetic.py);
then, once at full resolution (app_params()) and once subsampled
(app_params(subsampling=True): candidate step 6, stage B on the (187, 621)
half lattice):
  4. every kernel against its plain PyTorch version on the card, on the
     inputs one frame of the main path gives it: exact equality required,
     times by CUDA events (median of 10 calls) of the kernel's launch
     function alone, of its wrapper (the launch and its device dispatch)
     and of the plain version, and the floor line's two means of 100
     launches; and K3 once more on a constant map
     of the mode's output size, one component over the whole frame, the
     longest union-find chains (exact, timed);
  5. the main path: StereoEngine.process_frame over 8 frames after one
     warm-up, with the kernels' launch counters set to 0 just before and
     read just after; frame 0 is checked against the same port on the CPU
     (D1, dmap and points bit for bit) and every frame for sanity (shapes,
     >= 80 % of D1 valid, median |D1 - truth| <= 1 on the output
     lattice); then a per-stage breakdown (stage A, host middle, stage B,
     reproject) and two frames under torch.profiler (device busy time and
     idle share, device time by kernel);
  6. streaming, at batch 8 at full resolution and batch 4 subsampled (the
     batches of bench.py): the kernels' batched modes against their plain
     versions and against B single-frame launches on one batch of real
     inputs (exact; timed as in phase 4; bounds B times a frame's);
     StereoEngine.stream over the 8 frames; StereoEngine.stream_batched
     (pipeline_depth=3, host_workers="process", fetch="host") over 10
     batches and 3 frames (a padded last batch) after a warm-up of 2
     batches.  Every streamed frame must
     equal that frame's process_frame from phase 5 bit for bit (dmap and
     points), the process pool must have run, and the launch counts,
     zeroed just before each of the two paths and read just after, must be
     one a frame for stream and one a batch for stream_batched (K1 two).
     It prints frames/s (the whole run's: all its frames over all its time;
     beside it the 5 batch-aligned windows of bench.py's protocol and their
     median) and two batches of stream_batched under torch.profiler;
then:
  7. the command line (python -m stereovision_tpu_torch, called as
     cli.main in this process) on the 8 frames of phase 5, written as PNGs
     in KITTI raw layout into a temporary directory (the machine may have
     neither cv2 nor PIL: the port's own PNG reader decodes them): --dump
     npz frame by frame, with --batch 8 and with -s 1, each frame's dmap
     and points equal bit for bit to phase 5's process_frame of that mode;
     a run with no dump (process_frame(fetch="dmap")), whose 8 per-frame
     lines and AVG_FPS line must parse; -P (ROBOTICS, both images
     post-processed) on 2 gray pairs of the scene, whose PGMs must equal
     byte for byte those the same CLI writes on the CPU; launch counts of
     every run asserted; and ElasEngine(app_params(), host_filters=False)
     on one frame, equal to the CPU bit for bit.  Prints `{"cli": ...}`
     with each run's AVG_FPS as the CLI printed it and its wall time;
  8. detection and the C ABI, on the 8 frames of phase 5 at full
     resolution, with the built-in YOLOv4-tiny cfg (608x608) and a weights
     file synthesized from seed 0 (synthetic.darknet_weights; the repo
     holds no weights): detect_batch's rows on the card (cuDNN's TF32 off)
     against the CPU's (rtol 1e-5, atol 1e-6; the largest differences
     printed, and the same forward with TF32 on beside them), the
     detections equal to the CPU's on every frame whose decision margins
     hold; forward ms for 1 and 8 frames (CUDA events, median of 10) and a
     profile of one detect_batch; StereoVision(objectTracking=True) over
     the 8 frames (points equal to phase 5's bit for bit, frame 0's objects
     equal to the CPU's where the margins hold); cli.main with -o -ycfg
     -yw on the frames as PNGs, frame by frame and --batch 8 over 11 frames
     (a last group of 3, padded), each frame's detection lines equal to
     those made from phase 5's cloud and the card's detections (the
     float64 means of the finite points of frame 0's boxes printed beside
     them); object_positions at KITTI size for 1
     and 8 boxes against one masked torch sum; the C ABI through ctypes in
     this process (4 frames from new buffers, clouds equal to phase 5's as
     float64, getColor equal to the left BGRA) and csrc/capi_example.c,
     built with gcc -ldl and run in a subprocess on the card; launch
     counts of every path asserted;
  9. multi-device, on the frames of phase 5, once in each mode:
     ShardedStereoPipeline (stereovision_tpu_torch/parallel/) at 1242x375
     on a mesh of stream 2 x tile 2 (cuda:0 four times, or four GPUs where
     there are), batch 4: rows padded to 376 (and 188 subsampled), the
     kernels launched once per row stripe (K1, K2, K4) and K3 banded (a
     stripe labelling per shard and one merge); each cropped frame equal
     to phase 5's process_frame D1 bit for bit, padding rows -10, launch
     counts asserted; frames/s; then each stripe launch and K3 banded on
     one stream group's real inputs against its plain version and against
     the unsplit launch (exact; K3's plain version the banded one,
     stripe labels and a merge to a fixpoint; timed as in phase 4).  Then
     the multi-process launcher (python -m stereovision_tpu_torch.parallel
     .launch --nproc 2 --local-devices 2 --width 1242 --height 375
     --steps 2; gloo, each process cuda:0 twice): both processes must
     report 0 shard errors;
  10. the viewer and the profiler: cli.main with --view3d --record on 4
     of phase 5's frames as PNGs ($DISPLAY unset) at full resolution
     (the viewer with cv2 hidden, as on a machine without it: PGMs of the
     gray mean), with -s 1, and with -o on phase 8's synthesized weights
     (cubes; cv2 as the machine has it): 3 recorded windows a frame, each
     cloud equal bit for bit to the port's renderer on the CPU given
     phase 5's cloud of that frame and the cubes the viewer was given,
     each disparity window to colorize_disparity of phase 5's dmap,
     launch counts those of phase 7; the same frames with --view3d and no
     --record, and with no viewer, for contrast; the renderer alone on phase 5's KITTI cloud (465,750 points) at 960x540,
     point_px 1 and 2, with and without rings, on the card (the cloud a
     tensor there; CUDA events, median of 10) and on the CPU, the images
     equal bit for bit; profile_pipeline's four sections in both modes;
     and device_trace around one process_frame, whose Chrome trace must
     name the CUDA functions of all four kernels;
  11. the one-dispatch mode, on the 8 frames of phase 5, in each mode:
     ElasEngine.process_jit (stage A and stage B each one replay of a CUDA
     graph, the host middle between them), its graphs made at the first
     call (seconds, each graph's capture seconds, memory reserved before
     and after), then the 8 frames with the launch counts zeroed just
     before and read just after (one a frame, K1 two), every D1 and D2
     equal bit for bit to eager ElasEngine.process; frame ms of both
     paths in interleaved turns (eager, graphs, graphs, eager), each
     stage's host ms to a synchronise, two frames of each under
     torch.profiler (idle share, the runtime's launch calls).  A capture
     that fails fails the run;
  12. the degenerate frames of the robustness tests
     (synthetic.degenerate_frames): a flat 96x64 pair under the robotics
     preset (no support point, no triangle) and under app_params(), full
     and subsampled (only the corner points), an unrelated 96x64 pair,
     and a 32x24 frame (narrower than a block of K1 or K2) under the
     robotics preset and under app_params() (D = 256 above the width);
     each, with its pair swapped beside it, through ElasEngine.process,
     process_jit (graphs captured at that size), the batched stages at
     batch 2 and ShardedStereoPipeline on a (1, 2) mesh of cuda:0 (the
     stripe launches and K3 banded), and for two cases on a (1, 5) mesh
     too (every frame's rows padded): every D1 and D2 equal to the
     port's on the CPU bit for bit, the launch counts of each path
     asserted, one line a case with each path's host ms and its set-up's
     (the CPU reference, process_jit's graphs, each pipeline's pool
     start, warm-up and close).  Then one support grid of
     phase 5 through the host library and its NumPy fallbacks: the
     sequential filters equal, and host ms of both; the rasterizers' host
     ms, and the triangle-id pixels, span-code bytes and D1 pixels in
     which their results differ (a reading);
  13. the reference's scale grid (stereovision_tpu_torch/scales.py: scale
     0.5, 0.6, ..., 3.0, each at full resolution and subsampled; 52 frame
     sizes from 2484x750 down to 414x125): for each pair, StereoEngine at
     int(1242 / s) x int(375 / s) with the intrinsics divided by s, on two
     of phase 3's pairs resized as io/kitti.py resizes them;
     process_frame after a warm-up, ElasEngine.process_jit (graphs made
     at that size) and stream_batched (pipeline_depth=3, fetch "host") at
     the sweep's batch, 2 batches after one of warm-up, the host middle in
     the spawn pool for the scales of SCALE_POOL and on threads for the
     rest; every process_jit D1 and D2 equal to eager process's and every
     streamed frame's dmap and points to its process_frame's, bit for
     bit; frame 0 equal to the port on the CPU for the pairs of SCALE_CPU
     (computed in one spawned worker while the card works through the
     grid, compared at the end; the CPU's seconds printed); launch counts of each path asserted; one
     `{"scale": ...}` line a pair (ms a frame of both single-frame paths,
     whole-run frames/s, launches, set-up ms).  Then cli.main with -f 0.5
     and with -f 3 -s 1 on 4 of phase 5's frames as 1242x375 PNGs, every
     dumped frame equal to process_frame at that size, and the C ABI's
     generatePointCloud at scale 2, its cloud equal to process_frame's;
and last:
  14. one JSON line per kernel result, one `{"kernels": [...]}` line with
     a row per kernel and mode, single-frame, batched and striped (each
     row names the design that replaced the kernel's first one, and the
     path that replays that mode inside a CUDA graph with its launches
     there), the card line, and `{"ok": true, "device": {...}}`.

It exits non-zero, printing no result, when CUDA is not available or the
package is not beside it.  Every time printed names the card and its power
limit.
"""

import contextlib
import io
import json
import os
import re
import socket
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

if __name__ != "__mp_main__":
    # the host pools' spawned workers import this script as __mp_main__
    # and run no torch: importing it there took ~6 s of each pool's start
    import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1242, 375
FRAMES = 8
REPS = 10
BATCH = {"full": 8, "subsampled": 4}
STREAM_BATCHES = 10          # stream_batched: whole batches after warm-up
WINDOWS = 5                  # frames/s windows (bench.py's protocol)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
OPS_PER_S = 67e12             # H100 SXM 32-bit rate outside tensor cores
CSRC = "stereovision_tpu_torch/csrc/"
PALLAS = "stereovision_tpu/ops/pallas/"
SOURCES = {"matching": (CSRC + "matching.cu", PALLAS + "matching_pl.py:60"),
           "support": (CSRC + "support.cu", PALLAS + "support_pl.py:50"),
           "lr_check": (CSRC + "lr.cu", PALLAS + "lr_pl.py:36"),
           "speckle_ccl": (CSRC + "ccl.cu", PALLAS + "ccl_pl.py:82")}
# the sharded modes: row stripes (K1, K2, K4) and K3 banded
STRIPED = {"matching": PALLAS + "matching_pl.py:259",
           "support": PALLAS + "support_pl.py:146",
           "lr_check": PALLAS + "lr_pl.py:122",
           "speckle_ccl": PALLAS + "ccl_pl.py:260"}
SHARDED_BATCH = 4            # phase 9: frames a step, over 2 stream groups
SHARDED_STEPS = 3            # ... timed steps after the checked one
# the kernels whose first design was replaced, and by what
REDESIGNED = {"support": "shared F(x, d) table, reads the descriptor planes",
              "speckle_ccl": "block-local union-find, path compression",
              "matching": "4 rows x 128 columns a block, B windows and cell "
                          "words in shared memory, reads the planes and the "
                          "mask",
              "lr_check": "a row a block, both rows in shared memory"}
BACK_TO_BACK = 100           # launches timed between one pair of events
BANDED_QUEUE = 40            # ... of K3 banded (~11 launches a call)
SPIN_MS = 50.0               # how long the spin kernel holds the stream
SPIN_TRIES = 3               # ... at first; 4x longer at each retry


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps=REPS) -> float:
    """Median milliseconds of one call of fn, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def mean_ms(fn, n, spin_ms=0.0):
    """Mean milliseconds of n calls of fn between one pair of events,
    behind a spin kernel of spin_ms that holds the stream (0: none), and
    whether the spin was still running when the last call was queued."""
    from stereovision_tpu_torch.ops.cuda import _lib
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    if spin_ms:
        _lib.spin(spin_ms)
        spun = torch.cuda.Event()
        spun.record()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    held = bool(spin_ms) and not spun.query()
    end.synchronize()
    return start.elapsed_time(end) / n, held


def launch_times(fn, name, n=BACK_TO_BACK) -> dict:
    """fn timed three ways: event_ms (one call between two events, median
    of REPS), back_to_back_ms (the mean of n calls between one pair of
    events, issued as fast as the host can) and queued_ms (the same n
    calls queued behind a spin kernel that holds the stream, so that they
    run back to back on the card whatever the host's pace).  The spin
    starts at SPIN_MS and grows 4x, SPIN_TRIES times at most, until it
    outlasts the queueing; if it never does, the run fails with `name`."""
    out = {"event_ms": event_ms(fn), "back_to_back_ms": mean_ms(fn, n)[0]}
    spin = SPIN_MS
    for _ in range(SPIN_TRIES):
        out["queued_ms"], held = mean_ms(fn, n, spin)
        if held:
            out["spin_ms"] = spin
            return out
        spin *= 4
    raise AssertionError("%s: queueing %d launches outlasted a %g ms spin"
                         % (name, n, spin / 4))


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(kernel_out, plain_out):
    """(mismatching elements, max |kernel - plain|) over tensors/tuples."""
    if torch.is_tensor(kernel_out):
        kernel_out = (kernel_out,)
    if torch.is_tensor(plain_out):
        plain_out = (plain_out,)
    bad, err = 0, 0.0
    for k, p in zip(kernel_out, plain_out):
        assert k.shape == p.shape and k.dtype == p.dtype, (k.shape, p.shape)
        bad += int((k != p).sum())
        err = max(err, float((k.double() - p.double()).abs().max()))
    return bad, err


def profile_frames(eng, scenes) -> dict:
    """process_frame over a few frames under torch.profiler (profile)."""
    def run():
        for lf, rf, _ in scenes:
            eng.process_frame(lf, rf)
    return dict(frames=len(scenes), **profile(run))


def profile(run) -> dict:
    """Device time of run() under torch.profiler: the union of the
    device's busy intervals against the host's wall time, and device
    milliseconds by kernel name (the ten largest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    calls = {}
    for e in prof.events():
        # the runtime's launch calls: cudaLaunchKernel, cudaGraphLaunch, ...
        if e.device_type == DeviceType.CPU and "Launch" in e.name:
            calls[e.name] = calls.get(e.name, 0) + 1
    if not spans:
        return {"device_busy": "not measured", "launch_calls": calls}
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        # "void at::native::foo<...>(...)" -> "at::native::foo"
        short = re.split(r"[<(]", name.replace("(anonymous namespace)::", "")
                         .removeprefix("void "))[0].strip()[:60]
        by_name[short] = by_name.get(short, 0.0) + (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall_us,
            "device_ms_by_kernel": dict(top), "launch_calls": calls}


def check_kernels(eng, p, frames, card, mode) -> dict:
    """Phases 4 and 6 for one mode: every kernel of the path against its
    plain version on real inputs, of one frame (its single-frame mode) or
    of a batch of frames (its batched mode, also held against a
    single-frame launch on each frame); returns the result lines by kernel
    name."""
    from stereovision_tpu_torch.engine import bgr_to_gray
    from stereovision_tpu_torch.ops import matching, postprocess, support
    from stereovision_tpu_torch.ops.cuda import (ccl_cu, lr_cu, matching_cu,
                                                 support_cu)
    elas = eng.elas
    Ho, Wo = elas.Ho, elas.Wo
    B = len(frames)
    grays = [(bgr_to_gray(lf), bgr_to_gray(rf)) for lf, rf in frames]
    if B > 1:
        desc1, desc2, d_can = elas.stage_support_batched(np.stack(grays))
        geo = elas.upload_geometry([elas.host_mid(dc)
                                    for dc in d_can.cpu().numpy()])
        frame = lambda x, i: x[i].clone()  # noqa: E731 (16-byte aligned)
    else:
        desc1, desc2, d_can = elas.stage_support(*grays[0])
        geo = elas.upload_geometry(elas.host_mid(d_can.cpu().numpy()))
        frame = lambda x, i: x  # noqa: E731
    (tid_l, pl_l, gm_l), (tid_r, pl_r, gm_r) = elas.dense_inputs(*geo)
    maps_l = matching.plane_maps(tid_l, pl_l, p)
    maps_r = matching.plane_maps(tid_r, pl_r, p)
    D1 = matching_cu.compute_disparity(desc1, desc2, tid_l, pl_l, gm_l, p,
                                       right_image=False)
    D2 = matching_cu.compute_disparity(desc2, desc1, tid_r, pl_r, gm_r, p,
                                       right_image=True)
    L1, _ = lr_cu.lr_consistency_check(D1, D2, p)
    torch.cuda.synchronize()
    Hc = -(-H // p.step)

    def candidates(maps, gm, right_image):
        return sum(n_candidates(p, [frame(m, i) for m in maps], frame(gm, i),
                                right_image) for i in range(B))

    def singles(fn, *args):
        """fn on each frame of args, one single-frame launch each."""
        if B == 1:
            return {}
        return {"singles": lambda: [fn(*(frame(a, i) for a in args))
                                    for i in range(B)]}

    # "ms" times a kernel's launch function alone, "wrapper_ms" the
    # wrapper (its device dispatch; K1's also finds the resident prior)
    prior = matching_cu.prior_table(p, desc1.device)
    # a frame's Ho source rows of the A planes at the lattice's columns,
    # the Ho full rows of the B planes, the grid mask's bytes, four maps,
    # the keys; one prior table
    match_bytes = (B * (Ho * Wo * 16 + Ho * W * 16 + p.disp_num
                        * gm_l.shape[-2] * gm_l.shape[-1] + 4 * Ho * Wo * 4
                        + Ho * Wo * 4) + p.disp_num * 4)
    checks = {
        "support": dict(
            kernel=lambda: support_cu.support_scan(desc1, desc2, p),
            launch=lambda: support_cu.launch(desc1, desc2, p),
            plain=lambda: support.support_scan(desc1, desc2, p),
            nbytes=B * (2 * 16 * H * W + 8 * Hc * W * 4),
            ops=B * support_ops(p),
            **singles(lambda a, b: support_cu.support_scan(a, b, p),
                      desc1, desc2)),
        "matching_left": dict(
            kernel=lambda: matching_cu.match_keys(desc1, desc2, *maps_l,
                                                  gm_l, p, False),
            launch=lambda: matching_cu.launch(desc1, desc2, *maps_l, gm_l,
                                              prior, p, False),
            plain=lambda: matching.match_keys(desc1, desc2, *maps_l, gm_l,
                                              p, False),
            nbytes=match_bytes, ops=candidates(maps_l, gm_l, False) * 32,
            **singles(lambda *a: matching_cu.match_keys(*a, p, False),
                      desc1, desc2, *maps_l, gm_l)),
        "matching_right": dict(
            kernel=lambda: matching_cu.match_keys(desc2, desc1, *maps_r,
                                                  gm_r, p, True),
            launch=lambda: matching_cu.launch(desc2, desc1, *maps_r, gm_r,
                                              prior, p, True),
            plain=lambda: matching.match_keys(desc2, desc1, *maps_r, gm_r,
                                              p, True),
            nbytes=match_bytes, ops=candidates(maps_r, gm_r, True) * 32,
            **singles(lambda *a: matching_cu.match_keys(*a, p, True),
                      desc2, desc1, *maps_r, gm_r)),
        "lr_check": dict(
            kernel=lambda: lr_cu.lr_consistency_check(D1, D2, p),
            launch=lambda: lr_cu.launch(D1, D2, p),
            plain=lambda: postprocess.lr_consistency_check(D1, D2, p),
            nbytes=B * 4 * Ho * Wo * 4, ops=B * 2 * Ho * Wo * 8,
            **singles(lambda a, b: lr_cu.lr_consistency_check(a, b, p),
                      D1, D2)),
        "speckle_ccl": dict(
            kernel=lambda: ccl_cu.remove_small_segments(L1, p),
            plain=lambda: postprocess.remove_small_segments(L1, p),
            nbytes=B * 2 * Ho * Wo * 4, ops=B * Ho * Wo * 16,
            **singles(lambda d: ccl_cu.remove_small_segments(d, p), L1)),
    }
    if B == 1:
        const = torch.full((Ho, Wo), 30.0, device=L1.device)
        checks["speckle_ccl_constant_map"] = dict(
            kernel=lambda: ccl_cu.remove_small_segments(const, p),
            plain=lambda: postprocess.remove_small_segments(const, p),
            nbytes=2 * Ho * Wo * 4, ops=Ho * Wo * 16)
    # a batch's plain versions loop over its frames: fewer repetitions
    return run_checks(checks, card, mode, REPS if B == 1 else 3)


def run_checks(checks, card, mode, plain_reps=REPS) -> dict:
    """Each check's kernel against its plain version (exact) and, where it
    has "singles", against that list of single-frame outputs; times by
    CUDA events; returns the result lines by name."""
    results = {}
    for name, c in checks.items():
        k_out = c["kernel"]()
        torch.cuda.synchronize()
        p_out = c["plain"]()
        bad, err = compare(k_out, p_out)
        r = dict(name=name, mode=mode, mismatches=bad, max_abs_err=err)
        if "singles" in c:
            outs = k_out if isinstance(k_out, tuple) else (k_out,)
            r["frames_differing_from_single_launches"] = sum(
                compare(tuple(o[i] for o in outs), single)[0] > 0
                for i, single in enumerate(c["singles"]()))
        if "unsplit" in c:
            r["mismatches_vs_unsplit"] = compare(k_out, c["unsplit"]())[0]
            r["unsplit_queued_ms"] = launch_times(
                c["unsplit"], "%s unsplit (%s)" % (name, mode))["queued_ms"]
        times = launch_times(c.get("launch", c["kernel"]),
                             "%s (%s)" % (name, mode),
                             c.get("queue", BACK_TO_BACK))
        r.update(ms=times.pop("event_ms"), **times,
                 wrapper_ms=event_ms(c["kernel"]),
                 plain_ms=event_ms(c["plain"], plain_reps),
                 bytes=c["nbytes"], ops=c["ops"], card=card)
        r["bound_ms"], r["bound_by"] = bound_ms(c["nbytes"], c["ops"])
        results[name] = r
        print(json.dumps(r), flush=True)
        assert bad == 0, "%s (%s): kernel and plain version differ" % (
            name, mode)
        assert not r.get("frames_differing_from_single_launches"), (
            "%s (%s): the batched launch differs from single-frame launches"
            % (name, mode))
        assert not r.get("mismatches_vs_unsplit"), (
            "%s (%s): the striped launch differs from the unsplit one"
            % (name, mode))
    return results


def support_ops(p) -> int:
    """Least operations of one frame's support scan.  Both directions read
    one table F(x, d) = SAD32(A(x), B(x - d)): forward Fg(u) = F(u-2) +
    F(u+2) and backward Fg(u+d).  So each (row, x, d) that either
    direction reads costs one SAD32 (32 abs-diffs, 32 adds), each Fg entry
    one add, and each valid (u, d) of a direction one compare."""
    u = np.arange(W)
    per_row = 0
    for d in range(max(p.disp_min, 0), p.disp_max + 1):
        fwd = u[u >= d + 5]
        bwd = u[u <= W - d - 5] + d
        fg = np.union1d(fwd, bwd)
        f = np.union1d(fg - 2, fg + 2)
        per_row += 64 * f.size + fg.size + fwd.size + bwd.size
    return -(-H // p.step) * per_row


def n_candidates(p, maps, gm, right_image) -> int:
    """Candidates this frame's data gives the matching pass: each output
    pixel's cell bits and plane window, warp inside the row."""
    from stereovision_tpu_torch.ops import matching
    s = matching.lattice_step(p)
    lo, hi = maps[0], maps[1]
    Ho, Wo = lo.shape
    gy = torch.arange(Ho, device=lo.device) * s // p.grid_size
    gx = torch.arange(Wo, device=lo.device) * s // p.grid_size
    uu = torch.arange(Wo, device=lo.device)[None, :] * s
    n = 0
    for d in range(p.disp_num):
        uw = uu + d if right_image else uu - d
        cand = ((gm[d][gy][:, gx] | ((d >= lo) & (d <= hi)))
                & (uw >= 2) & (uw <= W - 3))
        n += int(cand.sum())
    return n


def wrappers() -> dict:
    from stereovision_tpu_torch.ops.cuda import (ccl_cu, lr_cu, matching_cu,
                                                 support_cu)
    return {"matching": matching_cu, "support": support_cu,
            "lr_check": lr_cu, "speckle_ccl": ccl_cu}


def zero_counts() -> None:
    for m in wrappers().values():
        m.launches = 0
    wrappers()["speckle_ccl"].merges = 0


def read_counts() -> dict:
    return {k: m.launches for k, m in wrappers().items()}


def drive_main_path(eng, calib, scenes, card, mode):
    """Phase 5 for one mode: process_frame over the frames after a
    warm-up, launch counts, the CPU reference on frame 0, sanity on every
    frame, stage times and a profile; returns the launch counts and the
    frames' outputs."""
    from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
    elas = eng.elas
    Ho, Wo = elas.Ho, elas.Wo
    step = W // Wo
    eng.process_frame(scenes[0][0], scenes[0][1])
    torch.cuda.synchronize()
    zero_counts()
    outs, frame_s = [], []
    for lf, rf, _ in scenes[1:]:
        t = time.perf_counter()
        outs.append(eng.process_frame(lf, rf))
        frame_s.append(time.perf_counter() - t)
    launches = read_counts()
    print(json.dumps({"main_path": {
        "mode": mode, "frames": FRAMES,
        "frame_ms": [1e3 * s for s in frame_s],
        "frame_ms_median": 1e3 * float(np.median(frame_s)),
        "launches": launches, "card": card}}), flush=True)
    assert launches == per_frame_counts(eng.p, FRAMES), launches

    for (lf, rf, truth), out in zip(scenes[1:], outs):
        D = out["disparity"].cpu().numpy()
        assert D.shape == (Ho, Wo), D.shape
        assert out["dmap"].shape == (Ho, Wo) and out["dmap"].dtype == np.uint8
        assert out["points"].shape == (H * W, 3)
        pts = out["points"].reshape(H, W, 3)[::step, ::step][:Ho, :Wo]
        assert np.isfinite(pts[out["dmap"] > 0]).all()
        valid = D >= 0
        t = truth[::step, ::step][:Ho, :Wo]
        err = float(np.median(np.abs(D[valid] - t[valid])))
        assert valid.mean() >= 0.8 and err <= 1, (valid.mean(), err)
    ref = StereoEngine(calib, W, H, params=eng.p, device="cpu").process_frame(
        scenes[1][0], scenes[1][1])
    assert torch.equal(outs[0]["disparity"].cpu(), ref["disparity"])
    assert np.array_equal(outs[0]["dmap"], ref["dmap"])
    np.testing.assert_array_equal(outs[0]["points"], ref["points"])
    print(json.dumps({"cpu_reference": "D1, dmap and points of frame 0 "
                      "equal bit for bit", "mode": mode, "valid_frac_min": min(
                          float((o["disparity"] >= 0).float().mean())
                          for o in outs)}), flush=True)

    stages = {"stage_a": [], "host_middle": [], "stage_b": [],
              "reproject": []}
    for lf, rf, _ in scenes[1:4]:
        t0 = time.perf_counter()
        d1, d2, dc = elas.stage_support(bgr_to_gray(lf), bgr_to_gray(rf))
        dc = dc.cpu().numpy()
        t1 = time.perf_counter()
        g = elas.host_mid(dc)
        t2 = time.perf_counter()
        # the packed geometry, one upload, as process_frame sends it
        D, _ = elas.stage_dense(d1, d2, *elas.upload_geometry(g))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        dmap, pts = eng.reproject(D)
        dmap.cpu(), pts.cpu()
        t4 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(1e3 * dt)
    print(json.dumps({"stage_ms_median": {k: float(np.median(v))
                                          for k, v in stages.items()},
                      "mode": mode, "card": card}), flush=True)
    print(json.dumps({"profile": profile_frames(eng, scenes[1:3]),
                      "mode": mode, "card": card}), flush=True)
    return launches, outs


def per_frame_counts(p, n: int) -> dict:
    """Launches of n frames, or n batches, of the main path (K1: two
    passes; the speckle filter on D1 only under postprocess_only_left)."""
    return {"matching": 2 * n, "support": n, "lr_check": n,
            "speckle_ccl": n * (1 if p.postprocess_only_left else 2)}


def cold_frame_counts(p, n: int) -> dict:
    """Launches of n frames through process_frame on a new engine: the n
    frames', and at the first call those of the graphs' capture
    (ElasEngine.stage_graphs): stages A and B warmed up eagerly, and stage
    A replayed on the blank frame that stage B is captured from."""
    counts = per_frame_counts(p, n + 1)
    counts["support"] += 1
    return counts


def drive_streams(eng, scenes, outs, card, mode) -> dict:
    """Phase 6's main paths for one mode: stream over the 8 frames, then
    stream_batched at the mode's batch, each with the launch counts zeroed
    just before and read just after; every streamed frame against its
    process_frame output `outs`; frames/s; a profile of two batches.  Returns stream_batched's launch counts."""
    B = BATCH[mode]
    frames = [(lf, rf) for lf, rf, _ in scenes[1:]]

    def seq(n):
        return (frames[i % len(frames)] for i in range(n))

    def same(got, i, what):
        ref = outs[i % len(frames)]
        assert np.array_equal(got["dmap"], ref["dmap"]), (what, i, "dmap")
        assert np.array_equal(got["points"], ref["points"]), (
            what, i, "points")

    zero_counts()
    t = time.perf_counter()
    streamed = list(eng.stream(iter(frames)))
    wall = time.perf_counter() - t
    launches = read_counts()
    assert len(streamed) == len(frames)
    for i, got in enumerate(streamed):
        same(got, i, "stream")
    assert launches == per_frame_counts(eng.p, len(frames)), launches
    print(json.dumps({"stream": {
        "mode": mode, "frames": len(frames), "wall_s": wall,
        "frames_per_s": len(frames) / wall, "launches": launches,
        "equal_to_process_frame": "every frame, dmap and points bit for bit",
        "card": card}}), flush=True)

    run = dict(batch=B, fetch="host", pipeline_depth=3,
               host_workers="process")
    t = time.perf_counter()
    warm = list(eng.stream_batched(seq(2 * B), **run))
    warm_s = time.perf_counter() - t
    assert len(warm) == 2 * B
    n = STREAM_BATCHES * B + 3           # a short, padded last batch
    n_batches = -(-n // B)
    torch.cuda.synchronize()
    zero_counts()
    stamps, got = [], []
    t0 = time.perf_counter()
    for out in eng.stream_batched(seq(n), **run):
        stamps.append(time.perf_counter())
        got.append(out)
    launches = read_counts()
    assert eng.host_mode == "process" and eng.elas._host_pool is not None, (
        "the host middle did not run in the process pool")
    assert len(got) == n
    for i, out in enumerate(got):
        same(out, i, "stream_batched")
    assert launches == per_frame_counts(eng.p, n_batches), launches
    # frames/s: the whole run's; beside it bench.py's protocol, WINDOWS
    # batch-aligned windows of the stream (a batch's frames arrive in one
    # burst) and their median
    seg = max((n // WINDOWS) // B * B, B)
    windows = []
    for k in range(WINDOWS):
        lo, hi = k * seg, min((k + 1) * seg, n) - 1
        if lo >= n or hi <= lo:
            continue
        t_lo = t0 if lo == 0 else stamps[lo - 1]
        windows.append((hi - lo + 1) / (stamps[hi] - t_lo))
    print(json.dumps({"stream_batched": {
        "mode": mode, "batch": B, "pipeline_depth": 3,
        "host_workers": eng.host_mode, "fetch": "host", "frames": n,
        "batches": n_batches, "warmup_s": warm_s,
        "frames_per_s": n / (stamps[-1] - t0),
        "window_frames_per_s": windows,
        "window_median_frames_per_s": float(np.median(windows)),
        "launches": launches,
        "equal_to_process_frame": "every frame, dmap and points bit for bit",
        "card": card}}), flush=True)

    prof = profile(lambda: list(eng.stream_batched(seq(2 * B), **run)))
    print(json.dumps({"profile": dict(frames=2 * B, path="stream_batched",
                                      **prof), "mode": mode, "card": card}),
          flush=True)
    return launches


def write_png(path, bgr) -> None:
    """An (H, W, 3) uint8 BGR frame -> an 8-bit RGB PNG, every row
    unfiltered (filter type 0)."""
    h, w = bgr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           bgr[..., ::-1].reshape(h, 3 * w)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def write_kitti(root, frames) -> str:
    """(left, right) frames -> a KITTI raw-layout directory of PNGs."""
    for cam, k in (("image_02", 0), ("image_03", 1)):
        os.makedirs(os.path.join(root, cam, "data"))
        for i, pair in enumerate(frames):
            write_png(os.path.join(root, cam, "data", "%010d.png" % i),
                      pair[k])
    return root


FRAME_LINE = re.compile(r"^\(FPS=\d+\.\d{6}\) \((\d+), (\d+)\) "
                        r"\(t_t=\d+\.\d{6}, dmap_t=\d+\.\d{6}, "
                        r"pc_t=\d+\.\d{6}\)$")


def run_cli(argv, device=None):
    """cli.main(argv) with the launch counters zeroed just before and read
    just after -> (exit code, its stdout lines, wall seconds, launches)."""
    from stereovision_tpu_torch import cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return rc, buf.getvalue().splitlines(), wall, read_counts()


def check_frame_lines(lines, n, shape):
    """n per-frame lines of the frame's (rows, cols), then AVG_FPS ->
    the AVG_FPS the CLI printed."""
    assert len(lines) == n + 1, lines
    for line in lines[:-1]:
        m = FRAME_LINE.match(line)
        assert m and tuple(map(int, m.groups())) == shape, line
    m = re.match(r"^AVG_FPS=(\d+\.\d{6})$", lines[-1])
    assert m, lines[-1]
    return float(m.group(1))


def drive_cli(scenes, outs, card) -> None:
    """Phase 7: the command line on the frames of phase 5 (outs: each
    mode's process_frame outputs), -P, and host_filters=False; prints the
    `cli` line."""
    from stereovision_tpu_torch.engine import bgr_to_gray
    from stereovision_tpu_torch.io.pgm import save_pgm
    from stereovision_tpu_torch.models.elas import ElasEngine
    from stereovision_tpu_torch.params import app_params, robotics_params
    frames = [(lf, rf) for lf, rf, _ in scenes[1:]]
    n = len(frames)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        kitti = write_kitti(os.path.join(tmp, "kitti"), frames)
        for name, extra, mode, batches in (
                ("npz", [], "full", n), ("npz_batch_8", ["--batch", "8"],
                                         "full", 1),
                ("npz_subsampled", ["-s", "1"], "subsampled", n),
                ("no_dump", None, "full", n)):
            out_dir = os.path.join(tmp, name)
            argv = ["-k", kitti, "-w", str(W), "-ht", str(H)] + (
                ["--dump", "npz", "--out_dir", out_dir] + extra
                if extra is not None else [])
            rc, lines, wall, launches = run_cli(argv)
            assert rc == 0, (name, rc)
            p = app_params(subsampling=mode == "subsampled")
            avg = check_frame_lines(lines, n, p.out_shape(W, H))
            expect = (per_frame_counts if "--batch" in (extra or [])
                      else cold_frame_counts)(p, batches)
            assert launches == expect, (name, launches)
            if extra is not None:
                assert sorted(os.listdir(out_dir)) == [
                    "frame_%06d.npz" % i for i in range(n)]
                for i, ref in enumerate(outs[mode]):
                    got = np.load(os.path.join(out_dir, "frame_%06d.npz" % i))
                    assert np.array_equal(got["dmap"], ref["dmap"]), (name, i)
                    assert np.array_equal(got["points"], ref["points"]), (
                        name, i)
            runs[name] = {"argv": " ".join(a for a in argv[2:]
                                           if not a.startswith(tmp)),
                          "frames": n, "AVG_FPS": avg, "wall_s": wall,
                          "launches": launches}

        # -P: ROBOTICS, both images post-processed, on 2 gray pairs
        prof = os.path.join(tmp, "profile")
        os.makedirs(prof)
        for k, (lf, rf, _) in enumerate(scenes[1:3]):
            save_pgm(bgr_to_gray(lf), os.path.join(prof, "s%d_left.pgm" % k))
            save_pgm(bgr_to_gray(rf), os.path.join(prof, "s%d_right.pgm" % k))
        pgms = {}
        for dev in (None, "cpu"):
            out_dir = os.path.join(tmp, "pgm_%s" % dev)
            rc, lines, wall, launches = run_cli(
                ["-P", "--profile_dir", prof, "--out_dir", out_dir], dev)
            assert rc == 0 and lines[-1] == "... done!", lines
            pgms[dev] = {f: open(os.path.join(out_dir, f), "rb").read()
                         for f in sorted(os.listdir(out_dir))}
            if dev is None:
                runs["profile"] = {"argv": "-P", "pairs": 2, "wall_s": wall,
                                   "launches": launches}
                assert launches == per_frame_counts(
                    robotics_params(postprocess_only_left=False), 2), launches
        assert sorted(pgms[None]) == ["s%d_%s_disp.pgm" % (k, side)
                                      for k in range(2)
                                      for side in ("left", "right")]
        assert pgms[None] == pgms["cpu"], "-P: the card's PGMs differ"
        runs["profile"]["pgm_equal_to_cpu"] = "byte for byte"

    # host_filters=False: the snapshot support filters on the card
    I1, I2 = bgr_to_gray(scenes[1][0]), bgr_to_gray(scenes[1][1])
    got = ElasEngine(app_params(), W, H, host_filters=False).process(I1, I2)
    ref = ElasEngine(app_params(), W, H, host_filters=False,
                     device="cpu").process(I1, I2)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b), "host_filters=False differs from CPU"
    print(json.dumps({"cli": dict(runs=runs, host_filters_false=(
        "ElasEngine(app_params(), host_filters=False).process: D1, D2 equal "
        "to the CPU bit for bit"), card=card)}), flush=True)


def same_detections(a, b, conf_tol) -> bool:
    """Equal names, boxes and colours; conf within conf_tol."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        dx, dy = dict(vars(x)), dict(vars(y))
        if abs(dx.pop("conf") - dy.pop("conf")) > conf_tol or dx != dy:
            return False
    return True


def check_rows(det, cpu, frames, card) -> dict:
    """The card's rows of `frames` (one detect_batch forward, TF32 off)
    against the CPU's, and the card's detections against the CPU's on
    every frame whose decision margins hold; and the rows once more with
    cuDNN's TF32 on, to show what the flag guards against."""
    from stereovision_tpu_torch.models import yolo
    rows = det.rows(frames)
    ref = cpu.rows(frames)
    diff = np.abs(rows.astype(np.float64) - ref)
    rel = diff / np.maximum(np.abs(ref), 1e-30)
    tol = float(diff[..., 5:].max())
    compared, margins = 0, []
    for k, f in enumerate(frames):
        m = yolo.decision_margins(ref[k], rows[k], f.shape[:2])
        margins.append(min(m.values()))
        if margins[-1] > 1:
            compared += 1
            got = det._rows_to_dets(rows[k], f.shape[:2], 0.5, 0.4)
            want = cpu._rows_to_dets(ref[k], f.shape[:2], 0.5, 0.4)
            assert same_detections(got, want, tol), (k, got, want)
    x = torch.stack([yolo._resize_bilinear(np.ascontiguousarray(
        f[..., ::-1]), det.size, det.size, det.device) for f in frames])
    x = (x / torch.full((), 255.0, device=det.device)).permute(0, 3, 1, 2)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=True):
        tf32 = torch.cat(det(x.contiguous()), dim=1).cpu().numpy()
    out = {"frames": len(frames), "rows": list(rows.shape),
           "max_abs_diff": float(diff.max()),
           "max_rel_diff": float(rel.max()),
           "max_abs_diff_scores": tol,
           "tf32_on_max_abs_diff": float(np.abs(tf32 - ref).max()),
           "candidates": [int((r[:, 5:] >= 0.5).sum()) for r in rows],
           "detections": [len(det._rows_to_dets(r, f.shape[:2], 0.5, 0.4))
                          for r, f in zip(rows, frames)],
           "least_margin_ratio": margins,
           "frames_compared_exactly": compared, "card": card}
    np.testing.assert_allclose(rows, ref, rtol=1e-5, atol=1e-6)
    return out


def forward_times(det, frames, card) -> dict:
    """The detector's forward (TF32 off) on 1 and on 8 frames already on
    the card, by CUDA events (median of REPS after a warm-up); detect_batch
    of the 8 frames by the host clock; a profile of one detect_batch."""
    from stereovision_tpu_torch.models import yolo
    out = {}
    for n in (1, len(frames)):
        x = torch.stack([yolo._resize_bilinear(np.ascontiguousarray(
            f[..., ::-1]), det.size, det.size, det.device)
            for f in frames[:n]]).permute(0, 3, 1, 2).contiguous() / 255

        def fwd():
            with torch.no_grad(), torch.backends.cudnn.flags(
                    enabled=True, allow_tf32=False):
                det(x)
        out["forward_ms_batch_%d" % n] = event_ms(fwd)
    ts = []
    for _ in range(3):
        t = time.perf_counter()
        det.detect_batch(frames)
        ts.append(1e3 * (time.perf_counter() - t))
    out["detect_batch_%d_host_ms" % len(frames)] = float(np.median(ts))
    out["profile_detect_batch"] = profile(lambda: det.detect_batch(frames))
    out["card"] = card
    return out


def detection_lines(eng, dets, points) -> list:
    """The CLI's lines for one frame's detections, from a cloud on the
    card."""
    if not dets:
        return []
    pos = eng.object_positions(points, np.array([[d.x, d.y, d.w, d.h]
                                                 for d in dets]))
    return ["  %s conf=%.2f XYZ=(%.2f,%.2f,%.2f)" % (d.name, d.conf, *xyz)
            for d, xyz in zip(dets, pos)]


def finite_means(points, dets) -> list:
    """Each box's float64 mean of the finite points inside it (the boxes
    clamped as box_centroids clamps them)."""
    pts = points.reshape(H, W, 3).astype(np.float64)
    out = []
    for d in dets:
        x0, x1 = min(max(d.x, 0), W - 1), min(max(d.x + d.w, 0), W - 1)
        y0, y1 = min(max(d.y, 0), H - 1), min(max(d.y + d.h, 0), H - 1)
        box = pts[y0:y1, x0:x1].reshape(-1, 3)
        box = box[np.isfinite(box).all(axis=1)]
        out.append(box.mean(axis=0).tolist() if len(box) else None)
    return out


def check_stereo_vision(cfg, weights, cpu, frames, outs, p, card) -> dict:
    """StereoVision(objectTracking=True) over the frames: the points equal
    to process_frame's (outs) bit for bit, launches counted, frame 0's
    objects equal to the CPU detector's where the margins hold."""
    from stereovision_tpu_torch.engine import StereoVision
    from stereovision_tpu_torch.models import yolo
    sv = StereoVision(width=W, height=H, objectTracking=True,
                      YOLO_CFG=cfg, YOLO_WEIGHTS=weights)
    torch.cuda.synchronize()
    zero_counts()
    objects, t = [], time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        for (lf, rf), ref in zip(frames, outs):
            pts = sv.generatePointCloud(lf, rf)
            assert np.array_equal(pts, ref["points"].astype(np.float64))
            objects.append(sv.last["objects"])
    wall = time.perf_counter() - t
    launches = read_counts()
    assert launches == cold_frame_counts(p, len(frames)), launches
    left = frames[0][0]
    rows, ref = sv.detector.rows([left]), cpu.rows([left])
    margin = min(yolo.decision_margins(ref[0], rows[0],
                                       left.shape[:2]).values())
    if margin > 1:
        want = cpu._rows_to_dets(ref[0], left.shape[:2], 0.5, 0.4)
        assert same_detections(objects[0], want, float(np.abs(
            rows - ref)[..., 5:].max())), (objects[0], want)
    sv.close()
    return {"frames": len(frames), "wall_s": wall, "launches": launches,
            "points": "equal to process_frame bit for bit, every frame",
            "objects_per_frame": [len(o) for o in objects],
            "frame0_margin_ratio": margin,
            "frame0_objects_equal_to_cpu": margin > 1, "card": card}


def check_cli_detection(det, eng, cfg, weights, frames, outs, pts_dev, p,
                        tmp) -> dict:
    """cli.main with -o on the frames as PNGs, frame by frame and with
    --batch 8 over 11 frames (the sequence looped: a full group and a last
    group of 3, padded with its last frame as stream_batched pads its last
    batch); each frame's detection lines equal to those made from the
    card's detections of the same groups and phase 5's cloud."""
    kitti = write_kitti(os.path.join(tmp, "kitti"), frames)
    lefts = [lf for lf, _ in frames]
    n, nb = len(frames), 8 + 3
    runs = {}
    for name, extra, n_run, groups, batches in (
            ("o", [], n, [[i] for i in range(n)], n),
            ("o_batch_8", ["--batch", "8", "--frames", str(nb)], nb,
             [list(range(8)), list(range(8, nb)) + [nb - 1] * 5], 2)):
        argv = ["-k", kitti, "-w", str(W), "-ht", str(H), "-o", "-ycfg",
                cfg, "-yw", weights] + extra
        rc, lines, wall, launches = run_cli(argv)
        assert rc == 0, (name, rc)
        avg = check_frame_lines([l for l in lines if not l.startswith("  ")],
                                n_run, p.out_shape(W, H))
        expect = (per_frame_counts if "--batch" in extra
                  else cold_frame_counts)(p, batches)
        assert launches == expect, (name, launches)
        got = {}
        for line in lines:
            if line.startswith("(FPS="):
                got[len(got)] = []
            elif line.startswith("  "):
                got[len(got) - 1].append(line)
        want, means = {}, {}
        for g in groups:
            for i, d in zip(g, det.detect_batch([lefts[i % n] for i in g])):
                want[i] = detection_lines(eng, d, pts_dev[i % n])
                means[i] = finite_means(outs[i % n]["points"], d)
        assert got == want, (name, got, want)
        runs[name] = {"argv": " ".join(["-o"] + extra), "frames": n_run,
                      "AVG_FPS": avg, "wall_s": wall, "launches": launches,
                      "detection_lines_frame_0": got[0],
                      "finite_point_means_frame_0": means[0]}
    return runs


def time_object_positions(eng, points, card) -> dict:
    """object_positions (tree_sum_hw, the JAX sum's order) on a KITTI-size
    cloud on the card, 1 and 8 boxes, against one masked torch sum."""
    out = {}
    rng = np.random.default_rng(0)
    for nb in (1, 8):
        boxes = np.stack([rng.integers(0, W // 2, nb),
                          rng.integers(0, H // 2, nb),
                          rng.integers(W // 60, W // 6, nb),
                          rng.integers(H // 20, H // 4, nb)], axis=1)
        out["boxes_%d_ms" % nb] = event_ms(
            lambda: eng.object_positions(points, boxes))
        mask = torch.zeros((nb, H, W), device=points.device)
        out["plain_sum_boxes_%d_ms" % nb] = event_ms(
            lambda: (points.reshape(H, W, 3)[None]
                     * mask[..., None]).sum(dim=(1, 2)))
    out["card"] = card
    return out


def drive_detection(scenes, outs, calib, card) -> None:
    """Phase 8: detection and the C ABI on the frames of phase 5 (outs:
    its process_frame outputs at full resolution); prints its lines."""
    from stereovision_tpu_torch.engine import StereoEngine
    from stereovision_tpu_torch.models import yolo
    from stereovision_tpu_torch.params import app_params
    from stereovision_tpu_torch.synthetic import darknet_weights
    t = time.perf_counter()
    frames = [(lf, rf) for lf, rf, _ in scenes[1:]]
    lefts = [lf for lf, _ in frames]
    p = app_params()
    cfg = os.path.join(yolo.DATA_DIR, "yolov4-tiny.cfg")
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "synth.weights")
        darknet_weights(weights, yolo.parse_darknet_cfg(cfg), seed=0)
        det = yolo.YoloV4Tiny.from_files(cfg, weights)
        cpu = yolo.YoloV4Tiny.from_files(cfg, weights, device="cpu")
        print(json.dumps({"detection_rows": check_rows(det, cpu, lefts,
                                                       card)}), flush=True)
        print(json.dumps({"detection_times": forward_times(det, lefts,
                                                           card)}),
              flush=True)
        print(json.dumps({"stereo_vision": check_stereo_vision(
            cfg, weights, cpu, frames, outs, p, card)}), flush=True)
        pts_dev = [torch.from_numpy(o["points"]).cuda() for o in outs]
        with StereoEngine(calib, W, H) as eng:
            runs = check_cli_detection(det, eng, cfg, weights, frames, outs,
                                       pts_dev, p, tmp)
            print(json.dumps({"cli_detection": dict(runs=runs, card=card)}),
                  flush=True)
            print(json.dumps({"object_positions": time_object_positions(
                eng, pts_dev[0], card)}), flush=True)
        print(json.dumps({"capi": drive_capi(frames, outs, p, tmp, card)}),
              flush=True)
    print(json.dumps({"phase_8_s": time.perf_counter() - t, "card": card}),
          flush=True)


def capi_lib():
    """The C ABI's library, built and loaded with ctypes into this process
    (the join path), its functions declared."""
    import ctypes
    from stereovision_tpu_torch import capi
    lib = ctypes.CDLL(capi.library_path(), mode=ctypes.RTLD_GLOBAL)
    lib.generatePointCloud.restype = ctypes.c_void_p
    lib.generatePointCloud.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p]
        + [ctypes.c_int] * 2 + [ctypes.c_bool] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_char_p] * 3 + [ctypes.c_bool] * 2)
    lib.getColor.restype = ctypes.c_void_p
    lib.getColor.argtypes = []
    lib.clean.restype = None
    lib.clean.argtypes = []
    return lib


def drive_capi(frames, outs, p, tmp, card) -> dict:
    """The C ABI: loaded with ctypes into this process (the join path), 4
    frames from alternating new buffers, each cloud equal to phase 5's
    process_frame as float64 and getColor equal to the frame's left BGRA;
    then csrc/capi_example.c, built with gcc -ldl, in a subprocess on the
    card."""
    import ctypes
    from stereovision_tpu_torch import capi
    lib = capi_lib()
    torch.cuda.synchronize()
    zero_counts()
    frame_ms = []
    with contextlib.redirect_stdout(io.StringIO()):
        for k in range(4):
            lf, rf = frames[k]
            bgra = [np.ascontiguousarray(np.concatenate(
                [f, np.full((H, W, 1), 255, np.uint8)], axis=-1))
                for f in (lf, rf)]
            bufs = [ctypes.create_string_buffer(b.tobytes(), b.nbytes)
                    for b in bgra]
            t = time.perf_counter()
            addr = lib.generatePointCloud(
                ctypes.addressof(bufs[0]), ctypes.addressof(bufs[1]), b"", W,
                H, True, False, False, False, 1, 1, b"", b"", b"", False,
                False)
            frame_ms.append(1e3 * (time.perf_counter() - t))
            assert addr, "generatePointCloud returned NULL (frame %d)" % k
            pts = np.ctypeslib.as_array((ctypes.c_double * (H * W * 3))
                                        .from_address(addr)).reshape(-1, 3)
            assert np.array_equal(pts, outs[k]["points"].astype(np.float64))
            del bufs
            caddr = lib.getColor()
            assert caddr, "getColor returned NULL (frame %d)" % k
            colors = np.ctypeslib.as_array((ctypes.c_uint8 * (H * W * 4))
                                           .from_address(caddr))
            assert np.array_equal(colors.reshape(H, W, 4), bgra[0])
    launches = read_counts()
    lib.clean()
    assert launches == cold_frame_counts(p, 4), launches
    exe = os.path.join(tmp, "capi_example")
    subprocess.run(["gcc", os.path.join(REPO, "stereovision_tpu_torch",
                                        "csrc", "capi_example.c"), "-o",
                    exe, "-ldl", "-lm"], check=True, timeout=120)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        q for q in sys.path if q and os.path.isdir(q)))
    t = time.perf_counter()
    r = subprocess.run([exe, capi.library_path(), str(W), str(H)],
                       capture_output=True, text=True, timeout=300, env=env)
    wall = time.perf_counter() - t
    assert r.returncode == 0 and "CAPI OK" in r.stdout, (
        r.returncode, r.stdout[-2000:], r.stderr[-4000:])
    return {"ctypes_frames": 4, "frame_ms": frame_ms,
            "frame_ms_median_after_first": float(np.median(frame_ms[1:])),
            "launches": launches,
            "clouds": "equal to process_frame as float64, every frame",
            "get_color": "the left BGRA of each frame, new buffers",
            "plain_c_program": r.stdout.strip(), "plain_c_wall_s": wall,
            "card": card}


def sharded_mesh():
    """Phase 9's mesh: stream 2 x tile 2 over four GPUs where there are,
    else over cuda:0 four times."""
    from stereovision_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(4)] if n >= 4
            else [torch.device("cuda", 0)] * 4)
    return make_mesh(devices=devs, stream=2, tile=2)


def drive_sharded(scenes, outs, card, mode, p):
    """Phase 9 for one mode: ShardedStereoPipeline over the first 4
    frames of phase 5 (outs: its process_frame outputs), each cropped D1
    equal to phase 5's, padding rows -10, launch counts; frames/s; then
    the stripe launches against their plain versions and the unsplit
    launches (check_stripes).  Returns (result lines, launch counts)."""
    from stereovision_tpu_torch.engine import bgr_to_gray
    from stereovision_tpu_torch.ops.cuda import ccl_cu
    from stereovision_tpu_torch.parallel.shard import ShardedStereoPipeline
    mesh = sharded_mesh()
    B = SHARDED_BATCH
    L = np.stack([bgr_to_gray(lf) for lf, _, _ in scenes[1:B + 1]])
    R = np.stack([bgr_to_gray(rf) for _, rf, _ in scenes[1:B + 1]])
    with ShardedStereoPipeline(p, W, H, mesh) as pipe:
        pipe.run(L, R)                     # warm-up: the pool starts
        torch.cuda.synchronize()
        zero_counts()
        D1, D2 = pipe.run(L, R)
        torch.cuda.synchronize()
        launches = read_counts()
        merges = ccl_cu.merges
        Ho = pipe.Ho
        assert D1.shape == (B, Ho + pipe.pad_out, pipe.Wo), D1.shape
        assert bool((D1[:, Ho:] == -10).all()) and bool(
            (D2[:, Ho:] == -10).all()), "padding rows are not -10"
        for i in range(B):
            assert torch.equal(D1[i, :Ho], outs[i]["disparity"]), (
                "sharded frame %d differs from process_frame" % i)
        t = time.perf_counter()
        for _ in range(SHARDED_STEPS):
            pipe.run(L, R)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_s, n_t = mesh.shape["stream"], mesh.shape["tile"]
        # one launch a stripe: every stream group's 2 stripes (K1 two
        # passes); K3 on D1 only (postprocess_only_left), one merge a group
        expect = {"matching": 2 * n_s * n_t, "support": n_s * n_t,
                  "lr_check": n_s * n_t, "speckle_ccl": n_s * n_t}
        print(json.dumps({"sharded": {
            "mode": mode, "mesh": mesh.shape,
            "devices": [[str(d) for d in row] for row in mesh.devices],
            "batch": B, "pad_in": pipe.pad_in, "pad_out": pipe.pad_out,
            "padded_output": list(D1.shape), "steps": SHARDED_STEPS,
            "frames_per_s": SHARDED_STEPS * B / wall,
            "step_ms": 1e3 * wall / SHARDED_STEPS, "launches": launches,
            "speckle_ccl_merges": merges,
            "equal_to_process_frame": "every frame's D1 bit for bit, "
                                      "padding rows -10",
            "card": card}}), flush=True)
        assert launches == expect and merges == n_s, (launches, merges)
        results = check_stripes(pipe, mesh.group(0), L[:B // n_s],
                                R[:B // n_s], card, mode)
    return results, launches


def check_stripes(pipe, group, L, R, card, mode) -> dict:
    """Each kernel's sharded mode over one stream group (1 x tile) on its
    real inputs (the group's frames through the pipeline's padded
    engine): the stripe launches of K2, K1 (both passes) and K4, and K3
    banded, against the plain version and the unsplit launch, exact.  The
    bound counts each stripe's input rows once (K2's slabs overlap by a
    few rows; K1 reads one B-plane row an output row) and each output
    once."""
    from stereovision_tpu_torch.ops import matching, postprocess, support
    from stereovision_tpu_torch.ops.cuda import (ccl_cu, lr_cu,
                                                 matching_cu, support_cu)
    from stereovision_tpu_torch.parallel import ctx
    from stereovision_tpu_torch.transfer import upload
    e, p = pipe.engine, pipe.p
    dev = group.devices[0, 0]
    B = len(L)
    Ho, Wo, out_pad = pipe.Ho, pipe.Wo, pipe.pad_out

    def striped(fn):
        def run():
            with ctx.kernel_mesh(group):
                return fn()
        return run

    pairs = np.stack([pipe._pad_frames(L), pipe._pad_frames(R)], axis=1)
    desc1, desc2, d_can = striped(lambda: e.stage_support_batched(
        pairs, device=dev))()
    geo = e.unpack_geometry(upload(pipe._host_geometry_packed(
        d_can.cpu().numpy()), dev))
    (tid_l, pl_l, gm_l), (tid_r, pl_r, gm_r) = e.dense_inputs(*geo)
    maps_l = matching.plane_maps(tid_l, pl_l, p)
    maps_r = matching.plane_maps(tid_r, pl_r, p)

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0, 0, out_pad), value=-1)

    D1, D2 = striped(lambda: (
        matching_cu.compute_disparity(desc1, desc2, padded(tid_l), pl_l,
                                      gm_l, p, False, H, out_pad),
        matching_cu.compute_disparity(desc2, desc1, padded(tid_r), pl_r,
                                      gm_r, p, True, H, out_pad)))()
    L1, _ = striped(lambda: lr_cu.lr_consistency_check(D1, D2, p))()
    torch.cuda.synchronize()
    prior = matching_cu.prior_table(p, dev)
    with ctx.kernel_mesh(group):
        c_ranges = ctx.row_ranges(support.candidate_count(p, H))
        o_ranges = ctx.row_ranges(Ho)
        band = ctx.row_ranges(Ho + out_pad)[0][1]
    slabs = [support.slab_rows(p, H, lo, hi - lo) for lo, hi in c_ranges]
    support_bytes = B * sum(2 * 16 * (hi - lo) * W + 8 * (c1 - c0) * W * 4
                            for (lo, hi), (c0, c1) in zip(slabs, c_ranges))
    gw = gm_l.shape[-1]
    # as the unsplit bound: a stripe's output rows each read one row of
    # the A planes at the lattice's columns and one full row of the B
    # planes (row clip(s y, 2, H - 3): every s-th row of its slab), its
    # cell rows of the grid mask, four maps and the keys
    match_bytes = 0
    for y0, y1 in o_ranges:
        g0, g1 = matching.stripe_rows(p, H, y0, y1)[1]
        rows = y1 - y0
        match_bytes += (B * (rows * Wo * 16 + rows * W * 16
                             + p.disp_num * (g1 - g0) * gw
                             + 5 * rows * Wo * 4) + p.disp_num * 4)

    def candidates(maps, gm, right_image):
        return sum(n_candidates(p, [m[i] for m in maps], gm[i], right_image)
                   for i in range(B))

    Hp = Ho + out_pad
    checks = {
        "support": dict(
            kernel=striped(lambda: support_cu.support_scan(desc1, desc2, p,
                                                           H)),
            unsplit=lambda: support_cu.launch(desc1, desc2, p, H),
            plain=lambda: support.support_scan(desc1, desc2, p, H),
            nbytes=support_bytes, ops=B * support_ops(p)),
        "matching_left": dict(
            kernel=striped(lambda: matching_cu.match_keys(
                desc1, desc2, *maps_l, gm_l, p, False, H)),
            unsplit=lambda: matching_cu.launch(desc1, desc2, *maps_l, gm_l,
                                               prior, p, False, H),
            plain=lambda: matching.match_keys(desc1, desc2, *maps_l, gm_l,
                                              p, False, H),
            nbytes=match_bytes, ops=candidates(maps_l, gm_l, False) * 32),
        "matching_right": dict(
            kernel=striped(lambda: matching_cu.match_keys(
                desc2, desc1, *maps_r, gm_r, p, True, H)),
            unsplit=lambda: matching_cu.launch(desc2, desc1, *maps_r, gm_r,
                                               prior, p, True, H),
            plain=lambda: matching.match_keys(desc2, desc1, *maps_r, gm_r,
                                              p, True, H),
            nbytes=match_bytes, ops=candidates(maps_r, gm_r, True) * 32),
        "lr_check": dict(
            kernel=striped(lambda: lr_cu.lr_consistency_check(D1, D2, p)),
            unsplit=lambda: lr_cu.launch(D1, D2, p),
            plain=lambda: postprocess.lr_consistency_check(D1, D2, p),
            nbytes=B * 4 * Hp * Wo * 4, ops=B * 2 * Hp * Wo * 8),
        "speckle_ccl": dict(
            kernel=striped(lambda: ccl_cu.remove_small_segments(L1, p)),
            unsplit=lambda: ccl_cu.whole_frame(L1, p),
            plain=lambda: postprocess.remove_small_segments_banded(L1, p,
                                                                   band),
            nbytes=B * 2 * Hp * Wo * 4, ops=B * Hp * Wo * 16,
            # ~11 launches a call: 100 calls would fill the device's
            # queue of pending launches, and the host would wait for the
            # spin to end
            queue=BANDED_QUEUE),
    }
    return run_checks(checks, card, "%s, striped over %d, batch %d"
                      % (mode, group.shape["tile"], B), 3)


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def drive_launcher(card) -> None:
    """Phase 9's multi-process run: the launcher with two processes of two
    local devices (cuda:0 twice each) at 1242x375, meeting on a free port
    (two checkouts may run this at once); both must report 0 shard
    errors."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "launch.json")
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "stereovision_tpu_torch.parallel.launch",
             "--nproc", "2", "--local-devices", "2", "--width", str(W),
             "--height", str(H), "--steps", "2", "--port",
             str(free_port()), "--out", out],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        assert r.returncode == 0, (r.returncode, r.stdout[-4000:],
                                   r.stderr[-4000:])
        with open(out) as f:
            res = json.load(f)
    print(json.dumps({"launcher": {"processes": res, "wall_s": wall,
                                   "card": card}}), flush=True)
    assert len(res) == 2 and all(x["shard_errors"] == 0 for x in res), res


VIEWER_FRAMES = 4            # phase 10: frames of each viewer CLI run
RENDER_SIZE = (960, 540)     # the viewer's window
# the CUDA functions each kernel's wrapper launches on one frame
KERNEL_FUNCTIONS = {"matching": ["match_keys_kernel"],
                    "support": ["support_scan_kernel"],
                    "lr_check": ["lr_check_kernel"],
                    "speckle_ccl": ["ccl_local", "ccl_border", "ccl_count",
                                    "ccl_apply"]}


def recorded(path, img) -> bool:
    """Whether the window the viewer recorded at path is img: a PNG (cv2)
    holds it whole, a PGM its gray mean."""
    if path.endswith(".pgm"):
        from stereovision_tpu_torch.io.pgm import load_pgm
        return np.array_equal(load_pgm(path),
                              img.mean(axis=2).astype(np.uint8))
    import cv2
    return np.array_equal(cv2.imread(path), img)


@contextlib.contextmanager
def without_cv2(hide: bool):
    """`import cv2` fails inside the block when hide (the machine without
    cv2 that the port must run on)."""
    if not hide:
        yield
        return
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def check_viewer_cli(scenes, outs_by_mode, tmp, card) -> dict:
    """Phase 10's command lines on phase 5's frames: --view3d --record at
    full resolution (the viewer with cv2 hidden: PGMs), with -s 1 and
    with -o (cv2 as the machine has it), each recorded cloud equal to the CPU
    renderer's of phase 5's cloud of that frame (with the cubes the
    viewer was given), each disparity window to colorize_disparity of
    phase 5's dmap, launch counts those of phase 7; then the same frames
    with --view3d and no --record, and with no viewer, for contrast."""
    from stereovision_tpu_torch import viz_live
    from stereovision_tpu_torch.models import yolo
    from stereovision_tpu_torch.params import app_params
    from stereovision_tpu_torch.synthetic import darknet_weights
    from stereovision_tpu_torch.viz import colorize_disparity
    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        os.environ.pop(var, None)
    n = VIEWER_FRAMES
    kitti = write_kitti(os.path.join(tmp, "kitti"),
                        [(lf, rf) for lf, rf, _ in scenes[1:1 + n]])
    cfg = os.path.join(yolo.DATA_DIR, "yolov4-tiny.cfg")
    weights = os.path.join(tmp, "synth.weights")
    darknet_weights(weights, yolo.parse_darknet_cfg(cfg), seed=0)
    cpu = viz_live.PointCloudRenderer(*RENDER_SIZE, device="cpu")
    REC = object()               # the run's record directory in argv
    shown, hide_cv2 = [], [False]
    real_show = viz_live.LiveViewer.show

    def show(self, out, left, detections=(), fps=None, cubes=None):
        # the viewer without cv2 where the run asks (the engine keeps it:
        # its rectification takes cv2's where present, and the clouds are
        # phase 5's)
        shown.append(list(cubes or []))
        with without_cv2(hide_cv2[0]):
            return real_show(self, out, left, detections, fps=fps,
                             cubes=cubes)
    viz_live.LiveViewer.show = show
    runs = {}
    try:
        for name, extra, mode, hide in (
                ("view3d_record_no_cv2", ["--view3d", "--record", REC],
                 "full", True),
                ("view3d_record_subsampled", ["--view3d", "--record", REC,
                                              "-s", "1"], "subsampled",
                 False),
                ("view3d_record_detection", [
                    "--view3d", "--record", REC, "-o", "-ycfg", cfg, "-yw",
                    weights], "full", False),
                ("view3d", ["--view3d"], "full", False),
                ("no_viewer", [], "full", False)):
            rec = os.path.join(tmp, "rec_" + name)
            argv = ["-k", kitti, "-w", str(W), "-ht", str(H), "--frames",
                    str(n)] + [rec if a is REC else a for a in extra]
            shown.clear()
            hide_cv2[0] = hide
            rc, lines, wall, launches = run_cli(argv)
            assert rc == 0, (name, rc)
            assert "DISPLAY" not in os.environ
            p = app_params(subsampling=mode == "subsampled")
            avg = check_frame_lines(
                [l for l in lines if not l.startswith("  ")], n,
                p.out_shape(W, H))
            assert launches == cold_frame_counts(p, n), (name, launches)
            runs[name] = {"argv": " ".join(a for a in argv[6:]
                                           if not a.startswith(tmp)),
                          "frames": n, "AVG_FPS": avg, "wall_s": wall,
                          "frames_per_wall_s": n / wall,
                          "launches": launches}
            assert len(shown) == (n if extra else 0), (name, len(shown))
            if "--record" not in extra:
                continue
            files = sorted(os.listdir(rec))
            ext = "pgm" if hide else files[0].rsplit(".", 1)[-1]
            assert files == sorted(
                "%s_%06d.%s" % (w, i, ext) for i in range(n)
                for w in ("cloud", "detections", "disparity")), files
            cubes = 0
            with without_cv2(hide):
                for i, ref in enumerate(outs_by_mode[mode][:n]):
                    cloud = cpu.render(ref["points"], viz_live.Camera(),
                                       cubes=shown[i])
                    assert recorded(os.path.join(
                        rec, "cloud_%06d.%s" % (i, ext)), cloud), (name, i)
                    assert recorded(os.path.join(
                        rec, "disparity_%06d.%s" % (i, ext)),
                        colorize_disparity(ref["dmap"])), (name, i)
                    cubes += len(shown[i])
            assert (cubes > 0) == ("-o" in extra), (name, cubes)
            runs[name].update(files=len(files), format=ext, cubes=cubes)
    finally:
        viz_live.LiveViewer.show = real_show
    return runs


def time_renderer(outs, card) -> dict:
    """Phase 10's renderer alone: phase 5's KITTI cloud at 960x540 on the
    card (the cloud a tensor there, as fetch "dmap" leaves it; CUDA
    events, median of REPS calls, the image's fetch included) and on the
    CPU (the same cloud fetched; host clock, median of 3), point_px 1 and
    2, with and without rings; the two images equal bit for bit."""
    from stereovision_tpu_torch import viz_live
    pts = outs[0]["points"]
    dev = torch.from_numpy(pts).cuda().reshape(H, W, 3)
    cam = viz_live.Camera()
    rows = []
    for px in (1, 2):
        gpu = viz_live.PointCloudRenderer(*RENDER_SIZE, point_px=px)
        cpu = viz_live.PointCloudRenderer(*RENDER_SIZE, point_px=px,
                                          device="cpu")
        for rings in (True, False):
            got = gpu.render(dev, cam, draw_rings=rings)
            want = cpu.render(pts, cam, draw_rings=rings)
            assert np.array_equal(got, want), ("render", px, rings)
            cpu_s = []
            for _ in range(3):
                t = time.perf_counter()
                cpu.render(pts, cam, draw_rings=rings)
                cpu_s.append(time.perf_counter() - t)
            rows.append({"point_px": px, "rings": rings,
                         "card_ms": event_ms(
                             lambda: gpu.render(dev, cam, draw_rings=rings)),
                         "cpu_ms": 1e3 * float(np.median(cpu_s)),
                         "drawn_pixels": int((got != 12).any(axis=2).sum()),
                         "equal_to_cpu": "bit for bit"})
    return {"points": len(pts), "size": list(RENDER_SIZE), "runs": rows,
            "card": card}


def check_profiler(scenes, calib, tmp, card) -> dict:
    """Phase 10's profiler: profile_pipeline in both modes (best of 3),
    and device_trace around one process_frame, whose Chrome trace must
    name every kernel's CUDA functions."""
    from stereovision_tpu_torch.engine import StereoEngine
    from stereovision_tpu_torch.params import app_params
    from stereovision_tpu_torch.profiling import (device_trace,
                                                  profile_pipeline)
    lf, rf, _ = scenes[1]
    out = {}
    for mode, p in (("full", app_params()),
                    ("subsampled", app_params(subsampling=True))):
        with StereoEngine(calib, W, H, params=p) as eng:
            out[mode] = {k: 1e3 * v for k, v in
                         profile_pipeline(eng, lf, rf, n=3).items()}
            if mode == "full":
                with device_trace(os.path.join(tmp, "trace")) as path:
                    eng.process_frame(lf, rf)
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat", "").lower() == "kernel"}
    found = {k: [fn for fn in fns if any(fn in nm for nm in names)]
             for k, fns in KERNEL_FUNCTIONS.items()}
    assert found == KERNEL_FUNCTIONS, (found, sorted(names)[:40])
    return {"profile_pipeline_best_ms": out, "trace_kernels": found,
            "trace_bytes": os.path.getsize(path), "card": card}


def drive_viewer(scenes, outs_by_mode, calib, card) -> None:
    """Phase 10: the viewer and the profiler on the card."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            import cv2
            cv2_version = cv2.__version__
        except ImportError:
            cv2_version = None
        print(json.dumps({"viewer_cli": dict(runs=check_viewer_cli(
            scenes, outs_by_mode, tmp, card), cv2=cv2_version, card=card)}),
              flush=True)
        print(json.dumps({"renderer": time_renderer(outs_by_mode["full"],
                                                    card)}), flush=True)
        print(json.dumps({"profiler": check_profiler(scenes, calib, tmp,
                                                     card)}), flush=True)
    print(json.dumps({"phase_10_s": time.perf_counter() - t, "card": card}),
          flush=True)


ONE_DISPATCH_TURNS = ("eager", "graphs", "graphs", "eager")   # interleaved
# the kernel modes the one-dispatch paths replay inside their graphs
GRAPH_PATHS = {"": "ElasEngine.process_jit"}


def check_process_jit(elas, grays, card, mode) -> dict:
    """Phase 11's ElasEngine.process_jit for one mode: its graphs made at
    the first call (time, memory), then the frames with the launch counts
    zeroed just before and read just after, every D1 and D2 equal to eager
    process; frame ms of the two paths in interleaved turns, the host ms
    of each stage (graph replay or eager ops, to a synchronise), and a
    profile of two frames of each.  Returns the launch counts."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved()
    t = time.perf_counter()
    elas.process_jit(*grays[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    mem1 = torch.cuda.memory_reserved()
    stage_a, stage_b = elas.process_jit.graphs
    zero_counts()
    got = [elas.process_jit(*g) for g in grays]
    torch.cuda.synchronize()
    launches = read_counts()
    assert launches == per_frame_counts(elas.p, len(grays)), launches
    for i, (g, (D1, D2)) in enumerate(zip(grays, got)):
        E1, E2 = elas.process(*g)
        assert torch.equal(D1, E1) and torch.equal(D2, E2), (mode, i)

    paths = {"eager": elas.process, "graphs": elas.process_jit}
    frame_ms = {k: [] for k in paths}
    for name in ONE_DISPATCH_TURNS:
        for g in grays:
            t = time.perf_counter()
            paths[name](*g)
            torch.cuda.synchronize()
            frame_ms[name].append(1e3 * (time.perf_counter() - t))
    stage_ms = {k: [] for k in ("graph_a", "eager_a", "graph_b", "eager_b")}
    for g in grays[:3]:
        t0 = time.perf_counter()
        d1, d2, dc = stage_a(*g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        buf = elas.pack_geometry(elas.host_mid(dc.cpu().numpy()))
        t2 = time.perf_counter()
        stage_b(d1, d2, buf)              # the geometry's copy included
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        e1, e2, edc = elas.stage_support(*g)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        geo = elas.host_mid(edc.cpu().numpy())
        t5 = time.perf_counter()
        elas.stage_dense(e1, e2, *elas.upload_geometry(geo))
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for k, dt in zip(stage_ms, (t1 - t0, t4 - t3, t3 - t2, t6 - t5)):
            stage_ms[k].append(1e3 * dt)
    profiles = {k: profile(lambda: [paths[k](*g) for g in grays[:2]])
                for k in paths}
    print(json.dumps({"process_jit": {
        "mode": mode, "frames": len(grays), "launches": launches,
        "equal_to_process": "every frame, D1 and D2 bit for bit",
        "build_s": build_s,
        "capture_s": {"stage_a": stage_a.capture_s,
                      "stage_b": stage_b.capture_s},
        "memory_reserved_bytes": {"before": mem0, "after": mem1},
        "turns": list(ONE_DISPATCH_TURNS),
        "frame_ms_median": {k: float(np.median(v))
                            for k, v in frame_ms.items()},
        "frame_ms": frame_ms,
        "stage_ms_median": {k: float(np.median(v))
                            for k, v in stage_ms.items()},
        "profile_2_frames": profiles, "card": card}}), flush=True)
    return launches


def drive_one_dispatch(scenes, calib, card) -> dict:
    """Phase 11: the one-dispatch mode in both modes, on phase 5's frames.
    Returns process_jit's launch counts by mode."""
    from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
    from stereovision_tpu_torch.params import app_params
    t = time.perf_counter()
    grays = [(bgr_to_gray(lf), bgr_to_gray(rf)) for lf, rf, _ in scenes[1:]]
    launches = {}
    for mode, p in (("full", app_params()),
                    ("subsampled", app_params(subsampling=True))):
        with StereoEngine(calib, W, H, params=p) as eng:
            launches[mode] = check_process_jit(eng.elas, grays, card, mode)
    print(json.dumps({"phase_11_s": time.perf_counter() - t, "card": card}),
          flush=True)
    return launches


# phase 12's sharded meshes (stream 1 x tile t on cuda:0): every case on
# tile 2, stripes of 12-32 rows, none padded; on tile 5 (stripes of 5-13
# rows, every frame padded) the two cases whose padding differs: 64 rows
# over a 32-row half lattice (3 output rows padded, K2's last stripe
# empty) and the 32x24 frame under D = 256 (5-row stripes)
PADDED_CASES = ("flat_app_subsampled", "tiny_app")


def since(t: float) -> float:
    """Host milliseconds since perf_counter() gave t."""
    return 1e3 * (time.perf_counter() - t)


def check_degenerate(name, p, L, R, card) -> None:
    """Phase 12 for one frame of synthetic.degenerate_frames: the pair and
    the pair swapped, each path's D1 and D2 equal to the port's on the CPU
    bit for bit, the launch counts (zeroed just before each path, read
    just after) those of the path; prints one line with the host ms of
    each path to a synchronise and of its set-up (the CPU reference, the
    engines, process_jit's graphs, each pipeline's pool start, warm-up
    and close)."""
    from stereovision_tpu_torch.models.elas import ElasEngine
    from stereovision_tpu_torch.ops.cuda import ccl_cu
    from stereovision_tpu_torch.ops.support import candidate_count
    from stereovision_tpu_torch.parallel import ctx
    from stereovision_tpu_torch.parallel.mesh import make_mesh
    from stereovision_tpu_torch.parallel.shard import ShardedStereoPipeline
    from stereovision_tpu_torch.transfer import upload
    h, w = L.shape
    frames = [(L, R), (R, L)]
    t = time.perf_counter()
    cpu = ElasEngine(p, w, h, device="cpu")
    refs = [cpu.process(*f) for f in frames]
    g = cpu.host_mid(cpu.stage_support(L, R)[2].numpy())
    n_k3 = 1 if p.postprocess_only_left else 2
    host_ms, launches = {}, {}
    setup_ms = {"cpu_reference": since(t)}

    def run(path, fn):
        torch.cuda.synchronize()
        zero_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms[path] = since(t)
        launches[path] = read_counts()
        return out

    def same(got, i, path):
        for k in range(2):
            assert torch.equal(got[k].cpu(), refs[i][k]), (
                "%s: %s D%d of frame %d differs from the CPU's"
                % (name, path, k + 1, i))

    t = time.perf_counter()
    with ElasEngine(p, w, h) as eng:
        setup_ms["engine"] = since(t)
        same(run("process", lambda: eng.process(L, R)), 0, "process")
        t = time.perf_counter()
        eng.process_jit(L, R)
        torch.cuda.synchronize()
        setup_ms["process_jit_graphs"] = since(t)
        assert all(x.graph is not None for x in eng.process_jit.graphs)
        for i, got in enumerate(run("process_jit", lambda: [
                eng.process_jit(*f) for f in frames])):
            same(got, i, "process_jit")

        def batched():
            desc1, desc2, d_can = eng.stage_support_batched(
                np.stack([np.stack(f) for f in frames]))
            buf = np.stack([eng.pack_geometry(eng.host_mid(x))
                            for x in d_can.cpu().numpy()])
            return eng.stage_dense_batched(desc1, desc2,
                                           upload(buf, eng.device))

        D1, D2 = run("batched", batched)
        for i in range(2):
            same((D1[i], D2[i]), i, "batched")
        t = time.perf_counter()
    setup_ms["engine_close"] = since(t)
    expect = {"process": per_frame_counts(p, 1),
              "process_jit": per_frame_counts(p, 2),
              "batched": per_frame_counts(p, 1)}
    lr = (np.stack([L, R]), np.stack([R, L]))
    merges, pads = {}, {}
    for tile in (2, 5) if name in PADDED_CASES else (2,):
        path = "sharded_1x%d" % tile
        mesh = make_mesh(devices=[torch.device("cuda", 0)] * tile, stream=1,
                         tile=tile)
        t = time.perf_counter()
        with ShardedStereoPipeline(p, w, h, mesh) as pipe:
            setup_ms[path + "_pipeline"] = since(t)
            # the two spawned workers that the batch of 2 maps onto
            t = time.perf_counter()
            list(pipe.engine.host_pool().map(abs, range(2)))
            setup_ms[path + "_pool_start"] = since(t)
            t = time.perf_counter()
            pipe.run(*lr)
            torch.cuda.synchronize()
            setup_ms[path + "_warmup"] = since(t)
            D1, D2 = run(path, lambda: pipe.run(*lr))
            merges[path] = ccl_cu.merges
            pads[path] = [pipe.pad_in, pipe.pad_out]
            Ho = pipe.Ho
            assert bool((D1[:, Ho:] == -10).all()), (name, path)
            for i in range(2):
                same((D1[i, :Ho], D2[i, :Ho]), i, path)
            with ctx.kernel_mesh(mesh.group(0)):
                k2 = ctx.row_ranges(candidate_count(p, h))
            t = time.perf_counter()
        setup_ms[path + "_close"] = since(t)
        # one launch a stripe (K1 two passes; K3 on D2 too unless
        # postprocess_only_left), one K3 merge a map; K2 skips a stripe
        # that holds no candidate row
        expect[path] = {"matching": 2 * tile,
                        "support": sum(a < b for a, b in k2),
                        "lr_check": tile, "speckle_ccl": tile * n_k3}
    print(json.dumps({"degenerate": {
        "case": name, "width": w, "height": h, "disp_max": p.disp_max,
        "subsampling": p.subsampling,
        "support_points": int((g["pts"][:, 0] >= 0).sum()),
        "triangles": [int((g["tris_" + t][:, 0] >= 0).sum())
                      for t in ("l", "r")],
        "d1_valid_share": float((refs[0][0] >= 0).float().mean()),
        "host_ms": host_ms, "setup_ms": setup_ms,
        "launches": launches, "speckle_ccl_merges": merges,
        "pad_in_out": pads,
        "equal_to_cpu": "D1 and D2 of both frames bit for bit, every path",
        "card": card}}), flush=True)
    for path in expect:
        assert launches[path] == expect[path], (name, path, launches[path])
    for path in merges:
        assert merges[path] == n_k3, (name, path, merges[path])


@contextlib.contextmanager
def without_host_lib():
    """hostlib.raster as on a host where the native library cannot be
    built: get_lib() gives None, so the host middle runs on NumPy."""
    from stereovision_tpu_torch.hostlib import raster
    real = raster.get_lib
    raster.get_lib = lambda: None
    try:
        yield
    finally:
        raster.get_lib = real


def compare_host_fallbacks(scenes, card) -> None:
    """Phase 12's host library against its NumPy fallbacks on one KITTI
    support grid of phase 5 (app_params()): the sequential filters (equal
    required) and the rasterizer (a reading: the native one may contract
    a * u + b into a fused multiply-add, NumPy rounds twice), host ms of
    each, the triangle-id pixels, span-code bytes and D1 pixels in which
    the two rasterizers' results differ."""
    from stereovision_tpu_torch.engine import bgr_to_gray
    from stereovision_tpu_torch.hostlib import geometry, raster
    from stereovision_tpu_torch.models.elas import ElasEngine
    from stereovision_tpu_torch.params import app_params
    p = app_params()
    I1, I2 = (bgr_to_gray(x) for x in scenes[1][:2])
    eng = ElasEngine(p, W, H)
    dc = eng.stage_support(I1, I2)[2].cpu().numpy()
    ms = {}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        ms[key] = since(t)
        return out

    native_f = timed("filters_native",
                     lambda: raster.filter_support_sequential(dc, p))
    numpy_f = timed("filters_numpy", lambda: raster._filter_support_np(
        np.array(dc, np.int16), p))
    assert np.array_equal(native_f, numpy_f), "the NumPy filters differ"
    g = geometry.host_geometry(native_f, p, W, H, raster.rasterize,
                               n_cap=eng.n_max)
    pixels = {}
    for right, tag in ((False, "l"), (True, "r")):
        args = (g["pts"], g["tris_" + tag], right, W, H)
        a = timed("rasterize_native_" + tag, lambda: raster.rasterize(*args))
        b = timed("rasterize_numpy_" + tag,
                  lambda: raster.rasterize_tri_ids(*args))
        pixels[tag] = int((a != b).sum())
    native_g, native_d1 = eng.host_mid(dc), eng.process(I1, I2)[0]
    with without_host_lib():
        numpy_g, numpy_d1 = eng.host_mid(dc), eng.process(I1, I2)[0]
    span = {k: int((native_g[k] != numpy_g[k]).sum())
            for k in ("tri_l", "tri_r")}
    d1 = int((native_d1 != numpy_d1).sum())
    print(json.dumps({"host_fallbacks": {
        "grid": list(dc.shape), "support_points": int(len(g["pts"])),
        "triangles": [int(len(g["tris_l"])), int(len(g["tris_r"]))],
        "filters_equal": True, "host_ms": ms,
        "tri_id_pixels_differ": pixels, "span_bytes_differ": span,
        "d1_pixels_differ": d1, "card": card}}), flush=True)


def drive_degenerate(scenes, card) -> None:
    """Phase 12: the degenerate frames on the card through K1-K4, eager,
    batched, striped and graph-replayed; the host library's fallbacks."""
    from stereovision_tpu_torch.synthetic import degenerate_frames
    t = time.perf_counter()
    for name, (p, L, R) in degenerate_frames().items():
        check_degenerate(name, p, L, R, card)
    t1 = time.perf_counter()
    compare_host_fallbacks(scenes, card)
    print(json.dumps({"phase_12_s": time.perf_counter() - t,
                      "degenerate_s": t1 - t,
                      "host_fallbacks_s": time.perf_counter() - t1,
                      "card": card}), flush=True)


# phase 13: the scales of the reference's grid whose stream_batched runs
# the host middle in the spawn pool (a pool's start costs ~2 s); the rest
# run it on threads.  0.5 and 0.6 are the largest frames, 0.5 and 2.1 the
# TPU's fault shapes (docs/KNOWN_ISSUES.md), 1.3 an odd width, 3.0 the
# smallest frame.
SCALE_POOL = (0.5, 0.6, 1.3, 2.1, 3.0)
# ... those held against the port on the CPU: the largest frames and the
# TPU's fault shapes, which the CPU tests cannot afford or do not run.  One
# spawned worker computes them, largest first, while the card works through
# the grid (serially they took ~35 s of the phase)
SCALE_CPU = ((0.5, False), (0.5, True), (2.1, True), (3.0, False))
SCALE_CPU_THREADS = 4        # ... its intra-op threads, of the 8 cores
SCALE_BATCHES = 2            # stream_batched: timed batches after a warm-up
SCALE_CLI = ((0.5, False), (3.0, True))   # cli.main's -f (and -s 1)
SCALE_CLI_FRAMES = 4
SCALE_CAPI = 2               # the C ABI's scale (an int there)


def check_scale(scale, sub, pairs, calib, card):
    """Phase 13 for one (scale, subsampling): StereoEngine at the scale's
    frame size with the intrinsics divided by the scale; the pairs (1242x375)
    resized as io/kitti.py resizes them; process_frame (graph replays on
    the card) after a warm-up, ElasEngine.process_jit (graphs made at that
    size), and stream_batched at the sweep's batch (SCALE_BATCHES batches
    after one of warm-up), each with the launch counts zeroed just before
    and read just after; every process_jit D1 and D2 equal to eager
    process's, and every streamed frame's dmap and points to its
    process_frame's, bit for bit.  Prints one line; returns frame 0's
    process_frame output, its disparity on the host."""
    from stereovision_tpu_torch import scales
    from stereovision_tpu_torch.engine import StereoEngine, bgr_to_gray
    from stereovision_tpu_torch.io.kitti import _resize
    from stereovision_tpu_torch.params import app_params
    w, h = scales.frame_size(scale)
    B = scales.sweep_batch(w, h, sub)
    p = app_params(subsampling=sub)
    workers = "process" if scale in SCALE_POOL else "thread"
    frames = [tuple(_resize(f, w, h) for f in pair) for pair in pairs]
    n = len(frames)
    line = {"scale": scale, "subsampling": sub, "size": "%dx%d" % (w, h),
            "out_shape": list(p.out_shape(w, h)), "batch": B,
            "host_workers": workers}
    launches, expect = {}, {}

    def counted(path, fn, count):
        torch.cuda.synchronize()
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[path] = read_counts()
        expect[path] = per_frame_counts(p, count)
        return out

    t = time.perf_counter()
    with StereoEngine(calib, w, h, scale=scale, params=p) as eng:
        line["setup_ms"] = {"engine": since(t)}
        elas = eng.elas
        eng.process_frame(*frames[0])
        frame_ms = []

        def eager():
            outs = []
            for f in frames:
                t = time.perf_counter()
                outs.append(eng.process_frame(*f))
                frame_ms.append(since(t))
            return outs

        outs = counted("process_frame", eager, n)
        for out in outs:
            assert out["dmap"].shape == tuple(line["out_shape"])
            assert out["points"].shape == (w * h, 3)
        pts = outs[0]["points"].reshape(h, w, 3)
        step = 2 if sub else 1
        Ho, Wo = line["out_shape"]
        assert np.isfinite(pts[::step, ::step][:Ho, :Wo][
            outs[0]["dmap"] > 0]).all()

        grays = [(bgr_to_gray(a), bgr_to_gray(b)) for a, b in frames]
        t = time.perf_counter()
        elas.process_jit(*grays[0])
        torch.cuda.synchronize()
        line["setup_ms"]["process_jit_graphs"] = since(t)
        assert all(g.graph is not None for g in elas.process_jit.graphs)
        jit_ms = []

        def replays():
            got = []
            for g in grays:
                t = time.perf_counter()
                got.append(elas.process_jit(*g))
                torch.cuda.synchronize()
                jit_ms.append(since(t))
            return got

        for i, (g, (D1, D2)) in enumerate(zip(
                grays, counted("process_jit", replays, n))):
            E1, E2 = elas.process(*g)
            assert torch.equal(D1, E1) and torch.equal(D2, E2), (
                scale, sub, "process_jit", i)
            assert torch.equal(D1, outs[i]["disparity"]), (scale, sub, i)

        run = dict(batch=B, fetch="host", pipeline_depth=3,
                   host_workers=workers)

        def seq(k):
            return (frames[i % n] for i in range(k))

        t = time.perf_counter()
        assert len(list(eng.stream_batched(seq(B), **run))) == B
        line["setup_ms"]["stream_batched_warmup"] = since(t)
        t = time.perf_counter()
        got = counted("stream_batched", lambda: list(eng.stream_batched(
            seq(SCALE_BATCHES * B), **run)), SCALE_BATCHES)
        wall = time.perf_counter() - t
        assert eng.host_mode == workers, eng.host_mode
        assert (elas._host_pool is not None) == (workers == "process")
        assert len(got) == SCALE_BATCHES * B
        for i, out in enumerate(got):
            ref = outs[i % n]
            assert np.array_equal(out["dmap"], ref["dmap"]), (scale, sub, i)
            assert np.array_equal(out["points"], ref["points"]), (
                scale, sub, i)
        line["memory_reserved_bytes"] = torch.cuda.memory_reserved()
        t = time.perf_counter()
    line["setup_ms"]["engine_close"] = since(t)
    # the next size's blocks differ: give this one's back to the card
    torch.cuda.empty_cache()
    line.update(
        process_frame_ms=frame_ms,
        process_frame_ms_median=float(np.median(frame_ms)),
        process_jit_ms=jit_ms,
        process_jit_ms_median=float(np.median(jit_ms)),
        stream_batched_frames_per_s=SCALE_BATCHES * B / wall,
        stream_batched_s=wall,
        d1_valid_share=float((outs[0]["disparity"] >= 0).float().mean()),
        launches=launches,
        equal_to_eager=("process_jit: D1 and D2 of every frame; "
                        "stream_batched: dmap and points of every frame"),
        card=card)
    print(json.dumps({"scale": line}), flush=True)
    for path in expect:
        assert launches[path] == expect[path], (scale, sub, path,
                                                launches[path])
    return dict(outs[0], disparity=outs[0]["disparity"].cpu())


def cpu_scale_reference(calib, scale, sub, pair) -> dict:
    """Phase 13's CPU reference, in a spawned worker while the card works
    through the grid: process_frame of the pair (1242x375) resized to the
    scale's size, on the port with device="cpu", and its seconds."""
    import torch
    from stereovision_tpu_torch import scales
    from stereovision_tpu_torch.engine import StereoEngine
    from stereovision_tpu_torch.io.kitti import _resize
    from stereovision_tpu_torch.params import app_params
    torch.set_num_threads(SCALE_CPU_THREADS)
    w, h = scales.frame_size(scale)
    t = time.perf_counter()
    with StereoEngine(calib, w, h, scale=scale,
                      params=app_params(subsampling=sub), device="cpu") as eng:
        ref = eng.process_frame(*(_resize(f, w, h) for f in pair))
    return {"disparity": ref["disparity"].numpy(), "dmap": ref["dmap"],
            "points": ref["points"], "s": time.perf_counter() - t}


def check_scale_cli(scenes, calib, card) -> dict:
    """Phase 13's command line: cli.main with -f (and -s 1) on
    SCALE_CLI_FRAMES of phase 5's frames written as 1242x375 PNGs, every
    dumped frame's dmap and points equal to process_frame of the frame as
    the CLI reads it, at the scale's size; launches asserted."""
    from stereovision_tpu_torch import scales
    from stereovision_tpu_torch.engine import StereoEngine
    from stereovision_tpu_torch.io.kitti import KittiRawSequence
    from stereovision_tpu_torch.params import app_params
    n = SCALE_CLI_FRAMES
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        kitti = write_kitti(os.path.join(tmp, "kitti"),
                            [(lf, rf) for lf, rf, _ in scenes[1:n + 1]])
        for scale, sub in SCALE_CLI:
            w, h = scales.frame_size(scale)
            p = app_params(subsampling=sub)
            out_dir = os.path.join(tmp, "f%s_s%d" % (scale, sub))
            argv = ["-k", kitti, "-f", str(scale), "-s", str(int(sub)),
                    "--dump", "npz", "--out_dir", out_dir]
            rc, lines, wall, launches = run_cli(argv)
            assert rc == 0, (scale, sub, rc)
            avg = check_frame_lines(lines, n, p.out_shape(w, h))
            assert launches == cold_frame_counts(p, n), launches
            seq = KittiRawSequence(kitti, width=w, height=h)
            with StereoEngine(calib, w, h, scale=scale, params=p) as eng:
                for i in range(n):
                    ref = eng.process_frame(*seq[i])
                    got = np.load(os.path.join(out_dir,
                                               "frame_%06d.npz" % i))
                    assert np.array_equal(got["dmap"], ref["dmap"]), (
                        scale, sub, i)
                    assert np.array_equal(got["points"], ref["points"]), (
                        scale, sub, i)
            runs["-f %s -s %d" % (scale, sub)] = {
                "size": "%dx%d" % (w, h), "frames": n, "AVG_FPS": avg,
                "wall_s": wall, "launches": launches}
    return runs


def check_scale_capi(pair, ref_points) -> dict:
    """Phase 13's C ABI: generatePointCloud at scale SCALE_CAPI (the frame
    resized to that scale's size, BGRA), its cloud equal to process_frame's
    (ref_points) as float64; launches asserted."""
    import ctypes
    from stereovision_tpu_torch import scales
    from stereovision_tpu_torch.io.kitti import _resize
    from stereovision_tpu_torch.params import app_params
    w, h = scales.frame_size(SCALE_CAPI)
    bgra = [np.ascontiguousarray(np.concatenate(
        [_resize(f, w, h), np.full((h, w, 1), 255, np.uint8)], axis=-1))
        for f in pair]
    lib = capi_lib()
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        addr = lib.generatePointCloud(
            bgra[0].ctypes.data, bgra[1].ctypes.data, b"", w, h, True, False,
            False, False, SCALE_CAPI, 1, b"", b"", b"", False, False)
    ms = since(t)
    assert addr, "generatePointCloud returned NULL at scale %d" % SCALE_CAPI
    pts = np.array(np.ctypeslib.as_array((ctypes.c_double * (h * w * 3))
                                         .from_address(addr)))
    launches = read_counts()
    lib.clean()
    assert np.array_equal(pts.reshape(-1, 3),
                          ref_points.astype(np.float64)), "C ABI cloud"
    assert launches == cold_frame_counts(app_params(), 1), launches
    return {"scale": SCALE_CAPI, "size": "%dx%d" % (w, h), "frame_ms": ms,
            "launches": launches,
            "cloud": "equal to process_frame's as float64"}


def drive_scales(scenes, calib, card) -> None:
    """Phase 13: the reference's scale grid (52 pairs of scale and
    subsampling) through process_frame, process_jit and stream_batched on
    the card; the CLI's -f and the C ABI's scale."""
    import concurrent.futures
    import multiprocessing
    from stereovision_tpu_torch import scales
    t = time.perf_counter()
    pairs = [(lf, rf) for lf, rf, _ in scenes[1:3]]
    capi_ref, card_outs = None, {}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as cpu:
        try:
            refs = {key: cpu.submit(cpu_scale_reference, calib, *key,
                                    pairs[0]) for key in SCALE_CPU}
            for scale in scales.SCALES:
                for sub in (False, True):
                    out = check_scale(scale, sub, pairs, calib, card)
                    if (scale, sub) in SCALE_CPU:
                        card_outs[scale, sub] = out
                    if (scale, sub) == (float(SCALE_CAPI), False):
                        capi_ref = out["points"]
            t1 = time.perf_counter()
            cli_runs = check_scale_cli(scenes, calib, card)
            capi_run = check_scale_capi(pairs[0], capi_ref)
            t2 = time.perf_counter()
            cpu_lines = []
            for (scale, sub), fut in refs.items():
                ref, out = fut.result(), card_outs[scale, sub]
                assert np.array_equal(out["disparity"].numpy(),
                                      ref["disparity"]), (
                    scale, sub, "D1 differs from the CPU's")
                assert np.array_equal(out["dmap"], ref["dmap"]), (scale, sub)
                assert np.array_equal(out["points"], ref["points"]), (
                    scale, sub)
                cpu_lines.append({
                    "scale": scale, "subsampling": sub,
                    "cpu_reference_s": ref["s"],
                    "equal_to_cpu": "frame 0: D1, dmap and points bit for "
                                    "bit"})
        finally:
            cpu.shutdown(cancel_futures=True)
    print(json.dumps({"scales_cpu": cpu_lines, "cpu_threads":
                      SCALE_CPU_THREADS, "wait_after_card_s":
                      time.perf_counter() - t2}), flush=True)
    print(json.dumps({"scales_cli_capi": {"cli": cli_runs, "capi": capi_run,
                                          "card": card}}), flush=True)
    print(json.dumps({"phase_13_s": time.perf_counter() - t,
                      "grid_s": t1 - t, "cli_capi_s": t2 - t1,
                      "process_pool_scales": list(SCALE_POOL),
                      "thread_scales": "the rest",
                      "memory_reserved_bytes": torch.cuda.memory_reserved(),
                      "card": card}), flush=True)


def kernel_rows(results, launches, suffix, striped=False) -> list:
    """The `kernels` line's rows of one mode; the matching row averages
    the left and right passes.  striped: phase 9's sharded modes (K1, K2,
    K4 in row stripes, K3 banded), which replace the Pallas kernels'
    sharded modes."""
    rows = []
    for name in ("matching", "support", "lr_check", "speckle_ccl"):
        if name == "matching":
            a, b = results["matching_left"], results["matching_right"]
            r = {k: (a[k] + b[k]) / 2 for k in ("ms", "plain_ms", "bound_ms")}
            r.update(max_abs_err=max(a["max_abs_err"], b["max_abs_err"]),
                     bound_by=a["bound_by"])
        else:
            r = results[name]
        source, replaces = SOURCES[name]
        tag = ("_banded" if name == "speckle_ccl" else "_striped") \
            if striped else ""
        rows.append({"name": name + tag + suffix, "route": "cuda",
                     "source": source,
                     "replaces": STRIPED[name] if striped else replaces,
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
        if name in REDESIGNED:
            rows[-1]["redesigned"] = REDESIGNED[name]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stereovision_tpu_torch.engine import StereoEngine
    from stereovision_tpu_torch.hostlib import raster
    from stereovision_tpu_torch.ops.cuda import _lib
    from stereovision_tpu_torch.params import app_params
    from stereovision_tpu_torch.synthetic import stereo_pair

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print("card:", card, "| torch:", kind, "| torch", torch.__version__,
          "cuda", torch.version.cuda, flush=True)

    # 2. build
    t0 = time.perf_counter()
    host = raster.get_lib()
    t1 = time.perf_counter()
    kernels = _lib.kernels()
    t2 = time.perf_counter()
    assert host is not None and kernels is not None
    print(json.dumps({"build": {"host_lib_s": t1 - t0, "cuda_kernels_s":
                                t2 - t1, "host_lib": host._name,
                                "kernels": kernels._name}}), flush=True)
    print(json.dumps({"floor": dict(kernel="empty_kernel (csrc/floor.cu)",
                                    **launch_times(_lib.empty, "floor"),
                                    card=card)}),
          flush=True)

    # 3. scene
    calib = os.path.join(REPO, "stereovision_tpu_torch", "data",
                         "kitti_2011_09_26.yml")
    left, right, _ = stereo_pair(W, H, seed=0)
    scenes = [stereo_pair(W, H, seed=s) for s in range(1, FRAMES + 2)]

    # 4-6. each mode: kernels against their plain versions, the main
    # path, the kernels' batched modes, the streaming paths
    rows, outs_by_mode = [], {}
    for mode, suffix, p in (("full", "", app_params()),
                            ("subsampled", "_subsampled",
                             app_params(subsampling=True))):
        with StereoEngine(calib, W, H, params=p) as eng:
            results = check_kernels(eng, p, [(left, right)], card, mode)
            launches, outs = drive_main_path(eng, calib, scenes, card, mode)
            B = BATCH[mode]
            batched = check_kernels(
                eng, p, [(lf, rf) for lf, rf, _ in scenes[:B]], card,
                "%s, batch %d" % (mode, B))
            launches_b = drive_streams(eng, scenes, outs, card, mode)
        rows += kernel_rows(results, launches, suffix)
        rows += kernel_rows(batched, launches_b, "_batched" + suffix)
        outs_by_mode[mode] = outs

    # 7. the command line
    drive_cli(scenes, outs_by_mode, card)

    # 8. detection and the C ABI
    drive_detection(scenes, outs_by_mode["full"], calib, card)

    # 9. multi-device: the sharded pipeline in both modes, the launcher
    t = time.perf_counter()
    for mode, suffix, p in (("full", "", app_params()),
                            ("subsampled", "_subsampled",
                             app_params(subsampling=True))):
        striped, launches_s = drive_sharded(scenes, outs_by_mode[mode], card,
                                            mode, p)
        rows += kernel_rows(striped, launches_s, suffix, striped=True)
    drive_launcher(card)
    print(json.dumps({"phase_9_s": time.perf_counter() - t, "card": card}),
          flush=True)

    # 10. the viewer and the profiler
    drive_viewer(scenes, outs_by_mode, calib, card)

    # 11. the one-dispatch mode: the stages as CUDA graph replays
    graph_launches = drive_one_dispatch(scenes, calib, card)
    for row in rows:
        name = next(k for k in SOURCES if row["name"].startswith(k))
        rest = row["name"][len(name):]
        variant = rest.removesuffix("_subsampled")
        mode = ("subsampled" if rest.endswith("_subsampled") else "full") \
            + variant
        row["graph_replays"] = ({GRAPH_PATHS[variant]:
                                 graph_launches[mode][name]}
                                if variant in GRAPH_PATHS else {})

    # 12. the degenerate frames, the host library's fallbacks
    drive_degenerate(scenes, card)

    # 13. the reference's scale grid
    drive_scales(scenes, calib, card)

    # 14. summary lines
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
