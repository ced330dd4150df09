"""Command-line interface mirroring the reference's flags (counterpart of
stereovision_tpu/cli.py, flag for flag).

Reference surfaces: the Python argparse CLI (stereo_vision/sv.py:195-331)
and the native popt CLI (src/serial_includes/main/stereo_vision.cpp:757-788).
Per-frame output lines use the reference's printf format
"(FPS=...) (rows, cols) (t_t=..., dmap_t=..., pc_t=...)" and the final
"AVG_FPS=..." line (stereo_vision.cpp:682-686) so the reference's log
parser (test.py) works unchanged.

The engines run on the card; main(argv, device="cpu") runs them on the CPU
(the keyword is not a command-line flag).  -o detects on every left frame
(YOLOv4-tiny, -ycfg / -yw / -ycl) on a thread of its own, tracks the boxes
and prints each detection's mean 3-D position.  -g, --view3d and --record
feed every frame, with its detections and their cubes, to a LiveViewer
(viz_live.py): the cloud is rendered where it lies (on the card unless a
dump fetched it), windows open only where a display is found, and
--record spools the rendered frames to a directory.

Run: python -m stereovision_tpu_torch --kitti /path/to/kitti_mini
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

import numpy as np

from .device import resolve_device
from .engine import DEFAULT_CALIB, StereoEngine, frame_line

PROG = "stereovision_tpu_torch"
_PKG_DIR = osp.dirname(osp.abspath(__file__))
# -P without --profile_dir: the reference's golden pairs, where a checkout
# of the repository holds them
DEFAULT_PROFILE_DIR = osp.join(osp.dirname(_PKG_DIR), "datasets", "profile")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="Stereo disparity + 3D depth perception on an NVIDIA "
                    "GPU (PyTorch/CUDA)")
    ap.add_argument("-k", "--kitti", type=str, default=None,
                    help="Path to a KITTI raw-layout directory "
                         "(image_02/data + image_03/data)")
    ap.add_argument("-s", "--subsampling", type=int, default=0,
                    help="1 = evaluate every second pixel")
    ap.add_argument("-f", "--scale", type=float, default=1.0,
                    help="Shrink factor applied to the input images")
    ap.add_argument("-e", "--extrapolate_point_cloud", type=int, default=1,
                    help="Point-cloud extrapolation factor")
    ap.add_argument("-c", "--camera_calibration", type=str,
                    default=DEFAULT_CALIB)
    ap.add_argument("-w", "--input_image_width", type=int, default=1242)
    ap.add_argument("-ht", "--input_image_height", type=int, default=375)
    ap.add_argument("-o", "--object_track", action="store_true",
                    help="Enable YOLO object detection + Bayesian tracking")
    ap.add_argument("-ycfg", "--yolo_cfg", type=str, default=None)
    ap.add_argument("-yw", "--yolo_weights", type=str, default=None)
    ap.add_argument("-ycl", "--yolo_classes", type=str, default=None)
    ap.add_argument("-d", "--demo", action="store_true",
                    help="Download the mini stereo dataset and loop it")
    ap.add_argument("-dst", "--dataset",
                    choices=["kitti2015", "kitti_smol"],
                    default="kitti_smol")
    ap.add_argument("-P", "--profile", action="store_true",
                    help="Process the bundled golden PGM pairs and write "
                         "*_disp.pgm outputs")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="Directory of *_left.pgm/*_right.pgm pairs for -P")
    ap.add_argument("--out_dir", type=str, default="outputs",
                    help="Artifact directory (PLY/NPZ/top-view dumps)")
    ap.add_argument("--dump", choices=["none", "ply", "npz", "topview"],
                    default="none")
    ap.add_argument("--batch", type=int, default=0,
                    help=">0 enables batched throughput mode")
    ap.add_argument("--frames", type=int, default=0,
                    help="Limit processed frame count (0 = all)")
    ap.add_argument("--preset", choices=["app", "robotics", "middlebury"],
                    default="app")
    ap.add_argument("-ctu", "--camera_to_use", type=int, default=-1,
                    help="Live mode: open system cameras N and N+2 "
                         "(reference sv.py:296-331)")
    ap.add_argument("-sw", "--swap", action="store_true",
                    help="Swap left/right cameras in live mode")
    ap.add_argument("-g", "--display", action="store_true",
                    help="Show Detections/Disparity windows (reference "
                         "stereo_vision.cpp:616-620); degrades to "
                         "render-only on display-less hosts")
    ap.add_argument("--view3d", action="store_true",
                    help="Interactive 3D point-cloud window with WASD/RF "
                         "camera and tracked-object cubes (reference "
                         "graphing.h viewer); implies --display")
    ap.add_argument("--record", type=str, default=None,
                    help="Directory to spool rendered viewer frames to "
                         "(works headless); implies --display")
    return ap


def run_profile(args, device) -> int:
    """-P: golden-producer mode (reference runProfiling,
    stereo_vision.cpp:690-755): ROBOTICS preset, both images
    post-processed, outputs normalized to [0,255] by the joint max."""
    import glob
    from .io.pgm import load_pgm, save_pgm
    from .models.elas import ElasEngine
    from .params import robotics_params

    src = args.profile_dir or DEFAULT_PROFILE_DIR
    os.makedirs(args.out_dir, exist_ok=True)
    pairs = sorted(glob.glob(osp.join(src, "*_left.pgm")))
    p = robotics_params(postprocess_only_left=False)
    for lf in pairs:
        rf = lf.replace("_left.pgm", "_right.pgm")
        if not osp.exists(rf):
            continue
        print(f"Processing: {lf}, {rf}")
        L, R = load_pgm(lf), load_pgm(rf)
        eng = ElasEngine(p, width=L.shape[1], height=L.shape[0],
                         device=device)
        D1, D2 = eng.process(L, R)
        D1, D2 = D1.cpu().numpy(), D2.cpu().numpy()
        dm = max(D1.max(), D2.max(), 1e-9)
        for D, tag in ((D1, "_left"), (D2, "_right")):
            out = np.clip(255.0 * np.maximum(D, 0) / dm, 0, 255)
            name = osp.basename(lf).replace("_left.pgm", tag + "_disp.pgm")
            save_pgm(out.astype(np.uint8), osp.join(args.out_dir, name))
    print("... done!")
    return 0


def run_live(args, device) -> int:
    """Dual-webcam live capture mode (reference sv.py:296-331); ends when a
    camera delivers no frame."""
    import cv2

    camL, camR = cv2.VideoCapture(), cv2.VideoCapture()
    if not (camL.open(args.camera_to_use)
            and camR.open(args.camera_to_use + 2)):
        print("Cannot open camera pair starting at #%d"
              % args.camera_to_use, file=sys.stderr)
        return 1
    camL.grab(), camR.grab()
    ok, left = camL.retrieve()
    if not ok:
        print("Camera #%d delivered no frame" % args.camera_to_use,
              file=sys.stderr)
        return 1
    h, w = left.shape[:2]
    W, H = int(w / args.scale), int(h / args.scale)

    def frames():
        while True:
            camL.grab(), camR.grab()
            ok_l, l = camL.retrieve()
            ok_r, r = camR.retrieve()
            if not (ok_l and ok_r):
                return
            if args.swap:
                l, r = r, l
            yield cv2.resize(l, (W, H)), cv2.resize(r, (W, H))

    with StereoEngine(args.camera_calibration, W, H, scale=args.scale,
                      pc_extrapolation=args.extrapolate_point_cloud,
                      subsampling=bool(args.subsampling),
                      device=device) as eng:
        for out in eng.stream(frames()):
            print(frame_line(out))
    return 0


def main(argv=None, device=None) -> int:
    """Run the CLI on argv (sys.argv[1:] when None).  device: where the
    engines run, the card when None (raises without CUDA)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    if args.profile:
        return run_profile(args, device)
    if args.camera_to_use >= 0:
        return run_live(args, device)

    from .io import kitti as kio

    W = int(args.input_image_width / args.scale)
    H = int(args.input_image_height / args.scale)

    if args.demo:
        base = osp.join(_PKG_DIR, "data")
        if args.dataset == "kitti2015":
            zip_path = osp.join(base, "kitti2015.zip")
            root = osp.join(base, "kitti2015")
            kio.download_file(kio.KITTI2015_URL, zip_path)
            kio.unzip_file(zip_path, root)
            seq = kio.Kitti2015Scenes(root, width=W, height=H)
        else:
            root = osp.join(base, "kitti_smol")
            kio.clone_repo(kio.MINI_DATASET_REPO, root)
            seq = kio.KittiRawSequence(
                osp.join(root, "smol_kitti"), width=W, height=H)
    else:
        if not args.kitti:
            print("error: provide --kitti PATH or --demo", file=sys.stderr)
            return 1
        seq = kio.KittiRawSequence(args.kitti, width=W, height=H)

    tracker = detector = None
    if args.object_track:
        from .models.bayesian import BayesianTracker
        from .models.yolo import YoloV4Tiny
        tracker = BayesianTracker()
        detector = YoloV4Tiny.from_files(args.yolo_cfg, args.yolo_weights,
                                         args.yolo_classes, device=device)

    viewer = None
    if args.display or args.view3d or args.record:
        from .viz_live import LiveViewer
        viewer = LiveViewer(view3d=args.view3d, record_dir=args.record,
                            device=device)

    n_frames = args.frames or len(seq)

    # Async detection overlap (reference std::async(processYOLO),
    # stereo_vision.cpp:596-598): a frame's detection is submitted to a
    # worker thread, with a CUDA stream of its own, when the frame enters
    # the pipeline, so it runs beside the stereo work; results are
    # collected in order at emit.  Frames go in groups of max(--batch, 1),
    # one forward and one fetch a group; a short last group is padded with
    # its last frame (the extra results are dropped), as stream_batched
    # pads its last batch.
    det_pool = None
    det_futs, det_buf = {}, []
    det_group = max(args.batch, 1)
    if detector is not None:
        import concurrent.futures as cf
        from .engine import _own_stream
        det_pool = cf.ThreadPoolExecutor(max_workers=1,
                                         initializer=_own_stream,
                                         initargs=(device,))

    def flush_dets():
        if det_buf:
            group = [f for _, f in det_buf]
            while len(group) < det_group:
                group.append(group[-1])
            fut = det_pool.submit(detector.detect_batch, group)
            for k, (j, _) in enumerate(det_buf):
                det_futs[j] = (fut, k)
            det_buf.clear()

    def frames_gen():
        for i in range(n_frames):
            l, r = seq[i % len(seq)]
            if det_pool is not None:
                det_buf.append((i, l))
                if len(det_buf) >= det_group:
                    flush_dets()
            yield l, r
        if det_pool is not None:
            flush_dets()

    frames = frames_gen()

    if args.dump != "none":
        os.makedirs(args.out_dir, exist_ok=True)

    def track(i, out, left):
        """The frame's detections (tracked) with their mean 3-D positions
        printed, and the viewer's cubes."""
        ent = det_futs.pop(i, None)
        dets = (ent[0].result()[ent[1]] if ent is not None
                else detector.detect(left))
        preds = tracker.get_predicted_boxes()
        tracker.append(dets)
        if not dets:
            return dets, []
        # under fetch "dmap" out["points"] is the cloud on the device, where
        # the boxes' sums run
        pos = eng.object_positions(out["points"],
                                   np.array([[d.x, d.y, d.w, d.h]
                                             for d in dets]))
        for d, xyz in zip(dets, pos):
            print(f"  {d.name} conf={d.conf:.2f} "
                  f"XYZ=({xyz[0]:.2f},{xyz[1]:.2f},{xyz[2]:.2f})")
        return dets, [{"center": tuple(xyz), "size": (1.0, 1.0, 1.0),
                       "color": (0, 255, 255), "label": d.name}
                      for d, xyz in zip(dets, pos)]

    def handle(i, out, left):
        # left: the frame that detection and the viewer consume
        dets, cubes = [], []
        if detector is not None:
            dets, cubes = track(i, out, left)
        if viewer is not None:
            viewer.show(out, left, dets,
                        fps=1 / max(out["timings"]["t_t"], 1e-9),
                        cubes=cubes)
        if args.dump == "ply":
            from .viz import save_ply
            save_ply(np.asarray(out["points"]),
                     osp.join(args.out_dir, f"cloud_{i:06d}.ply"),
                     max_depth=1e4)
        elif args.dump == "npz":
            from .viz import save_npz
            save_npz(osp.join(args.out_dir, f"frame_{i:06d}.npz"),
                     dmap=out["dmap"], points=np.asarray(out["points"]))
        elif args.dump == "topview":
            from .viz import points_to_top_view
            tv = points_to_top_view(np.asarray(out["points"]))
            try:
                import cv2
            except ImportError:
                from .io.pgm import save_pgm
                save_pgm(tv, osp.join(args.out_dir, f"top_{i:06d}.pgm"))
            else:
                cv2.imwrite(osp.join(args.out_dir, f"top_{i:06d}.png"), tv)

    if args.preset != "app":
        # --preset does not reach the engine in the JAX CLI either
        # (ROADMAP Queue 3): the port writes what it writes, and says so
        print("%s: --preset %s is parsed but not applied: the KITTI loop "
              "runs app_params(), as the reference package's CLI does"
              % (PROG, args.preset), file=sys.stderr)
    fps_accum = 0.0
    count = 0
    # host fetch only when frames must be materialized (dumps); tracking
    # (object_positions) and the viewer's renderer consume the cloud on
    # the device
    fetch = "host" if args.dump != "none" else "dmap"
    try:
        with StereoEngine(args.camera_calibration, W, H, scale=args.scale,
                          pc_extrapolation=args.extrapolate_point_cloud,
                          subsampling=bool(args.subsampling),
                          device=device) as eng:
            if args.batch > 0:
                for i, out in enumerate(eng.stream_batched(
                        frames, batch=args.batch, fetch=fetch)):
                    print(frame_line(out))
                    # seq is indexable: the left frame is read again rather
                    # than teeing the consumed iterator
                    handle(i, out, seq[i % len(seq)][0])
                    fps_accum += 1 / max(out["timings"]["t_t"], 1e-9)
                    count += 1
            else:
                for i, (left, right) in enumerate(frames):
                    out = eng.process_frame(left, right, fetch=fetch)
                    print(frame_line(out))
                    handle(i, out, left)
                    fps_accum += 1 / max(out["timings"]["t_t"], 1e-9)
                    count += 1
    finally:
        if det_pool is not None:
            det_pool.shutdown(wait=True, cancel_futures=True)
    if count:
        print("AVG_FPS=%f" % (fps_accum / count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
