"""Multi-process launcher: the sharded stereo pipeline across N processes
(counterpart of scripts/multihost_launch.py).

Every process joins with torch.distributed (parallel.mesh.init_distributed:
gloo on the CPU and where processes share a GPU, nccl where each owns
GPUs of its own), builds the global ('stream', 'tile') mesh (processes on
'stream', each process's --local-devices on 'tile') and steps
ShardedStereoPipeline.run_multihost on its own frames.

Parent mode (default): starts --nproc workers on this machine, waits, and
prints each one's result.  Worker mode (--worker N): joins the job, checks
every local frame against a single-device ElasEngine (padding rows -10),
times --steps steps and prints `RESULT {json}` with process, mesh, steps,
global_batch, frames_per_s, step_s and shard_errors (frame stripes that
differ; "skipped" with --no-validate).

    python -m stereovision_tpu_torch.parallel.launch --nproc 2 \\
        --local-devices 2 --steps 2 --device cpu

On one GPU --local-devices k is cuda:0 k times in each process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m stereovision_tpu_torch.parallel.launch")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--port", type=int, default=12731)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frames-per-host", type=int, default=2)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--disp-max", type=int, default=63)
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the check of each local frame against a "
                         "single-device engine")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", type=str, default="")
    return ap


def scene(batch: int, h: int, w: int):
    """The launcher's global scene (seeded): noise frames, each right
    frame its left one shifted by 5 + i columns."""
    import numpy as np
    rng = np.random.default_rng(42)
    L = rng.integers(0, 255, (batch, h, w), dtype=np.uint8)
    R = np.stack([np.roll(L[i], -(5 + i), axis=1) for i in range(batch)])
    return L, R


def worker(args) -> dict:
    import torch

    from ..models.elas import ElasEngine
    from ..params import robotics_params
    from .mesh import (init_distributed, local_batch_indices,
                       multihost_mesh, process_devices)
    from .shard import ShardedStereoPipeline

    if args.device == "cpu":
        # the processes share this host's cores: oversubscribed intra-op
        # threads slow every one of them down many times over
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // args.nproc)))
    backend = init_distributed("127.0.0.1:%d" % args.port, args.nproc,
                               args.worker, args.device)
    pid = torch.distributed.get_rank()
    local = process_devices(args.local_devices, args.device, args.nproc,
                            pid)
    mesh = multihost_mesh(local_devices=local)
    print("[proc %d] mesh=%s backend=%s devices=%s"
          % (pid, mesh.shape, backend, [str(d) for d in local]), flush=True)

    w, h = args.width, args.height
    p = robotics_params(disp_max=args.disp_max,
                        postprocess_only_left=False)
    pipe = ShardedStereoPipeline(p, w, h, mesh)
    B = args.frames_per_host * mesh.shape["stream"]
    L, R = scene(B, h, w)
    mine = local_batch_indices(B, mesh)
    L_loc, R_loc = L[mine], R[mine]

    def step():
        D1, _ = pipe.run_multihost(L_loc, R_loc)
        if D1.device.type == "cuda":
            torch.cuda.synchronize(D1.device)
        return D1

    D1 = step()        # warm-up: builds the kernels, starts the pool
    errs = None
    if not args.no_validate:
        errs = 0
        single = ElasEngine(p, w, h, device=local[0])
        stripes = [(t * rows, (t + 1) * rows) for rows in
                   [D1.shape[1] // mesh.shape["tile"]]
                   for t in range(mesh.shape["tile"])]
        for k, bi in enumerate(mine):
            ref = single.process(L[bi], R[bi])[0]
            ref = torch.nn.functional.pad(ref, (0, 0, 0, pipe.pad_out),
                                          value=-10.0).cpu()
            got = D1[k].cpu()
            errs += sum(not torch.equal(got[lo:hi], ref[lo:hi])
                        for lo, hi in stripes)
        print("[proc %d] shard validation: %s" % (
            pid, "OK" if errs == 0 else "%d shards differ" % errs),
            flush=True)

    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    dt = time.perf_counter() - t0
    res = {"process": pid, "mesh": mesh.shape, "steps": args.steps,
           "global_batch": B,
           "frames_per_s": args.steps * B / dt if dt else None,
           "step_s": dt / args.steps if args.steps else None,
           "shard_errors": "skipped" if errs is None else errs,
           "device": args.device, "backend": backend}
    print("[proc %d] RESULT %s" % (pid, json.dumps(res)), flush=True)
    pipe.close()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return res


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker >= 0:
        res = worker(args)
        return 0 if res["shard_errors"] in (0, "skipped") else 1

    procs = []
    for i in range(args.nproc):
        cmd = [sys.executable, "-m", "stereovision_tpu_torch.parallel.launch",
               "--worker", str(i)]
        for f in ("nproc", "local_devices", "port", "steps",
                  "frames_per_host", "width", "height", "disp_max",
                  "device"):
            cmd += ["--" + f.replace("_", "-"), str(getattr(args, f))]
        if args.no_validate:
            cmd.append("--no-validate")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                      if x])
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate()[0] for p in procs]
    rc = max(p.returncode for p in procs)
    results = []
    for o in outs:
        sys.stdout.write(o)
        for line in o.splitlines():
            if "RESULT " in line:
                results.append(json.loads(line.split("RESULT ", 1)[1]))
    if args.out and results:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if rc == 0 and len(results) == args.nproc:
        print("multihost OK: %d processes, %s frames/s global"
              % (args.nproc, results[0]["frames_per_s"]))
        return 0
    print("multihost FAILED", file=sys.stderr)
    return rc or 1


if __name__ == "__main__":
    sys.exit(main())
