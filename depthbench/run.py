#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 depthbench/run.py --workload kitti_full.live --seed 7 \
        --seconds 30 --trace 0

A cell is a workload of BENCHMARK.json: a configuration under a traffic
mix.  The run makes its frames from --seed, builds and warms up the port's
engine on the card (the set-up), serves the mix for --seconds, checks every
kept output against the plain reference, and prints one JSON line last on
standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics read from spans and torch.profiler.  The
numbers compared and their limits are the last lines on standard error.

It exits non-zero, and prints no result, where CUDA is unavailable or has
fewer devices than the cell asks for, and where jax, jaxlib, flax or the
JAX package (stereovision_tpu) is loaded once the window has closed.

Nothing runs at import and torch is imported inside main(): the host
middle's spawned pool re-imports this file in every worker.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "depthbench", ".cache")
# Python's bytecode of every module (torch's ~2,100 files among them) in a
# fixed place inside the checkout, written by the first run and read by the
# rest: where the installation ships no .pyc and PYTHONDONTWRITEBYTECODE is
# set, each run would otherwise compile torch from source in its set-up.
# Set before numpy and torch load; the host middle's pool workers inherit
# it.
sys.pycache_prefix = os.path.join(CACHE, "pyc")
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
# one thread for every CPU math library, set before numpy and torch load
# (the host middle's pool workers inherit it): their idle pools spun on
# an 8-core H100 host, ~1 core's worth beside the main thread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None, **kw) -> int:
    """kw: further keywords of harness.run_cell (program_spans.py's)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches at fixed places inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from depthbench import harness
    chips = harness.resolve(args.workload)["workload"]["chips"]
    import torch
    print("depthbench: torch imported by %.3f s"
          % (time.perf_counter() - T_START), file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("depthbench: the cell needs %d CUDA device(s); this machine "
              "has %s" % (chips, torch.cuda.device_count()
                          if torch.cuda.is_available() else "none"),
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START, **kw)
    bad = harness.forbidden_modules()
    if bad:
        print("depthbench: loaded " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print("check %s = %r (limit %r)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
