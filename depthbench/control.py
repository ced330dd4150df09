#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card.

    python3 depthbench/control.py --config kitti_full --seeds 11 12 13 \
        --control-seeds 1 2 3 --seconds 3

For each seed of --seeds, each traffic mix of a cell of the configuration
serves the seed's pairs for a short window at the cell's own load (its
driver, batch and pool, one engine a mix for all seeds), and the kept
outputs are compared with the plain reference as a run compares them: the
lower readings.  For each seed of --control-seeds the control, the
reference with its plane tables and reprojection in bfloat16, is put in
the program's place on the same pairs: the upper readings.  One JSON line
a reading, and a summary line last.  Not run by the benchmark's runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _NoTrace:
    def frame(self, i):
        pass

    def close(self, i):
        pass


def readings(config_name: str, seeds, control_seeds, seconds: float) -> dict:
    """-> {"program": {mix: [reading, ...]}, "control": [reading, ...]};
    each reading is check.compare's dict with its seed."""
    from stereovision_tpu_torch.engine import StereoEngine

    from depthbench import check, frames, harness
    from depthbench.reference.pipeline import Reference
    bench = harness.load_bench(later=True)
    cells = [w["name"] for w in bench["workloads"]
             if w["config"] == config_name]
    setups = {}
    for cell in cells:
        c = harness.resolve(cell, bench)
        setups[c["workload"]["traffic"]] = c
    config = next(iter(setups.values()))["config"]
    W, H = int(config["width"]), int(config["height"])
    sub = bool(config["subsampling"])
    calib = os.path.join(ROOT, config["calibration"])
    engines = {m: StereoEngine(calib, W, H, subsampling=sub, device="cuda")
               for m in setups}
    ref = Reference(calib, W, H, sub, device="cuda")
    out = {"program": {m: [] for m in setups}, "control": []}
    try:
        for seed in seeds:
            ps = frames.pairs(config, next(iter(setups.values()))["traffic"],
                              seed)
            served = {}
            for m, c in setups.items():
                keeper = harness.Keeper(seed, c["traffic"]["points_share"])
                c["driver"].warm(engines[m], ps, c["traffic"], config)
                win = c["driver"].window(
                    engines[m], ps, frames.Schedule(len(ps), seed),
                    c["traffic"], config, seconds, keeper.keep, _NoTrace())
                served[m] = (keeper.served,
                             win["attempted"] - win["emitted"])
            refs = {k: ref.frame(*ps[k]) for k in range(len(ps))}
            for m, (kept, missing) in served.items():
                r = dict(check.compare(kept, refs), seed=seed,
                         missing=missing)
                out["program"][m].append(r)
                print(json.dumps({"config": config_name, "mix": m, **r}))
    finally:
        for e in engines.values():
            e.close()
    low = Reference(calib, W, H, sub, device="cuda", lowp=True)
    for seed in control_seeds:
        ps = frames.pairs(config, next(iter(setups.values()))["traffic"],
                          seed)
        refs = {k: ref.frame(*ps[k]) for k in range(len(ps))}
        kept = {k: [low.frame(*ps[k])] for k in range(len(ps))}
        r = dict(check.compare(kept, refs), seed=seed)
        out["control"].append(r)
        print(json.dumps({"config": config_name, "control": "bfloat16", **r}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    r = readings(args.config, args.seeds, args.control_seeds, args.seconds)
    summary = {"config": args.config,
               "lower": {m: {n: max(x[n] for x in rs)
                             for n in ("dmap_px", "points_rel")}
                         for m, rs in r["program"].items()},
               "upper": {n: min(x[n] for x in r["control"])
                         for n in ("dmap_px", "points_rel")},
               "seconds": time.perf_counter() - T_START}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
