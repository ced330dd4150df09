#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card.

    python3 depthbench/control.py --config kitti_full --seeds 11 12 13 \
        --control-seeds 1 2 3 --seconds 3

For each seed of --seeds, each cell of the configuration (BENCHMARK.json
with depthbench/later.json) is run as run.py runs it, through
harness.run_cell with a short window at the cell's own load: its readings
are the lower ones.  For each seed of --control-seeds the control is put
in the program's place on the same pairs and compared as a run compares:
the upper readings.  A reading's module under checks/ may bring its own
control (control()); the others read the stereo reference with its plane
tables and reprojection in bfloat16.  One JSON line a reading, and a
summary line last.  Not run by the benchmark's runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_outputs(checks: dict, pairs, config: dict, device: str) -> dict:
    """{reading: {pair index: the control's output}}: a reading's own
    control() where its module has one, else the stereo reference in
    bfloat16."""
    from depthbench.reference.pipeline import Reference
    outs = {n: m.control(pairs, config, device)
            for n, m in checks.items() if hasattr(m, "control")}
    if len(outs) < len(checks):
        low = Reference(os.path.join(ROOT, config["calibration"]),
                        int(config["width"]), int(config["height"]),
                        bool(config["subsampling"]), device=device,
                        lowp=True)
        stereo = {k: low.frame(*p) for k, p in enumerate(pairs)}
        outs.update({n: stereo for n in checks if n not in outs})
    return outs


def readings(config_name: str, seeds, control_seeds, seconds: float,
             device: str = "cuda", bench=None, overrides=None,
             log=None) -> dict:
    """-> {"program": {cell: [reading, ...]}, "control": [reading, ...],
    "names": the readings the configuration names}; a program reading is
    {name: value} of run_cell's checks with the seed, a control reading
    check.compare's dict with its seed.  bench: a benchmark description
    in place of BENCHMARK.json with later.json; overrides: as run_cell's."""
    from depthbench import check, frames, harness
    from depthbench.reference.pipeline import Reference
    bench = bench or harness.load_bench(later=True)
    cells = [w["name"] for w in bench["workloads"]
             if w["config"] == config_name]
    out = {"program": {cell: [] for cell in cells}, "control": []}
    for seed in seeds:
        for cell in cells:
            r = harness.run_cell(cell, seed, seconds, False,
                                 time.perf_counter(), device=device,
                                 overrides=overrides, log=log, bench=bench)
            row = {n: c["value"] for n, c in r["checks"].items()}
            row.update(seed=seed, correct=r["correct"])
            out["program"][cell].append(row)
            print(json.dumps({"config": config_name, "cell": cell, **row}),
                  flush=True)
    c = harness.resolve(cells[0], bench, overrides)
    config = c["config"]
    checks = check.modules(check.limits_of(config))
    out["names"] = list(checks)
    ref = Reference(os.path.join(ROOT, config["calibration"]),
                    int(config["width"]), int(config["height"]),
                    bool(config["subsampling"]), device=device)
    for seed in control_seeds:
        ps = frames.pairs(config, c["traffic"], seed)
        refs = {k: ref.frame(*p) for k, p in enumerate(ps)}
        ctl = control_outputs(checks, ps, config, device)
        kept = {k: [{n: m.keep(ctl[n][k], True) for n, m in checks.items()}]
                for k in range(len(ps))}
        r = dict(check.compare(kept, refs, ps, config, device, checks),
                 seed=seed)
        out["control"].append(r)
        print(json.dumps({"config": config_name, "control": True, **r}),
              flush=True)
    return out


def summarize(r: dict) -> dict:
    """The lower readings (each cell's largest over its seeds, with
    missing_frames) and the upper ones (the control's least)."""
    names = r["names"]
    return {"lower": {cell: {n: max(x[n] for x in rs)
                             for n in names + ["missing_frames"]}
                      for cell, rs in r["program"].items()},
            "upper": {n: min(x[n] for x in r["control"]) for n in names}}


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
    summary = dict(summarize(r), config=args.config,
                   seconds=time.perf_counter() - T_START)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
