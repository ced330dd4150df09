"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, reading or
metric is found by name (lookup.py): configs/<config>.json (through
BENCHMARK.json's "file"), traffic/<mix>.json, drivers/<entry>.py (the
mix's "entry"), checks/<reading>.py for every reading the configuration's
"check" names, and metrics/<metric>.py for every metric BENCHMARK.json
gives the cell.

A driver serves the object its build(config, calib_path, device) returns
(one with close()), or the port's StereoEngine where it has no build.

A metric file's read(rec) gets the run's record: what the driver's window
returned (frames, window_s, latencies_s, ...), setup_s, traced, config
and traffic (as resolved, with overrides), spans (the benchmark's
wrappers, traced runs), trace (Tracer.summary(): busy_s, kernels, launch_calls,
device_s_by_name, stage_device_s, ...), program (the program's own spans
from the end of the warm-up to the end of the window, traced runs) and
bounds (the kernels' least times, where the trace has K1-K4).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import check, frames, roofline, trace
from .lookup import HERE, find, load_module

ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "stereovision_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(later: bool = False) -> dict:
    """BENCHMARK.json; with `later`, merged with later.json: its
    configurations and cells added, its metrics appended, or the cells of a
    metric that BENCHMARK.json has already added to that metric's."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if later:
        extra = load_json(os.path.join(HERE, "later.json"))
        for key in ("configs", "workloads"):
            bench[key] += extra[key]
        for key in ("end_to_end", "per_layer"):
            have = {m["name"]: m for m in bench[key]}
            for m in extra[key]:
                if m["name"] in have:
                    have[m["name"]]["workloads"] += m["workloads"]
                else:
                    bench[key].append(m)
    return bench


def resolve(cell: str, bench: Optional[dict] = None,
            overrides: Optional[dict] = None) -> dict:
    """A cell's configuration, traffic mix, driver and metrics by name;
    overrides: keys that replace the mix's (where it has them) or the
    configuration's."""
    bench = bench or load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise LookupError("no workload %r in BENCHMARK.json" % cell)
    w = cells[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    path = find("traffic", w["traffic"], ".json")
    if path is None:
        raise LookupError("no traffic mix named %r" % w["traffic"])
    traffic = load_json(path)
    for k, v in (overrides or {}).items():
        (traffic if k in traffic else config)[k] = v

    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return {"workload": w, "config": config, "traffic": traffic,
            "driver": load_module("drivers", traffic["entry"]),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


class Keeper:
    """The served outputs kept for the check: what each reading keeps of
    every frame (check.kept), with the draw of whether a frame's cloud is
    kept: each pair's first frame and a share of the others, drawn from the
    seed."""

    def __init__(self, seed: int, share: float, checks: dict):
        self.rng = np.random.default_rng([seed, 7])
        self.share = float(share)
        self.checks = checks
        self.served: Dict[int, List[dict]] = {}

    def keep(self, k: int, out) -> None:
        """out: a served frame of pair k."""
        outs = self.served.setdefault(k, [])
        cloud = not outs or self.rng.random() < self.share
        outs.append(check.kept(out, self.checks, cloud))


def build_served(driver, config: dict, device: str):
    """The object the cell's driver serves: what its build(config,
    calib_path, device) returns, else the port's StereoEngine for the
    configuration's rig, size and subsampling."""
    calib = os.path.join(ROOT, config["calibration"])
    if hasattr(driver, "build"):
        return driver.build(config, calib, device)
    from stereovision_tpu_torch.engine import StereoEngine
    return StereoEngine(calib, int(config["width"]), int(config["height"]),
                        subsampling=bool(config["subsampling"]),
                        device=device)


def read_metrics(specs, rec: dict) -> Dict[str, dict]:
    """Each metric's reader on the run's record; one that finds nothing
    to read is left out."""
    out = {}
    for m in specs:
        v = load_module("metrics", m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[dict] = None, log=None,
             bench: Optional[dict] = None, program: Optional[bool] = None,
             on_record: Optional[Callable[[dict], None]] = None) -> dict:
    """Run `cell` once and return its result (the last line's object).
    overrides: keys that replace the configuration's or the mix's;
    bench: a benchmark description in place of BENCHMARK.json (the
    harness's tests run small frames on the CPU, and the cells of
    later.json, with them); program: record the program's
    own spans from the end of the warm-up to the end of the window (by
    default in traced runs only); on_record: called with the record that
    the metrics read."""
    import torch
    from stereovision_tpu_torch import profiling as P

    from .reference.pipeline import Reference
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    program = traced if program is None else program
    c = resolve(cell, bench, overrides)
    config, traffic, driver = c["config"], c["traffic"], c["driver"]
    cuda = device == "cuda"
    calib = os.path.join(ROOT, config["calibration"])
    W, H, sub = int(config["width"]), int(config["height"]), \
        bool(config["subsampling"])
    limits = check.limits_of(config)
    checks = check.modules(limits)

    # ---- set-up: frames, the served object, warm-up ---------------------
    marks = [("imports", time.perf_counter())]
    ps = frames.pairs(config, traffic, seed)
    marks.append(("frames", time.perf_counter()))
    engine = build_served(driver, config, device)
    marks.append(("engine", time.perf_counter()))
    driver.warm(engine, ps, traffic, config)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    spans = trace.install_spans(engine) if traced else {}
    tracer = trace.Tracer(traced, cuda, int(traffic["trace_start"]),
                          int(traffic["trace_frames"]))
    tracer.warm()
    if program:
        P.trace_drain()
        P.trace_start()
    keeper = Keeper(seed, traffic["points_share"], checks)
    setup_s = time.perf_counter() - t_start
    marks.append(("profiler", time.perf_counter()))
    log("set-up %.3f s: %s" % (setup_s, ", ".join(
        "%s by %.3f" % (n, t - t_start) for n, t in marks)))

    # ---- the window ---------------------------------------------------
    try:
        win = driver.window(engine, ps, frames.Schedule(len(ps), seed),
                            traffic, config, seconds, keeper.keep, tracer)
        if cuda:
            torch.cuda.synchronize()
    finally:
        if program:
            P.trace_stop()
    drained = P.trace_drain()["spans"] if program else None
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = tracer.summary()
    engine.close()
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise SystemExit("forbidden modules loaded: " + ", ".join(bad))
    log("window %.3f s, %d frames in it, %d attempted, %d emitted%s"
        % (win["window_s"], win["frames"], win["attempted"], win["emitted"],
           ", host middle on %s" % win["host_mode"]
           if "host_mode" in win else ""))

    # ---- the check, after the program's state is freed -----------------
    t_ref = time.perf_counter()
    ref = Reference(calib, W, H, sub, device=device)
    refs = {k: ref.frame(*ps[k], keep=traced) for k in keeper.served}
    readings = check.compare(keeper.served, refs, ps, config, device,
                             checks)
    missing = win["attempted"] - win["emitted"]
    correct, rows = check.verdict(readings, limits, missing)
    log("reference: %d pairs in %.3f s; %d frames compared; kept by "
        "reading: %s" % (len(refs), time.perf_counter() - t_ref,
                         readings["frames"], ", ".join(
                             "%s %d" % kv for kv in readings["kept"].items())))

    # ---- metrics ------------------------------------------------------
    rec = {"setup_s": setup_s, "traced": traced, **win, "config": config,
           "traffic": traffic,
           "spans": {k: list(v) for k, v in spans.items()}, "trace": summary}
    if drained is not None:
        rec["program"] = {"spans": drained, "full": len(drained) >= P.RING}
    loads = [refs[k]["load"] for k in sorted(refs)]
    log("host middle's load (reference), by pair: support points %s (cap "
        "%d; thinned from %s), triangles left %s, right %s"
        % ([x["support"] for x in loads], ref.n_max,
           [x["thinned_from"] for x in loads], [x["tris_l"] for x in loads],
           [x["tris_r"] for x in loads]))
    if traced and summary.get("kernels"):
        works = [roofline.frame_work(ref.p, W, H, refs[k]["passes"])
                 for k in sorted(refs)]
        rec["bounds"] = roofline.call_bounds(ref.p, works, rec["batch"])
        log("matching candidates (reference), by pair: %s" % [
            (w["K1l"][1] + w["K1r"][1]) // 32 for w in works])
    if on_record is not None:
        on_record(rec)
    metrics = read_metrics(c["per_layer"] if traced else c["end_to_end"],
                           rec)
    if "latencies_s" in win:
        lat = np.asarray(win["latencies_s"]) * 1e3
        log("latency samples: %d frames; median %.3f ms; p95 %.3f ms; mean "
            "by thirds of the window %s ms" % (
                lat.size, float(np.median(lat)),
                float(np.percentile(lat, 95)) if lat.size else float("nan"),
                " ".join("%.3f" % t.mean()
                         for t in np.array_split(lat, 3) if t.size)))
    if "emitted_at_s" in win:
        at = np.asarray(win["emitted_at_s"])
        log("frames emitted by thirds of the window: %s" % " ".join(
            str(int(((at >= win["window_s"] * k / 3)
                     & (at < win["window_s"] * (k + 1) / 3)).sum()))
            for k in range(3)))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(missing), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = summary.get("busy_s", 0.0)
        dev["window_s"] = summary.get("window_s", 0.0)
        log("trace: %d frames, launches %s, kernels %s; device s by program "
            "span %s" % (summary.get("frames", 0), summary.get("launch_calls"),
                         summary.get("kernels"),
                         summary.get("stage_device_s")))
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    # inf (a cloud whose invalid points moved) as the largest float
    result["checks"] = {n: {"value": min(float(v), sys.float_info.max),
                            "limit": lim} for n, v, lim in rows}
    return result
