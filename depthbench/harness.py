"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: configs/<config>.json (through BENCHMARK.json's "file"),
traffic/<mix>.json, drivers/<entry>.py (the mix's "entry"), and
metrics/<metric>.py for every metric BENCHMARK.json gives the cell.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import check, frames, roofline, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "stereovision_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """depthbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise LookupError("no %s named %r (%s)" % (kind, name, path))
    spec = importlib.util.spec_from_file_location(
        "depthbench_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def resolve(cell: str, bench: Optional[dict] = None) -> dict:
    """A cell's configuration, traffic mix, driver and metrics by name."""
    bench = bench or load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise LookupError("no workload %r in BENCHMARK.json" % cell)
    w = cells[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))

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
    """The served outputs kept for the check: every frame's display
    disparity, and the cloud of each pair's first frame and of a share of
    the others drawn from the seed."""

    def __init__(self, seed: int, share: float):
        self.rng = np.random.default_rng([seed, 7])
        self.share = float(share)
        self.served: Dict[int, List[dict]] = {}

    def keep(self, k: int, out: dict) -> None:
        """out: a served frame of pair k."""
        outs = self.served.setdefault(k, [])
        cloud = not outs or self.rng.random() < self.share
        outs.append({"dmap": out["dmap"],
                     "points": out["points"] if cloud else None})


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
             bench: Optional[dict] = None) -> dict:
    """Run `cell` once and return its result (the last line's object).
    overrides: keys that replace the configuration's or the mix's, and
    bench: a benchmark description in place of BENCHMARK.json (the
    harness's tests run small frames on the CPU, and the cells of
    later.json, with them)."""
    import torch
    from stereovision_tpu_torch.engine import StereoEngine

    from .reference.pipeline import Reference
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    c = resolve(cell, bench)
    config, traffic, driver = c["config"], c["traffic"], c["driver"]
    for k, v in (overrides or {}).items():
        (traffic if k in traffic else config)[k] = v
    cuda = device == "cuda"
    calib = os.path.join(ROOT, config["calibration"])
    W, H, sub = int(config["width"]), int(config["height"]), \
        bool(config["subsampling"])
    limits = check.limits_of(config)

    # ---- set-up: frames, engine, warm-up ------------------------------
    marks = [("imports", time.perf_counter())]
    ps = frames.pairs(config, traffic, seed)
    marks.append(("frames", time.perf_counter()))
    engine = StereoEngine(calib, W, H, subsampling=sub, device=device)
    marks.append(("engine", time.perf_counter()))
    driver.warm(engine, ps, traffic, config)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    spans = trace.install_spans(engine) if traced else {}
    tracer = trace.Tracer(traced, cuda, int(traffic["trace_start"]),
                          int(traffic["trace_frames"]))
    tracer.warm()
    keeper = Keeper(seed, traffic["points_share"])
    setup_s = time.perf_counter() - t_start
    marks.append(("profiler", time.perf_counter()))
    log("set-up %.3f s: %s" % (setup_s, ", ".join(
        "%s by %.3f" % (n, t - t_start) for n, t in marks)))

    # ---- the window ---------------------------------------------------
    win = driver.window(engine, ps, frames.Schedule(len(ps), seed),
                        traffic, config, seconds, keeper.keep, tracer)
    if cuda:
        torch.cuda.synchronize()
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
    readings = check.compare(keeper.served, refs)
    missing = win["attempted"] - win["emitted"]
    correct, rows = check.verdict(readings, limits, missing)
    log("reference: %d pairs in %.3f s; %d frames and %d clouds compared"
        % (len(refs), time.perf_counter() - t_ref, readings["frames"],
           readings["clouds"]))

    # ---- metrics ------------------------------------------------------
    rec = {"setup_s": setup_s, "traced": traced, **win,
           "spans": {k: list(v) for k, v in spans.items()},
           "trace": summary}
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
    metrics = read_metrics(c["per_layer"] if traced else c["end_to_end"],
                           rec)
    if "latencies_s" in win:
        lat = np.asarray(win["latencies_s"]) * 1e3
        log("latency samples: %d frames; median %.3f ms; mean by thirds of "
            "the window %s ms" % (lat.size, float(np.median(lat)), " ".join(
                "%.3f" % t.mean() for t in np.array_split(lat, 3) if t.size)))
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
        log("trace: %d frames, launches %s, kernels %s"
            % (summary.get("frames", 0), summary.get("launch_calls"),
               summary.get("kernels")))
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    # inf (a cloud whose invalid points moved) as the largest float
    result["checks"] = {n: {"value": min(float(v), sys.float_info.max),
                            "limit": lim} for n, v, lim in rows}
    return result
