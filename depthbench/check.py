"""Whether what the timed path served is correct: every compared output
against the plain reference's for its pair, by the readings that the
configuration's "check" entry names, each with its limit there.

Each reading is a module checks/<name>.py (found as lookup.py finds it):

  keep(out, cloud)  what to keep of one served output, or None; cloud is
                    the keeper's draw of whether this frame's cloud is
                    kept, for a large output to follow the same share;
  read(kept, refs, pairs, config, device)
                    the worst reading over the kept outputs, a float:
                    kept maps a pair index to what keep() kept of each of
                    its frames, refs a pair index to the stereo
                    reference's output (reference/pipeline.py), pairs the
                    run's input pairs; a reading that needs another
                    reference builds it here;
  control(pairs, config, device)    (optional)
                    the control in the program's place: {pair index: an
                    output as keep() takes it}, from this reading's
                    reference in the precision below the configuration's.
                    Without it the control is the stereo reference in
                    bfloat16 (control.py).

Every configuration serves the stereo path and states dmap_px (the most
pixels of one frame's display disparity that differ) and points_rel (the
largest relative difference of a cloud coordinate).  A frame that was sent
and never came back counts as missing, and a run with any missing frame,
or with no frame compared, is not correct.
"""

from __future__ import annotations

from typing import Dict, List

from . import lookup

REQUIRED = ("dmap_px", "points_rel")


def limits_of(config: dict) -> Dict[str, float]:
    """{reading: limit} for every reading the configuration states, the
    required ones first; ValueError where one of those is not stated or a
    stated one has no module."""
    lim = config.get("check") or {}
    if any(n not in lim for n in REQUIRED):
        raise ValueError("configuration %r states no limits for %s"
                         % (config.get("name"), ", ".join(REQUIRED)))
    names = list(REQUIRED) + [n for n in lim if n not in REQUIRED]
    lost = [n for n in names if lookup.find("checks", n) is None]
    if lost:
        raise ValueError("configuration %r states readings with no module "
                         "under checks/: %s" % (config.get("name"),
                                                ", ".join(lost)))
    return {n: float(lim[n]) for n in names}


def modules(limits: Dict[str, float]) -> dict:
    """{reading: its module} for limits_of()'s readings."""
    return {n: lookup.load_module("checks", n) for n in limits}


def kept(out: dict, checks: dict, cloud: bool) -> dict:
    """What each reading keeps of one served output."""
    return {n: m.keep(out, cloud) for n, m in checks.items()}


def compare(served: Dict[int, List[dict]], refs: Dict[int, dict], pairs,
            config: dict, device: str, checks: dict) -> dict:
    """served: pair index -> kept() of each frame served for it; refs:
    pair index -> the reference's output.  -> {reading: the worst
    reading}, "frames" compared and "kept" (how many outputs each reading
    kept)."""
    out = {"frames": sum(len(v) for v in served.values()), "kept": {}}
    for n, m in checks.items():
        mine = {k: [o[n] for o in outs] for k, outs in served.items()}
        out[n] = float(m.read(mine, refs, pairs, config, device))
        out["kept"][n] = sum(x is not None for v in mine.values() for x in v)
    return out


def verdict(readings: dict, limits: dict, missing: int) -> tuple:
    """-> (correct, [[name, value, limit], ...]) with missing frames as a
    number of its own (limit 0)."""
    rows = [[n, readings[n], lim] for n, lim in limits.items()]
    rows.append(["missing_frames", missing, 0])
    ok = all(v <= lim for _, v, lim in rows) and readings["frames"] > 0
    return ok, rows
