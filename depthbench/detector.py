"""What the detection cells' driver, readings and metrics share: the
configuration's cfg, class names and seeded weights file, the plain
reference on them, the served objects as the readings compare them, and
the detector's program spans.

A configuration with a detector states "yolo_cfg" (a darknet .cfg, from
the repository's root), "yolo_classes" (its class names, one a line),
"weights_seed" and "objectness_shift": the
weights file is the port's synthetic.darknet_weights of the cfg with that
seed and shift, written once into depthbench/.cache/yolo/ under a name
made of the cfg's bytes, the seed and the shift, and read from there by
the served detector and by the reference.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterable, Optional

from .lookup import HERE

ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache", "yolo")


def cfg_path(config: dict) -> str:
    return os.path.join(ROOT, config["yolo_cfg"])


def classes_path(config: dict) -> str:
    return os.path.join(ROOT, config["yolo_classes"])


def classes(config: dict) -> list:
    with open(classes_path(config)) as f:
        return [line.strip() for line in f if line.strip()]


def weights_path(config: dict) -> str:
    """The seeded weights file of the configuration, written where it is
    missing (to a temporary name, then renamed: runs may share a
    checkout)."""
    cfg = cfg_path(config)
    with open(cfg, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(CACHE, "%s_%d_%r.weights" % (
        digest, int(config["weights_seed"]),
        float(config["objectness_shift"])))
    if not os.path.isfile(path):
        from stereovision_tpu_torch.models.yolo import parse_darknet_cfg
        from stereovision_tpu_torch.synthetic import darknet_weights
        os.makedirs(CACHE, exist_ok=True)
        tmp = "%s.%d.tmp" % (path, os.getpid())
        darknet_weights(tmp, parse_darknet_cfg(cfg),
                        int(config["weights_seed"]),
                        objectness_shift=float(config["objectness_shift"]))
        os.replace(tmp, path)
    return path


def reference(config: dict, device: str):
    """The plain darknet reference (reference/darknet.py) on the
    configuration's cfg and weights."""
    from .reference.darknet import Darknet
    return Darknet(cfg_path(config), weights_path(config), device)


def span_ms(rec: dict, names: Iterable[str]) -> Optional[float]:
    """The sum of program.span_ms over `names`, or None where the window
    holds no span of any of them (a program without them)."""
    from . import program
    names = tuple(names)
    prog = rec.get("program")
    if not prog or not any(s.name in names for s in prog["spans"]):
        return None
    ms = [program.span_ms(rec, n) for n in names]
    return None if None in ms else sum(ms)


def keep_rows(out, cloud):
    """A rows reading's keep(): the rows the driver handed on (None for
    all but a pair's first frames)."""
    return out.get("rows")


def worst_rows(kept, pairs, config, device, columns: slice,
               pixels: bool) -> float:
    """The largest |served - reference| of `columns` of the kept rows, each
    against the reference's rows of its pair's left frame (pixels: the box
    columns times the frame's width, height, width, height), in float64;
    inf for rows of another shape or a difference that is not finite."""
    import numpy as np
    ref = reference(config, device)
    worst = 0.0
    for k, outs in kept.items():
        outs = [np.asarray(r) for r in outs if r is not None]
        if not outs:
            continue
        left = pairs[k][0]
        want = ref.rows(left).astype(np.float64)[:, columns]
        scale = 1.0
        if pixels:
            h, w = left.shape[:2]
            scale = np.array([w, h, w, h], np.float64)
        for rows in outs:
            if rows.ndim != 2 or rows[:, columns].shape != want.shape:
                return float("inf")
            a, b = rows.astype(np.float64)[:, columns] * scale, want * scale
            d = np.where(a == b, 0.0, np.abs(a - b))
            d[np.isnan(d)] = np.inf
            worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def control_rows(pairs, config, device) -> dict:
    """The control of a rows reading: {pair index: {"rows"}} of the
    reference with TF32 on (reference/darknet.py)."""
    ref = reference(config, device)
    return {k: {"rows": ref.rows(left, tf32=True)}
            for k, (left, _) in enumerate(pairs)}


def objects(served) -> list:
    """StereoVision's last["objects"] as (name, x, y, w, h, conf) each."""
    return [(o.name, o.x, o.y, o.w, o.h, o.conf) for o in served]


def tracker_state(tracker) -> dict:
    """A copy of the served tracker's state, as reference/tracker.py's
    Tracker.from_state takes it."""
    return {"x": tracker.x.copy(), "y": tracker.y.copy(),
            "used": tracker.used.copy(), "top": tracker.top,
            "queue_empty": tracker.queue_empty,
            "queue_full": tracker.queue_full}


def _differ(a: list, b: list) -> int:
    """The positions at which two lists of objects differ, and the
    difference in length."""
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def worst_objects(kept, pairs, config) -> float:
    """The det_objects reading: the frames' kept objects in the order
    served, from the tracker's state kept with the first (a fresh tracker
    where none is), each frame's served detections handed on to the
    reference's tracker; where a frame's rows were kept, detections that
    the reference's decode of them does not give (reference/darknet.py
    agrees) count as the positions that differ from its detections(), at
    least 1.  The most objects of one frame that differ; inf where the
    frames kept are not 0, 1, ... without a gap."""
    import numpy as np

    from .reference.darknet import agrees, detections
    from .reference.tracker import Tracker
    served = sorted(((o["frame"], k, o) for k, outs in kept.items()
                     for o in outs if o is not None), key=lambda t: t[0])
    if [f for f, _, _ in served] != list(range(len(served))):
        return float("inf")
    names = classes(config)
    state = served[0][2]["tracker"] if served else None
    track = Tracker() if state is None else Tracker.from_state(state)
    worst = 0
    for _, k, o in served:
        objs = [tuple(x) for x in o["objects"]]
        preds = track.predict()
        cut = max(len(objs) - len(preds), 0)
        dets, bad = objs[:cut], _differ(objs[cut:], preds)
        rows, hw = o["rows"], pairs[k][0].shape[:2]
        if rows is not None and not agrees(dets, np.asarray(rows), hw, names):
            bad += max(1, _differ(dets, detections(np.asarray(rows), hw,
                                                   names)))
        track.append(dets)
        worst = max(worst, bad)
    return float(worst)


def control_objects(pairs, config, device) -> dict:
    """The control of det_objects: {pair index: the frame's kept output}
    for each pair once, in order, from a fresh tracker: the reference's
    rows, and its objects with a planted fault, the detections' boxes
    rounded to the nearest pixel in place of cut towards zero."""
    import numpy as np

    from .reference.darknet import detections
    from .reference.tracker import Tracker
    ref, names, track = reference(config, device), classes(config), Tracker()
    out = {}
    for k, (left, _) in enumerate(pairs):
        rows = ref.rows(left)
        dets = detections(rows, left.shape[:2], names, to_pixel=np.rint)
        preds = track.predict()
        track.append(dets)
        out[k] = {"frame": k, "objects": dets + preds, "rows": rows,
                  "tracker": None}
    return out
