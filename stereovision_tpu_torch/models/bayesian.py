"""Bayesian constant-velocity box tracker (a copy of
stereovision_tpu/models/bayesian.py, which the port may not import).

Behavioural port of the reference's tracker
(src/common_includes/bayesian/bayesian.{h,cpp}): a fixed pool of
MAX_OBJECTS tracks, each holding a HISTORY-frame ring buffer of (x, y)
centroids; detections are matched to the nearest previous-frame track
within DISTANCE_THRESH pixels (bayesian.cpp:27-51); predictions add the
mean of recent frame-to-frame position deltas (outlier deltas above the
distance threshold ignored, bayesian.cpp:94-115); predicted boxes are
emitted as fixed 10x10 "P" boxes once the ring buffer has filled, and a
running mean/max pixel error between past predictions and observed
positions is tracked (bayesian.cpp:139-173).

This is O(tracks x detections) per frame — host-side NumPy by design.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

MAX_OBJECTS = 10
HISTORY = 5
DISTANCE_THRESH = 100.0


@dataclasses.dataclass
class Detection:
    """Matches the reference OBJ struct (src/common_includes/structs.h)."""
    name: str = ""
    x: int = 0
    y: int = 0
    w: int = 0
    h: int = 0
    conf: float = 0.0
    r: float = 0.0
    g: float = 0.0
    b: float = 0.0


class BayesianTracker:
    def __init__(self, max_objects: int = MAX_OBJECTS,
                 history: int = HISTORY,
                 distance_thresh: float = DISTANCE_THRESH):
        self.m = max_objects
        self.hist = history
        self.thresh = distance_thresh
        self.x = np.zeros((self.m, self.hist), np.int64)
        self.y = np.zeros((self.m, self.hist), np.int64)
        self.used = np.zeros((self.m, self.hist), bool)
        self.pred_x = np.zeros(self.m, np.int64)
        self.pred_y = np.zeros(self.m, np.int64)
        self.top = 0
        self.queue_empty = True
        self.queue_full = False
        self.error_list: List[float] = []
        self.mean_errors: List[float] = []
        self.max_err = 0.0

    # -- update ---------------------------------------------------------------

    def _match(self, x: int, y: int) -> int:
        prev = (self.top - 1) % self.hist
        best, best_d = -1, self.thresh
        for j in range(self.m):
            if not self.used[j, prev]:
                continue
            d = math.hypot(self.x[j, prev] - x, self.y[j, prev] - y)
            if d < self.thresh and d < best_d:
                best, best_d = j, d
        if best == -1:
            # reference unused_id returns 0 in every branch
            # (bayesian.cpp:19-25) — all unmatched detections land in
            # slot 0; reproduced for behavioural parity.
            best = 0
        return best

    def append(self, detections: Sequence[Detection]) -> None:
        """append_old_objs (bayesian.cpp:66-92)."""
        top = self.top % self.hist
        self.used[:, top] = False
        for i, det in enumerate(detections):
            idx = i if self.queue_empty else self._match(det.x, det.y)
            if idx >= self.m:
                break
            self.used[idx, top] = True
            self.x[idx, top] = det.x
            self.y[idx, top] = det.y
        self.queue_empty = False
        if top == self.hist - 1:
            self.queue_full = True
        self.top = top + 1

    # -- predict --------------------------------------------------------------

    def _mean_delta(self, a: np.ndarray, used: np.ndarray) -> int:
        """mean_change_position_vector (bayesian.cpp:94-115)."""
        recent = (self.top - 1) % self.hist
        m = 0.0
        for i_count in range(2, self.hist):
            i = (recent + i_count) % self.hist
            if used[i]:
                delta = int(a[i]) - int(a[i - 1])
                if abs(delta) < self.thresh:
                    m += delta
        return int(round(m / self.hist))

    def _predict(self, idx: int):
        """predict (bayesian.cpp:120-137)."""
        recent = (self.top - 1) % self.hist
        px = int(self.x[idx, recent]) + self._mean_delta(self.x[idx],
                                                         self.used[idx])
        py = int(self.y[idx, recent]) + self._mean_delta(self.y[idx],
                                                         self.used[idx])
        if self.pred_x[idx] != 0 and self.pred_y[idx] != 0:
            self.error_list.append(
                abs(float(self.pred_x[idx] - self.x[idx, recent])))
            self.error_list.append(
                abs(float(self.pred_y[idx] - self.y[idx, recent])))
        self.pred_x[idx], self.pred_y[idx] = px, py
        return px, py

    def get_predicted_boxes(self) -> List[Detection]:
        """get_predicted_boxes (bayesian.cpp:139-173)."""
        self.error_list = []
        recent = (self.top - 1) % self.hist
        out: List[Detection] = []
        for idx in range(self.m):
            if not self.used[idx, recent]:
                continue
            if self.queue_full:
                px, py = self._predict(idx)
            else:
                px, py = 0, 0
            out.append(Detection(name="P", x=px, y=py, w=10, h=10,
                                 conf=0.1, r=1.0, g=1.0, b=1.0))
        avg = (sum(self.error_list) / len(self.error_list)
               if self.error_list else 0.0)
        self.max_err = max(self.max_err, avg)
        self.mean_errors.append(abs(avg))
        return out

    @property
    def mean_error(self) -> float:
        return (sum(self.mean_errors) / len(self.mean_errors)
                if self.mean_errors else 0.0)
