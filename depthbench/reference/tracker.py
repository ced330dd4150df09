"""The plain reference of the served object's box tracker: the reference's
Bayesian constant-velocity tracker (src/common_includes/bayesian/
bayesian.{h,cpp}) as the port serves it, written anew.

  slots      10 tracks, each remembering the (x, y) of the box it was
             given (the box's corner, as the reference passes it) in each
             of the last 5 frames, in a ring;
  append     a frame's detections in their order: the first frame ever puts
             detection i in slot i; later, each goes to the slot whose
             (x, y) in the previous frame lies nearest, closer than 100
             pixels, or to slot 0 where none does (bayesian.cpp's unused_id
             answers 0); a slot number of 10 or more ends the frame;
  predict    before a frame's detections are appended: one box a slot that
             holds a box in the latest frame, in slot order, named "P",
             10x10 pixels, conf 0.1; at (0, 0) until the ring has been
             filled once, else at the latest (x, y) moved by the sum,
             over the ring's length and rounded, of the three oldest of its
             four steps between consecutive frames, each counted where the
             later frame of the step holds the slot and the step is shorter
             than 100 pixels (bayesian.cpp:94-137).

The state can be taken over from another tracker (from_state) as arrays
x, y, used of shape (slots, 5), the next ring column "top", and whether the
ring is empty or has been filled.  It imports nothing of the port or of the
JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

SLOTS, HISTORY, REACH = 10, 5, 100.0
PREDICTED = ("P", 10, 10, 0.1)


class Tracker:
    def __init__(self):
        self.xy = np.zeros((HISTORY, SLOTS, 2), np.int64)
        self.held = np.zeros((HISTORY, SLOTS), bool)
        self.column = 0
        self.empty, self.filled = True, False

    @classmethod
    def from_state(cls, state: dict) -> "Tracker":
        t = cls()
        t.xy = np.stack([np.asarray(state["x"]).T,
                              np.asarray(state["y"]).T], -1).astype(np.int64)
        t.held = np.asarray(state["used"]).T.astype(bool)
        t.column = int(state["top"]) % HISTORY
        t.empty, t.filled = bool(state["queue_empty"]), \
            bool(state["queue_full"])
        return t

    def _latest(self) -> int:
        return (self.column - 1) % HISTORY

    def predict(self) -> List[tuple]:
        """(name, x, y, w, h, conf) of each predicted box."""
        name, w, h, conf = PREDICTED
        latest = self._latest()
        out = []
        for slot in np.flatnonzero(self.held[latest]):
            x = y = 0
            if self.filled:
                x, y = (int(self.xy[latest, slot, a])
                        + self._drift(slot, a) for a in (0, 1))
            out.append((name, x, y, w, h, conf))
        return out

    def _drift(self, slot: int, axis: int) -> int:
        total = 0.0
        latest = self._latest()
        for age in range(2, HISTORY):
            now = (latest + age) % HISTORY
            if not self.held[now, slot]:
                continue
            step = int(self.xy[now, slot, axis]) \
                - int(self.xy[(now - 1) % HISTORY, slot, axis])
            if abs(step) < REACH:
                total += step
        return int(round(total / HISTORY))

    def append(self, detections: Sequence[tuple]) -> None:
        """detections: (name, x, y, w, h, conf) each, x and y the box's
        corner as the tracker takes it."""
        col = self.column
        prev = self._latest()
        self.held[col] = False
        for i, (_, x, y, *_rest) in enumerate(detections):
            slot = i if self.empty else self._nearest(prev, x, y)
            if slot >= SLOTS:
                break
            self.held[col, slot] = True
            self.xy[col, slot] = (x, y)
        self.empty = False
        self.filled = self.filled or col == HISTORY - 1
        self.column = (col + 1) % HISTORY

    def _nearest(self, prev: int, x: int, y: int) -> int:
        best, best_d = 0, REACH
        for slot in np.flatnonzero(self.held[prev]):
            d = math.hypot(int(self.xy[prev, slot, 0]) - x,
                           int(self.xy[prev, slot, 1]) - y)
            if d < best_d:
                best, best_d = int(slot), d
        return best
