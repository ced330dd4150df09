"""The host middle's side worker: one spawned process that computes the
right image's half of a frame's host middle (geometry.host_side: Delaunay,
the triangle-id raster and its span code) while the caller computes the
left's (geometry.host_mid(..., side=worker)).

Each half depends only on the final support points, so the two can run
at once, and the worker gives the bytes the caller would: Qhull's output
is the same for the same float64 input on the same interpreter, and the
worker takes a half only where it runs the same host code as the caller
(the native library loaded in both, or in neither).

The overlap pays only where the two halves run on two cores.  A woken
process may be put on its waker's core, and the caller does not block
while the worker computes, so the worker pins itself, from inside, to
one CPU of the process's allowed set, taken from the end of the set
round-robin over the workers this process starts; the caller and the
machine are left as they are.  Where the set has fewer than two CPUs no
worker is started.

The hand-off is synchronous over a Pipe: the points go before the left
half starts, the right half comes back after it ends.  Not an executor,
whose helper threads need the GIL while the caller is inside scipy.  The
worker is started without waiting for it: until it reports ready (its
imports done, pinned, the native library loaded), while another thread
holds it, and once it has died, a frame runs both halves in the caller.

This module imports no torch, as geometry.py.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import threading
import weakref
from typing import List, Optional, Tuple

import numpy as np

from .. import profiling as P
from . import geometry, raster

# the workers started by this process, for the round-robin over CPUs
_STARTED = itertools.count()


def _natives() -> Tuple[bool, bool]:
    """Whether the rasterizer and the span coder run natively here, each
    by the get_lib its module calls."""
    return raster.get_lib() is not None, geometry.get_lib() is not None


def _serve(conn, cpu: int, host_args: tuple) -> None:
    """The worker's loop: pin to cpu, report ready with _natives(), then
    answer each (points, trace) with the right half's (tris, span code,
    runs, notes, spans) until None or the caller's end of the pipe
    closes.  A half that raises is answered None: the caller computes it
    and raises there."""
    os.sched_setaffinity(0, {cpu})
    params, width, height, _, t_max, s_max, _ = host_args
    conn.send(_natives())
    while True:
        try:
            job = conn.recv()
        except EOFError:
            return
        if job is None:
            return
        pts, trace = job
        notes: List[str] = []
        if trace:
            P.trace_start()
        try:
            reply = geometry.host_side(pts, True, params, width, height,
                                       t_max, s_max, notes) + (notes,)
        except Exception:
            reply = None
        finally:
            if trace:
                P.trace_stop()
        spans = P.trace_drain()["spans"] if trace else []
        conn.send(None if reply is None else reply + (spans,))


def _stop(proc, conn) -> None:
    """Ask the worker to end, kill it where it does not within 10 s."""
    try:
        conn.send(None)
    except OSError:
        pass
    proc.join(timeout=10)
    if proc.exitcode is None:
        proc.kill()
        proc.join()
    conn.close()


class SideWorker:
    """One spawned process computing the right half of the host middle of
    an engine (its host_args), pinned to `cpu`.  submit() and result()
    hand one frame's half off and take it back; close() ends the process
    (as does garbage collection of the worker)."""

    def __init__(self, host_args: tuple, cpu: int):
        # spawn, never fork: the caller holds a CUDA context
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_serve, args=(child, cpu, host_args),
                                 name="svtt-side", daemon=True)
        self._proc.start()
        child.close()
        self.cpu = cpu
        self.pid = self._proc.pid
        self._lock = threading.Lock()
        # the worker's _natives() once it reported ready
        self._natives: Optional[Tuple[bool, bool]] = None
        self._dead = False
        self._stop = weakref.finalize(self, _stop, self._proc, self._conn)

    def _poll_ready(self, timeout: float) -> bool:
        if self._natives is None and not self._dead:
            try:
                if self._conn.poll(timeout):
                    self._natives = self._conn.recv()
            except (EOFError, OSError):
                self._dead = True
        return self._natives is not None and not self._dead

    def ready(self, timeout: float = 0.0) -> bool:
        """Whether the worker has reported ready and not died, waiting up
        to timeout seconds for its report."""
        with self._lock:
            return self._poll_ready(timeout)

    def submit(self, pts: np.ndarray, trace: bool) -> bool:
        """Hand the right half of the support points pts to the worker
        (trace: it records its spans); True where it took it, and result()
        must follow.  False, at once, where another thread holds the
        worker, where it is not ready or has died, and where it runs other
        host code than this process."""
        if not self._lock.acquire(blocking=False):
            return False
        handed = False
        try:
            if self._poll_ready(0) and self._natives == _natives():
                self._conn.send((pts, trace))
                handed = True
        except OSError:             # BrokenPipeError: the worker died
            self._dead = True
        except BaseException:       # an interrupted send: out of step
            self._dead = True
            raise
        finally:
            if not handed:
                self._lock.release()
        return handed

    def result(self):
        """The half of the last submit(): (tris, span code, runs, notes,
        spans), or None where the worker died or the half raised there
        (the caller then computes it).  Releases the worker."""
        try:
            return self._conn.recv()
        except (EOFError, OSError):
            self._dead = True
            return None
        except BaseException:       # an interrupted reply: out of step
            self._dead = True
            raise
        finally:
            self._lock.release()

    def close(self) -> None:
        """End the worker, after the frame that holds it.  Idempotent."""
        with self._lock:
            self._dead = True
            self._stop()


def start(host_args: tuple) -> Optional[SideWorker]:
    """A SideWorker for an engine's host_args, on the next CPU of this
    process's allowed set counted from its end; None where the set has
    fewer than two CPUs."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return None
    return SideWorker(host_args, cpus[-1 - next(_STARTED) % len(cpus)])
