"""Build and bind the CUDA kernels (csrc/*.cu) for the wrappers in this
package.

The sources (the four kernels and floor.cu, two kernels that measure the
launch floor) are compiled in parallel with nvcc for sm_90a and linked
into one shared library with a plain C interface, loaded with ctypes; every
C entry point launches on the stream it is given and returns the CUDA error
code of the launch.  --fmad=false keeps float code meaning exactly what the
source says (no contraction into fused multiply-adds).  Nothing here runs at
import: the library is built at the first kernel launch.

The streaming paths launch from several threads: the first build and the
wrappers' launch counters are guarded by locks (the counters are
read-modify-writes), and each launch goes to the calling thread's current
stream.  Under a CUDA graph capture (graphs.py) a wrapper's call launches
nothing: within recording() the calling thread's counts are recorded, and
each replay of the graph adds them (add_counts).

Under a mesh (parallel/ctx.py) the wrappers launch once per row stripe,
on views of the frame where the stripe's device is the frame's: K1, K2
and K4 take frame and plane strides (layout), and each stripe launch
counts as one.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading

import torch

from ...native import CSRC_DIR, build_library

SOURCES = ("support.cu", "matching.cu", "lr.cu", "ccl.cu", "floor.cu")
HEADERS = ("svtt_cuda.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: argtypes (every function returns the launch's cudaError_t)
    "svtt_support_scan": [_P, _P, _I, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P, _P],
    "svtt_support_max_span": [_P],
    "svtt_match_keys": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _L,
                        _L, _I, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P, _P],
    "svtt_match_max_span": [_I, _I, _I, _P],
    "svtt_lr_check": [_P, _P, _I, _I, _I, _L, _F, _F, _P, _P, _P],
    "svtt_lr_max_width": [_P],
    "svtt_empty": [_P],
    "svtt_spin": [_L, _P],
    "svtt_speckle": [_P, _I, _I, _I, _F, _I, _P, _P, _P, _P],
    "svtt_speckle_stripe": [_P, _I, _I, _I, _L, _F, _I, _I, _I, _P, _P],
    "svtt_speckle_merge": [_P, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P],
}
_build_lock = threading.Lock()
_count_lock = threading.Lock()
_recording = threading.local()
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME "
                           "or /usr/local/cuda): the CUDA kernels cannot be "
                           "built")
    return path


def _commands(nvcc: str):
    def stages(tmp: str):
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        compile_all = [[nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, s),
                        "-o", o] for s, o in zip(SOURCES, objs)]
        link = [[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 *objs, "-o", "out.so"]]
        return [compile_all, link]
    return stages


def kernels() -> ctypes.CDLL:
    """The kernel library, built on first use (once, whichever thread
    comes first)."""
    global _lib
    with _build_lock:
        if _lib is None:
            paths = [os.path.join(CSRC_DIR, s) for s in SOURCES + HEADERS]
            lib = ctypes.CDLL(build_library("svtt_kernels", paths, NVCC_FLAGS,
                                            _commands(nvcc_path())))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def count(namespace: dict, key: str = "launches") -> None:
    """Add one to a wrapper module's `launches` (pass its globals()), or
    to its counter `key`, under a lock; within recording() on this thread,
    record the launch instead."""
    rec = getattr(_recording, "counts", None)
    if rec is not None:
        rec.append((namespace, key))
        return
    with _count_lock:
        namespace[key] += 1


@contextlib.contextmanager
def recording():
    """Within the block, this thread's count() calls are recorded, not
    added: yields the list of (namespace, key) they append to (a graph
    capture, whose launches run only when the graph is replayed)."""
    _recording.counts = rec = []
    try:
        yield rec
    finally:
        _recording.counts = None


def add_counts(recorded) -> None:
    """Add the counts that recording() recorded (one replay of a graph)."""
    with _count_lock:
        for namespace, key in recorded:
            namespace[key] += 1


def frames(t: torch.Tensor, single_ndim: int) -> int:
    """Frames in a kernel input: 1 for a single frame (single_ndim
    dimensions), else the leading batch dimension."""
    if t.dim() == single_ndim:
        return 1
    if t.dim() != single_ndim + 1:
        raise ValueError("expected %d or %d dimensions, got shape %s"
                         % (single_ndim, single_ndim + 1, tuple(t.shape)))
    return t.shape[0]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def layout(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           planes: bool = False) -> tuple:
    """Raise unless t is a CUDA tensor of this dtype and shape whose rows
    are contiguous (a view of whole rows, such as a row stripe of a frame
    or of a batch; a vector: contiguous); returns (frame stride, plane
    stride) in elements: the leading dimension's stride (for one frame:
    the frame's size) and, with `planes`, the stride of the dimension
    before the rows (else 0)."""
    if t.device.type != "cuda":
        raise ValueError("%s must be a CUDA tensor, got %s" % (name, t.device))
    if t.dtype != dtype:
        raise ValueError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s must have shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if t.dim() < 2:
        if t.numel() > 1 and t.stride(-1) != 1:
            raise ValueError("%s must be contiguous" % name)
        return t.numel(), 0
    rows, cols = t.shape[-2:]
    if t.stride(-1) != 1 or (rows > 1 and t.stride(-2) != cols):
        raise ValueError("%s must be a view of whole contiguous rows" % name)
    inner = 3 if planes else 2
    plane = t.stride(-3) if planes else 0
    if planes and t.shape[-3] > 1 and plane < rows * cols:
        raise ValueError("%s: planes overlap" % name)
    frame = (t.stride(0) if t.dim() > inner
             else (t.shape[-3] * plane if planes else rows * cols))
    return frame, plane


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError("%s: kernel launch failed with CUDA error %d"
                           % (name, err))


def empty() -> None:
    """Launch the empty kernel of floor.cu on the current stream: the
    launch floor of this library."""
    check(kernels().svtt_empty(stream()), "empty")


def spin(ms: float) -> None:
    """Hold the current stream for `ms` milliseconds with a one-thread
    kernel (floor.cu)."""
    check(kernels().svtt_spin(int(ms * 1e6), stream()), "spin")
