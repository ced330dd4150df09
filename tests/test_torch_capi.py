"""The port's C ABI (stereovision_tpu_torch/capi.py and
csrc/svtpu_capi.cpp) held against the JAX package's StereoVision.

On the CPU the library is loaded via ctypes into this interpreter (the
PyGILState join path), with capi.DEVICE = "cpu" set before the first call,
and driven exactly as the reference's pip wrapper drives its .so
(stereo_vision/sv.py:164-192): the cloud equals the JAX package's, a second
frame in a new buffer gives a valid cloud and its own colours (the JAX
package's colour cache is a read-only view of the first caller buffer),
clean() and re-initialisation.  The plain C program that boots CPython
itself (csrc/capi_example.c) runs the engine on the card: it is in
tests/test_torch_kernels.py, which imports no JAX.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
from numpy.ctypeslib import ndpointer

import stereovision_tpu.engine as jengine

from stereovision_tpu_torch import capi
from stereovision_tpu_torch.synthetic import stereo_pair

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 160, 120


def _bgra(bgr):
    return np.ascontiguousarray(np.concatenate(
        [bgr, np.full(bgr.shape[:2] + (1,), 255, np.uint8)], axis=-1))


@pytest.fixture
def lib(monkeypatch):
    monkeypatch.setattr(capi, "DEVICE", "cpu")
    lib = ctypes.CDLL(capi.library_path(), mode=ctypes.RTLD_GLOBAL)
    lib.generatePointCloud.restype = ndpointer(dtype=ctypes.c_double,
                                               shape=(W * H, 3))
    # the frames as pointers: bytes, or the address of a caller buffer
    lib.generatePointCloud.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_bool, ctypes.c_bool, ctypes.c_bool, ctypes.c_bool,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_bool, ctypes.c_bool]
    lib.getColor.restype = ctypes.c_void_p
    lib.getColor.argtypes = []
    lib.clean.restype = None
    lib.clean.argtypes = []
    yield lib
    lib.clean()


def _args(left, right):
    return (left, right, b"", W, H, True, False, False, False, 1, 1, b"",
            b"", b"", False, False)


def _colors(lib):
    addr = lib.getColor()
    assert addr
    return np.ctypeslib.as_array((ctypes.c_uint8 * (W * H * 4))
                                 .from_address(addr)).reshape(H, W, 4)


def test_ctypes_surface_matches_jax_stereo_vision(lib, capsys):
    """The same frames through the C ABI (ctypes join path) and the JAX
    package's StereoVision: the same float64 cloud, bit for bit; the second
    call reuses the engine and refreshes the same buffer; clean() and a new
    first call give the same cloud again."""
    left, right, _ = stereo_pair(W, H, seed=7)
    Lb, Rb = _bgra(left), _bgra(right)
    assert lib.getColor() is None
    pts = lib.generatePointCloud(*_args(Lb.tobytes(), Rb.tobytes()))
    assert pts.shape == (W * H, 3) and pts.dtype == np.float64
    assert np.isfinite(pts).mean() > 0.9
    np.testing.assert_array_equal(_colors(lib), Lb)

    sv = jengine.StereoVision(width=W, height=H, objectTracking=False)
    ref = sv.generatePointCloud(Lb, Rb)
    np.testing.assert_array_equal(pts, ref)

    addr = pts.ctypes.data
    pts2 = lib.generatePointCloud(*_args(Lb.tobytes(), Rb.tobytes()))
    assert pts2.ctypes.data == addr
    np.testing.assert_array_equal(pts2, ref)

    lib.clean()
    assert lib.getColor() is None
    pts3 = lib.generatePointCloud(*_args(Lb.tobytes(), Rb.tobytes()))
    np.testing.assert_array_equal(pts3, ref)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and all(l.startswith("(FPS=") for l in lines)


def test_second_frame_in_a_new_buffer(lib):
    """Two frames from two different caller buffers, the first freed
    before the second call: each call returns that frame's cloud (the port
    on the CPU, held to the JAX engine above), and getColor the second
    frame's colours from memory the library owns."""
    from stereovision_tpu_torch.engine import StereoEngine, DEFAULT_CALIB
    eng = StereoEngine(DEFAULT_CALIB, W, H, device="cpu")
    for seed in (8, 9):
        left, right, _ = stereo_pair(W, H, seed=seed)
        Lb, Rb = _bgra(left), _bgra(right)
        lbuf = ctypes.create_string_buffer(Lb.tobytes(), Lb.nbytes)
        rbuf = ctypes.create_string_buffer(Rb.tobytes(), Rb.nbytes)
        pts = lib.generatePointCloud(*_args(ctypes.addressof(lbuf),
                                            ctypes.addressof(rbuf)))
        ref = eng.process_frame(left, right)["points"].astype(np.float64)
        np.testing.assert_array_equal(pts, ref)
        ctypes.memset(lbuf, 0, Lb.nbytes)            # the caller reuses it
        del lbuf, rbuf
        np.testing.assert_array_equal(_colors(lib), Lb)
    eng.close()


def test_capi_imports_no_jax():
    code = ("import sys\n"
            "import stereovision_tpu_torch.capi as capi\n"
            "capi.library_path()\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'stereovision_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
