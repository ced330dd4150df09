"""The cloud's resize at pc_extrapolation=3, full resolution, KITTI size:
the one place where the port and the JAX package may differ, pinned down.

jax.image.resize(..., "linear") contracts the (375, 1242) display
disparity with two weight matrices.  Jitted on the CPU, XLA hands the
375-long row contraction to a blocked matrix product that sums input rows
[0, 192) and [192, 375) as two partial sums: an output whose two taps
straddle rows 191 and 192 comes out as round(w0*x0) + round(w1*x1), where
every other output is fma(w1, x1, w0*x0), the form ops/reproject.py
computes.  Where the boundary falls is not a function of the contraction's
length alone (measured: 289 rows split at 288, 290 and 300 not at all, 375
at 192, 400 at 200, 500 at 256), so the port keeps one form and this test
states the bound.  Every other resize the engine runs at KITTI size
(pc_extrapolation 1-3, both modes) is exact: see test_torch_engine.py and
the cases below.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereovision_tpu_torch.ops.reproject import linear_taps, resize_linear

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)


def _jax_resize(x, shape):
    return np.asarray(jax.jit(lambda a: jax.image.resize(
        a.astype(jnp.float32), shape, "linear"))(jnp.asarray(x)))


def _port_resize(x, shape):
    taps = [linear_taps(n, m, "cpu") if n != m else None
            for n, m in zip(x.shape, shape)]
    return resize_linear(torch.as_tensor(x).float(), *taps).numpy()


def test_resize_by_3_at_kitti_size_is_bounded():
    """A random (375, 1242) uint8 map resized to (1125, 3726): equal bit
    for bit except on the output rows whose taps straddle input rows 191
    and 192, and there each value is the port's fma form or the two-block
    sum, at most one ulp (1.53e-5 for values in [128, 256)) apart.
    Measured on the CPU: 884 of 4,191,750 values differ."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (375, 1242)).astype(np.uint8)
    ref = _jax_resize(x, (1125, 3726))
    out = _port_resize(x, (1125, 3726))
    i0, i1, w0, w1 = (t.numpy() for t in linear_taps(375, 1125, "cpu"))
    straddle = (i0 < 192) & (i1 >= 192) & (w1 != 0)
    assert np.nonzero(straddle)[0].tolist() == [575, 576]
    diff = out != ref
    assert not diff[~straddle].any()
    cols = _port_resize(x, (375, 3726))       # the column pass, exact
    two_blocks = (w0[:, None] * cols[i0]) + (w1[:, None] * cols[i1])
    rows = np.nonzero(straddle)[0]
    assert ((ref[rows] == out[rows]) | (ref[rows] == two_blocks[rows])).all()
    assert diff.sum() <= 2 * 3726
    assert np.abs(out - ref).max() <= 2.0 ** -16


@pytest.mark.parametrize("shape_in,shape_out", [
    ((375, 1242), (750, 2484)),      # full resolution, pc_extrapolation=2
    ((187, 621), (375, 1242)),       # subsampled, 1
    ((187, 621), (750, 2484)),       # subsampled, 2
    ((187, 621), (1125, 3726)),      # subsampled, 3
])
def test_other_kitti_resizes_are_exact(shape_in, shape_out):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, shape_in).astype(np.uint8)
    np.testing.assert_array_equal(_port_resize(x, shape_out),
                                  _jax_resize(x, shape_out))
