"""ElasEngine.process at the main path's full width, 1242x375 under
app_params(subsampling=True) (D = 256), on the (187, 621) half lattice,
bit for bit against the JAX package
(tests/test_torch_engine.py:elas_full_width_kitti).  A file of its own, so
that a test worker of its own runs it."""

import pytest

from test_torch_engine import _one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_engine import elas_full_width_kitti


@pytest.mark.parametrize("subsampling", [True])
def test_elas_process_full_width_kitti(subsampling):
    elas_full_width_kitti(subsampling)
