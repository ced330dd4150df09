"""The one intra-op thread cap of the port's test modules.

Every tests/test_torch_*.py imports the fixture, autouse, into its own
namespace:

    from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread a torch call while the importing module runs,
    the old count restored after it: other test workers share the
    machine's cores, and oversubscribed intra-op threads slowed the
    1242x375 cases many times over.  The suite runs six workers on eight
    cores, and torch starts one intra-op thread a core in each: uncapped,
    tests/test_torch_graphs.py took 843.9 s in the suite against 24.2 s
    alone, tests/test_torch_profiling.py 733.7 s against 29.2 s, and
    tests/test_torch_hostlib.py 567.3 s against 37.6 s (junit times; one
    160x120 process_frame test 183 s in the suite, 0.4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
