"""The benchmark's own tests: python -m pytest depthbench/tests (from the
repository's root, in one process: they start spawn pools; not collected
by `pytest tests/`).  Those marked cuda run on a card."""

import os
import sys

# one thread for the CPU math libraries, as depthbench/run.py sets them
# (the spawn pools' workers inherit it)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
