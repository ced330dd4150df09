"""Files of the benchmark found by kind and name: <kind>/<name><ext> in the
first directory of DIRS that has it, each laid out as depthbench/ is
(configs/, traffic/, drivers/, checks/, metrics/).  A cell, a reading or a
metric is added by adding such a file; a test puts its own directory
before depthbench/ in DIRS."""

from __future__ import annotations

import importlib.util
import os
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# the directories searched, in order
DIRS = [HERE]


def find(kind: str, name: str, ext: str = ".py") -> Optional[str]:
    """The path of <kind>/<name><ext>, or None where no directory has it."""
    for d in DIRS:
        path = os.path.join(d, kind, name + ext)
        if os.path.isfile(path):
            return path
    return None


def load_module(kind: str, name: str):
    """<kind>/<name>.py as a module (names may hold dots)."""
    path = find(kind, name, ".py")
    if path is None:
        raise LookupError("no %s named %r (%s)" % (
            kind, name, os.path.join(HERE, kind, name + ".py")))
    spec = importlib.util.spec_from_file_location(
        "depthbench_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
