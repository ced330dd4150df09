"""Building the port's native libraries from the sources in csrc/.

Both libraries have a plain C interface and are loaded with ctypes: the
host helpers (svtpu_host.cpp, built with g++) and the CUDA kernels
(*.cu, built with nvcc for sm_90a).  They are built at first use into
build/stereovision_tpu_torch/ beside the package (a git-ignored directory),
under a name that carries a digest of the sources, so an edited source is
rebuilt and a stale library is never loaded.  Concurrent builds (test
workers) each build in a private temporary directory and rename the result
into place, which is atomic.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Callable, List, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "stereovision_tpu_torch")


def _digest(paths: Sequence[str], flags: Sequence[str]) -> str:
    h = hashlib.sha1()
    for path in paths:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _run_all(cmds: List[List[str]], cwd: str) -> None:
    """Run the commands in parallel; raise with their output if any fails."""
    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("$ %s\n%s" % (" ".join(cmd), out))
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))


def build_library(name: str, sources: Sequence[str], flags: Sequence[str],
                  commands: Callable[[str], List[List[List[str]]]]) -> str:
    """Build (or find already built) BUILD_DIR/lib<name>-<digest>.so.

    commands(tmpdir) returns the build as a list of stages, each a list of
    commands run in parallel inside tmpdir; the last stage must write
    tmpdir/out.so."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = os.path.join(BUILD_DIR, "lib%s-%s.so"
                          % (name, _digest(sources, flags)))
    if os.path.exists(target):
        return target
    tmp = tempfile.mkdtemp(prefix=name + "-", dir=BUILD_DIR)
    try:
        for stage in commands(tmp):
            _run_all(stage, tmp)
        os.replace(os.path.join(tmp, "out.so"), target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target
