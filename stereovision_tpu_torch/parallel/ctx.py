"""Mesh context: per-shard dispatch of the CUDA kernels (counterpart of
stereovision_tpu/parallel/ctx.py:43-89).

The JAX package wraps each Pallas call in `jax.shard_map`; here
shard_kernel is the torch analogue.  Under an active context the kernel
wrappers (ops/cuda/*_cu.py) split their inputs and launch once per shard,
with no halo, because every kernel but the speckle CCL is row-local:

  matching  (K1)  output-row stripes; each stripe reads the descriptor
                  rows clip(s y, 2, H - 3) of its rows and its cell rows
                  of the grid mask;
  support   (K2)  candidate-row stripes; each reads rows v -/+ 2 of its
                  candidate rows;
  LR check  (K4)  row stripes;
  CCL       (K3)  BANDED: each shard labels its own row stripe, then one
                  merge on the stream group's first device unites the
                  components across stripe edges (ops/cuda/ccl_cu.py).

The batch axis splits over 'stream'.  Each piece moves to its shard's
device (a view stays where it is: a mesh that repeats a device reads the
frame in place), the launch runs there on that device's current stream,
and the outputs are concatenated on the device of the first input.  On CPU
tensors the same split runs the plain versions per shard.

The context is thread-local.  With no context active, or a mesh of one
device, the wrappers launch exactly as before.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

_state = threading.local()


class P(tuple):
    """A partition spec: for each dimension of a tensor, None (whole),
    "stream" (split over the mesh's 'stream' axis), "tile" (split into
    row_ranges over 'tile') or a Stripes (explicit ranges over 'tile').
    An output spec uses None, "stream" and "tile": the dimensions the
    shards' outputs are concatenated along."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)


class Stripes:
    """One (lo, hi) range of a dimension per 'tile' shard, which may
    overlap (a stripe's input rows) or be empty (hi <= lo: the shard has
    no work and is not launched)."""

    def __init__(self, ranges: Sequence[Tuple[int, int]]):
        self.ranges = [(int(lo), int(hi)) for lo, hi in ranges]


class Shard(NamedTuple):
    """A shard's place in the mesh: its stream row and tile column."""
    stream: int
    tile: int


def current():
    """The mesh of the kernel_mesh context active in this thread, else
    None.  Its axes are always ("stream", "tile") (parallel/mesh.py)."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def kernel_mesh(mesh):
    """Activate per-shard kernel dispatch over `mesh` for code run inside
    the context (this thread only)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def active() -> bool:
    """Whether a context with more than one device is active: the wrappers
    then dispatch through shard_kernel."""
    mesh = current()
    return mesh is not None and mesh.size > 1


def row_multiple() -> int:
    """Number of 'tile' shards a row axis splits into (1 with no active
    context)."""
    mesh = current()
    return int(mesh.shape["tile"]) if mesh is not None else 1


def row_ranges(n: int):
    """n rows over the 'tile' shards: stripes of ceil(n / tiles) rows, the
    last ones shorter (the row axis padded to a multiple of the tile
    axis, the padding never computed)."""
    t = row_multiple()
    per = -(-n // t)
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(t)]


def batch_split(axis_size: int) -> int:
    """Local batch size per 'stream' shard (axis_size with no context)."""
    mesh = current()
    if mesh is None:
        return axis_size
    n_s = int(mesh.shape["stream"])
    if axis_size % n_s:
        raise ValueError(
            f"batch {axis_size} not divisible by stream shards {n_s}")
    return axis_size // n_s


def _on(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_kernel(launch, in_specs, out_specs, *args):
    """Run launch(shard, *pieces) once per shard of the active mesh (once,
    on the whole inputs, with no context).  in_specs: one P per tensor in
    args; out_specs: a P, or a tuple of P for several outputs.  Returns
    the outputs concatenated on args[0]'s device."""
    mesh = current()
    home = args[0].device
    if mesh is None:
        return launch(Shard(0, 0), *args)
    n_s, n_t = int(mesh.shape["stream"]), int(mesh.shape["tile"])
    several = not isinstance(out_specs, P)
    outs = (out_specs,) if not several else tuple(out_specs)

    def index(x, spec, s, t):
        if len(spec) != x.dim():
            raise ValueError("spec %s for a tensor of shape %s"
                             % (spec, tuple(x.shape)))
        idx = []
        for dim, ax in enumerate(spec):
            if ax == "stream":
                per = batch_split(x.shape[dim])
                idx.append((s * per, (s + 1) * per))
            elif ax == "tile":
                idx.append(row_ranges(x.shape[dim])[t])
            elif isinstance(ax, Stripes):
                if len(ax.ranges) != n_t:
                    raise ValueError("%d stripes over %d tile shards"
                                     % (len(ax.ranges), n_t))
                idx.append(ax.ranges[t])
            else:
                idx.append(None)
        return idx

    groups = []
    for s in range(n_s):
        parts = []
        for t in range(n_t):
            idx = [index(x, spec, s, t) for x, spec in zip(args, in_specs)]
            if any(r is not None and r[1] <= r[0] for i in idx for r in i):
                continue
            dev = mesh.devices[s, t]
            pieces = [x[tuple(slice(*r) if r else slice(None) for r in i)]
                      .to(dev) for x, i in zip(args, idx)]
            with _on(dev):
                out = launch(Shard(s, t), *pieces)
            out = (out,) if not several else tuple(out)
            parts.append([o.to(home) for o in out])
        groups.append([_cat([p[k] for p in parts], spec, "tile")
                       for k, spec in enumerate(outs)])
    result = tuple(_cat([g[k] for g in groups], spec, "stream")
                   for k, spec in enumerate(outs))
    return result if several else result[0]


def _cat(tensors, spec, axis):
    if len(tensors) == 1 or axis not in spec:
        return tensors[0]
    return torch.cat(tensors, dim=spec.index(axis))
