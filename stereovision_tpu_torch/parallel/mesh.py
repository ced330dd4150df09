"""Device meshes for multi-device and multi-process runs (counterpart of
stereovision_tpu/parallel/mesh.py:23-86).

A Mesh is a (stream, tile) array of torch.device with axis names
("stream", "tile"):
  'stream'  frame data parallelism (independent stereo pairs),
  'tile'    row stripes within a frame (epipolar matching is row-local).
A mesh may repeat a device ([cuda:0] * 4 on one card, [cpu] * 8 in the
tests): the port's counterpart of --xla_force_host_platform_device_count.
Across processes (torch.distributed), whole processes sit on 'stream' and
each process's local devices on 'tile'; a 'tile' axis that crosses
processes is not supported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A (stream, tile) array of devices; `processes[s]` is the rank of the
    process that owns stream row s (0 in a single process)."""

    axis_names = ("stream", "tile")

    def __init__(self, devices, processes: Optional[Sequence[int]] = None):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError("a mesh is a non-empty (stream, tile) array")
        kinds = {d.type for d in arr.ravel()}
        if len(kinds) > 1:
            raise ValueError("a mesh mixes device types %s" % sorted(kinds))
        self.devices = arr
        n_s = arr.shape[0]
        self.processes = np.asarray(
            [0] * n_s if processes is None else processes, dtype=int)
        if self.processes.shape != (n_s,):
            raise ValueError("one process rank per stream row")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def group(self, s: int) -> "Mesh":
        """Stream row s as a (1, tile) mesh."""
        return Mesh(self.devices[s:s + 1], self.processes[s:s + 1])

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, [[str(d) for d in row]
                                              for row in self.devices])


def cuda_devices():
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, stream: Optional[int] = None,
              tile: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('stream', 'tile') mesh over `devices` (default: every visible
    CUDA device).  All devices go on 'stream' unless `tile` or `stream` is
    given; stream * tile must equal the device count."""
    devs = list(cuda_devices() if devices is None else devices)
    if not devs:
        raise RuntimeError("no CUDA device is visible; pass devices= (for "
                           "example [torch.device('cpu')] * 8)")
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError("%d devices asked for, %d given" % (n, len(devs)))
    devs = devs[:n]
    if tile is None and stream is None:
        stream, tile = n, 1
    elif stream is None:
        stream = n // tile
    elif tile is None:
        tile = n // stream
    if stream * tile != n:
        raise ValueError("stream %d x tile %d != %d devices"
                         % (stream, tile, n))
    return Mesh([devs[s * tile:(s + 1) * tile] for s in range(stream)])


def rank() -> int:
    """This process's rank (0 without torch.distributed)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def process_devices(k: int, device: str = "cuda", num_processes: int = 1,
                    process_id: int = 0):
    """The k local devices of one process on this host: k CPU devices; or
    k distinct GPUs where the host has k for every process; or the
    process's own GPU k times where it has one for every process; or
    cuda:0 k times."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * k
    n = torch.cuda.device_count()
    if n >= num_processes * k:
        return [torch.device("cuda", process_id * k + i) for i in range(k)]
    if n >= num_processes:
        return [torch.device("cuda", process_id)] * k
    return [torch.device("cuda", 0)] * k


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device: str = "cuda") -> str:
    """Join the multi-process job: every process calls this once, with the
    same "host:port" and its own id.  The backend is gloo for CPU meshes,
    nccl where each process owns GPUs of its own (it then makes its first
    one current), gloo where processes share a GPU.  Returns the
    backend."""
    import torch.distributed as dist
    kind = torch.device(device).type
    backend = ("nccl" if kind == "cuda"
               and torch.cuda.device_count() >= num_processes else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_devices(
            1, device, num_processes, process_id)[0])
    dist.init_process_group(backend, init_method="tcp://"
                            + coordinator_address, world_size=num_processes,
                            rank=process_id)
    return backend


def multihost_mesh(stream: Optional[int] = None, tile: Optional[int] = None,
                   local_devices: Optional[Sequence] = None) -> Mesh:
    """The global ('stream', 'tile') mesh over every process's local
    devices (default: every visible CUDA device), after init_distributed.
    The default layout puts whole processes on 'stream' and each
    process's devices on 'tile'.  Every process must have the same number
    of local devices; a layout whose 'tile' axis crosses processes raises
    NotImplementedError."""
    import torch.distributed as dist
    local = [str(torch.device(d)) for d in
             (cuda_devices() if local_devices is None else local_devices)]
    world = dist.get_world_size()
    every = [None] * world
    dist.all_gather_object(every, local)
    k = len(local)
    if any(len(x) != k for x in every):
        raise ValueError("processes hold different numbers of devices: %s"
                         % [len(x) for x in every])
    n = world * k
    if stream is None and tile is None:
        stream, tile = world, k
    elif stream is None:
        stream = n // tile
    elif tile is None:
        tile = n // stream
    if stream * tile != n:
        raise ValueError("stream %d x tile %d != %d devices"
                         % (stream, tile, n))
    if tile > k or k % tile:
        raise NotImplementedError(
            "a 'tile' axis of %d across processes of %d devices each: the "
            "port shards rows only within a process" % (tile, k))
    flat = [d for x in every for d in x]
    rows = [flat[s * tile:(s + 1) * tile] for s in range(stream)]
    return Mesh(rows, [s * tile // k for s in range(stream)])


def local_batch_indices(global_batch: int, mesh: Mesh) -> np.ndarray:
    """Batch indices this process owns when the batch splits over
    'stream'."""
    n_s = mesh.shape["stream"]
    per = global_batch // n_s
    mine = [s for s in range(n_s) if mesh.processes[s] == rank()]
    return np.concatenate([np.arange(s * per, (s + 1) * per) for s in mine]
                          or [np.zeros(0, dtype=int)])
