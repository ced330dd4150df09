"""Sharded execution of the stereo pipeline over a ('stream', 'tile') mesh
(counterpart of stereovision_tpu/parallel/shard.py:35-176).

The frame batch splits over 'stream': each stream group (a row of the
mesh) runs its frames on its first device.  Within a group, the kernels
split the rows over the group's 'tile' devices (parallel/ctx.py): K1, K2
and K4 launch once per row stripe with no halo, K3 runs banded with a
cross-stripe merge.

Row counts that do not divide the tile axis (KITTI's 375) are padded, as
in the JAX package: the engine runs in row_pad mode (models/elas.py), with
images of H + pad_in rows and outputs of Ho + pad_out rows, every op
keeping its row clamps and regions at the true height; real rows equal
the single-device engine's and padding rows are -10.

The glue between the kernels (descriptors, plane maps, gap interpolation,
the filters) runs on each stream group's first device, over the padded
frame: the port has no GSPMD to partition it over 'tile'.  Partitioning
the glue with a halo exchange is a later, speed-only step (ROADMAP.md).

The host middle runs in the engine's spawn pool, and its geometry reaches
each group's device as one packed (B, nbytes) buffer
(ElasEngine.pack_geometry), as on one device.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.elas import ElasEngine
from ..params import ElasParams
from ..transfer import upload
from . import ctx
from .mesh import Mesh, rank


class ShardedStereoPipeline:
    """Batched, mesh-sharded stereo pipeline.

    frames:   (B, H, W) uint8, B split over 'stream'; rows padded to
              H + pad_in and split over 'tile' by the kernels
    outputs:  disparity (B, Ho + pad_out, Wo) on the first device of the
              mesh (run) or of this process's first stream row
              (run_multihost); rows >= Ho are -10 (self.Ho = true rows)
    """

    def __init__(self, params: ElasParams, width: int, height: int,
                 mesh: Mesh):
        self.p = params
        self.mesh = mesh
        n_tile = int(mesh.shape["tile"])
        self.Ho, self.Wo = params.out_shape(width, height)
        self.pad_in = (-height) % n_tile
        self.pad_out = (-self.Ho) % n_tile
        self.engine = ElasEngine(params, width, height,
                                 device=mesh.devices[0, 0],
                                 row_pad=(self.pad_in, self.pad_out))

    def close(self):
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _pad_frames(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch)
        if self.pad_in == 0:
            return batch
        return np.pad(batch, ((0, 0), (0, self.pad_in), (0, 0)))

    def crop(self, D) -> np.ndarray:
        """Padded output -> (B, Ho, Wo) NumPy."""
        return D[:, :self.Ho].cpu().numpy()

    def _host_geometry_packed(self, d_cans: np.ndarray) -> np.ndarray:
        """Support grids -> (B, nbytes) packed geometry, through the
        engine's host process pool (one frame: in this process).  Warnings
        caught in the pool's processes are raised here."""
        e = self.engine
        gs = (e.host_mid_parallel(list(d_cans)) if len(d_cans) > 1
              else [e.host_mid(d_cans[0])])
        for g in gs:
            for msg in g.get("warnings", ()):
                warnings.warn("host geometry worker: " + msg)
        return np.stack([e.pack_geometry(g) for g in gs])

    def _run_groups(self, left, right, groups: Sequence[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage A for each stream group on its frames, the host middle
        of every frame, stage B for each group; returns the groups'
        padded maps concatenated on the first group's device."""
        e = self.engine
        pairs = np.stack([self._pad_frames(left), self._pad_frames(right)],
                         axis=1)
        if len(pairs) % len(groups):
            raise ValueError("batch %d not divisible by %d stream groups"
                             % (len(pairs), len(groups)))
        per = len(pairs) // len(groups)
        stages: List[tuple] = []
        for k, s in enumerate(groups):
            dev = self.mesh.devices[s, 0]
            with ctx.kernel_mesh(self.mesh.group(s)):
                stages.append(e.stage_support_batched(
                    pairs[k * per:(k + 1) * per], device=dev))
        d_cans = np.concatenate([dc.cpu().numpy() for _, _, dc in stages])
        buf = self._host_geometry_packed(d_cans)
        outs = []
        for k, s in enumerate(groups):
            dev = self.mesh.devices[s, 0]
            desc1, desc2, _ = stages[k]
            with ctx.kernel_mesh(self.mesh.group(s)):
                outs.append(e.stage_dense_batched(
                    desc1, desc2, upload(buf[k * per:(k + 1) * per], dev)))
        home = self.mesh.devices[groups[0], 0]
        return tuple(torch.cat([o[i].to(home) for o in outs])
                     for i in range(2))

    def run(self, left_batch: np.ndarray, right_batch: np.ndarray
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full step over every stream group of a one-process mesh:
        left/right_batch (B, H, W) uint8 -> (D1, D2) (B, Ho + pad_out, Wo)
        padded maps (see the class doc)."""
        if np.any(self.mesh.processes != rank()):
            raise ValueError("the mesh spans processes: use run_multihost")
        return self._run_groups(left_batch, right_batch,
                                range(self.mesh.shape["stream"]))

    def run_multihost(self, left_local: np.ndarray, right_local: np.ndarray
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of a multi-process mesh (parallel/mesh.py
        multihost_mesh): every process passes its own (B_local, H, W)
        frames, which split over its own stream rows, and gets its own
        (B_local, Ho + pad_out, Wo) padded maps.  Processes sit on
        'stream', so the data path needs no collective."""
        mine = [s for s in range(self.mesh.shape["stream"])
                if self.mesh.processes[s] == rank()]
        if not mine:
            raise ValueError("no stream row of the mesh is this process's")
        return self._run_groups(left_local, right_local, mine)
