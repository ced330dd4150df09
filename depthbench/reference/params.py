"""Parameter sets for the ELAS stereo pipeline (PyTorch port).

A copy of stereovision_tpu/params.py: the port keeps its own so that it never
imports the JAX package.  Mirrors the 24 tunables of the reference
`Elas::parameters` (reference: src/serial_includes/elas/elas.h:60-145) with
the two presets ROBOTICS and MIDDLEBURY.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElasParams:
    """Static algorithm parameters.  Defaults = ROBOTICS preset."""

    disp_min: int = 0
    disp_max: int = 255
    support_threshold: float = 0.85
    support_texture: int = 10
    candidate_stepsize: int = 5
    incon_window_size: int = 5
    incon_threshold: int = 5
    incon_min_support: int = 5
    add_corners: bool = False
    grid_size: int = 20
    beta: float = 0.02
    gamma: float = 3.0
    sigma: float = 1.0
    sradius: float = 2.0
    match_texture: int = 1
    lr_threshold: int = 2
    speckle_sim_threshold: float = 1.0
    speckle_size: int = 200
    ipol_gap_width: int = 3
    filter_median: bool = False
    filter_adaptive_mean: bool = True
    postprocess_only_left: bool = True
    subsampling: bool = False

    # ---- derived quantities -------------------------------------------------

    @property
    def disp_num(self) -> int:
        """Number of disparities (grid_dims[0]-1 in the reference)."""
        return self.disp_max + 1

    @property
    def plane_radius(self) -> int:
        """Half-width of the plane-prior disparity window
        (reference: elas.cpp:832)."""
        return int(max(math.ceil(self.sigma * self.sradius), 2.0))

    @property
    def step(self) -> int:
        """Support candidate grid step; forced even under subsampling
        (reference: elas.cpp:376-378)."""
        s = self.candidate_stepsize
        if self.subsampling:
            s += s % 2
        return s

    def prior_table(self) -> np.ndarray:
        """Negative-log plane prior LUT P[delta_d], int32, all values <= 0
        (reference: elas.cpp:828-831; C cast truncates toward zero)."""
        disp_num = self.disp_num
        two_sigma_sq = 2.0 * self.sigma * self.sigma
        delta = np.arange(disp_num, dtype=np.float64)
        p = (-np.log(self.gamma + np.exp(-delta * delta / two_sigma_sq))
             + np.log(self.gamma)) / self.beta
        return np.trunc(p).astype(np.int32)

    def grid_dims(self, width: int, height: int) -> Tuple[int, int]:
        """(grid_width, grid_height) of the disparity candidate grid
        (reference: elas.cpp:88-89)."""
        gw = int(math.ceil(width / float(self.grid_size)))
        gh = int(math.ceil(height / float(self.grid_size)))
        return gw, gh

    def out_shape(self, width: int, height: int) -> Tuple[int, int]:
        """Disparity output (H, W); halved under subsampling
        (reference: elas.h:83-85, rounded toward zero)."""
        if self.subsampling:
            return height // 2, width // 2
        return height, width

    def replace(self, **kw) -> "ElasParams":
        return dataclasses.replace(self, **kw)


def middlebury_params(**kw) -> ElasParams:
    """MIDDLEBURY preset (reference: elas.h:119-143)."""
    base = dict(
        disp_min=0,
        disp_max=255,
        support_threshold=0.95,
        support_texture=10,
        candidate_stepsize=5,
        incon_window_size=5,
        incon_threshold=5,
        incon_min_support=5,
        add_corners=True,
        grid_size=20,
        beta=0.02,
        gamma=5.0,
        sigma=1.0,
        sradius=3.0,
        match_texture=0,
        lr_threshold=2,
        speckle_sim_threshold=1.0,
        speckle_size=200,
        ipol_gap_width=5000,
        filter_median=True,
        filter_adaptive_mean=False,
        postprocess_only_left=False,
        subsampling=False,
    )
    base.update(kw)
    return ElasParams(**base)


def app_params(subsampling: bool = False) -> ElasParams:
    """The parameter set the reference application actually runs with:
    MIDDLEBURY + postprocess_only_left + adaptive mean
    (reference: src/serial_includes/main/stereo_vision.cpp:307-311; note
    filter_median stays enabled from the MIDDLEBURY preset)."""
    return middlebury_params(
        postprocess_only_left=True,
        filter_adaptive_mean=True,
        subsampling=subsampling,
    )
