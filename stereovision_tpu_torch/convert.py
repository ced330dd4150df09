"""State carried across from the JAX package.

The stereo pipeline has no learned weights; what crosses over is its
parameter set, which arrives as a plain dict, and the detector's folded
convolution parameters, which arrive as NumPy arrays.  This module imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .params import ElasParams


def params_from_dict(d: Mapping) -> ElasParams:
    """dataclasses.asdict of a JAX-package ElasParams -> the port's
    ElasParams.  Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(ElasParams)}
    if set(d) != names:
        raise ValueError("parameter fields differ: unknown %s, missing %s"
                         % (sorted(set(d) - names), sorted(names - set(d))))
    return ElasParams(**dict(d))


def yolo_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX YoloV4Tiny's params ({conv layer index: an object with w, an
    HWIO NumPy array, and b}) -> the port's YoloV4Tiny state dict (w<i>
    OIHW, b<i>), for load_state_dict."""
    state = {}
    for i, conv in params.items():
        state["w%d" % i] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(conv.w, (3, 2, 0, 1))))
        state["b%d" % i] = torch.from_numpy(np.array(conv.b))
    return state
