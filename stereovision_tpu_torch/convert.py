"""State carried across from the JAX package.

The pipeline has no learned weights; what crosses over is its state: the
parameter set and the host geometry that stage B consumes.  Both arrive as
plain Python/NumPy values, so this module imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .params import ElasParams

GEOMETRY_KEYS = ("pts", "tris_l", "tris_r", "tri_l", "tri_r")


def params_from_dict(d: Mapping) -> ElasParams:
    """dataclasses.asdict of a JAX-package ElasParams -> the port's
    ElasParams.  Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(ElasParams)}
    if set(d) != names:
        raise ValueError("parameter fields differ: unknown %s, missing %s"
                         % (sorted(set(d) - names), sorted(names - set(d))))
    return ElasParams(**dict(d))


def geometry_to_torch(g: Mapping[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """A JAX-package host_mid dict of NumPy arrays (pts, tris_l/r, span
    coded tri_l/r) -> tensors on `device`, in the order and dtypes the
    port's ElasEngine.stage_dense takes."""
    return {k: torch.as_tensor(np.ascontiguousarray(g[k]), device=device)
            for k in GEOMETRY_KEYS}
