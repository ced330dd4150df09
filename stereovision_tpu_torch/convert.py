"""State carried across from the JAX package.

The pipeline has no learned weights; what crosses over is its state: the
parameter set, which arrives as a plain dict, so this module imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from .params import ElasParams


def params_from_dict(d: Mapping) -> ElasParams:
    """dataclasses.asdict of a JAX-package ElasParams -> the port's
    ElasParams.  Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(ElasParams)}
    if set(d) != names:
        raise ValueError("parameter fields differ: unknown %s, missing %s"
                         % (sorted(set(d) - names), sorted(names - set(d))))
    return ElasParams(**dict(d))
