"""stereovision_tpu_torch — the PyTorch/CUDA port of stereovision_tpu.

A second package beside the JAX reference: the same ELAS stereo pipeline
(frames -> disparity -> point cloud) in PyTorch, with the four Pallas TPU
kernels of the reference replaced by CUDA C++ kernels for Hopper
(csrc/*.cu, bound in ops/cuda).  It imports neither jax nor
stereovision_tpu.

Which path runs is decided by the device a tensor lives on: on a CUDA
tensor every kernel wrapper launches its kernel; on a CPU tensor it runs
the kernel's plain PyTorch version.  The entry points default to the card
and raise when CUDA is absent; pass device="cpu" to run on the CPU.

Public surface:
  ElasParams / robotics_params / middlebury_params / app_params
  ElasEngine            — the core disparity pipeline (models/elas.py)
  StereoEngine          — frames -> disparity + point cloud (engine.py)
  StereoVision          — the reference pip package's class (engine.py)

Command line: python -m stereovision_tpu_torch --kitti DIR (cli.py).
"""

from .params import (ElasParams, robotics_params, middlebury_params,
                     app_params)

__all__ = [
    "ElasParams", "robotics_params", "middlebury_params", "app_params",
    "ElasEngine", "StereoEngine", "StereoVision",
]


def __getattr__(name):
    if name == "ElasEngine":
        from .models.elas import ElasEngine
        return ElasEngine
    if name in ("StereoEngine", "StereoVision"):
        from . import engine
        return getattr(engine, name)
    raise AttributeError(name)
