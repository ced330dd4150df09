"""Device selection for the entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """None means the card.  Raises if a CUDA device is asked for (or
    defaulted to) and CUDA is absent: there is no silent CPU fallback —
    pass device="cpu" to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the PyTorch port on the CPU")
    return dev
