"""Host <-> device copies that do not stall a pipeline.

A copy from pageable host memory to the card synchronises the stream and
blocks the host thread; one from pinned memory with non_blocking=True is
only enqueued.  upload() and fetch() go through pinned buffers (PyTorch's
caching host allocator, which keeps a buffer until the copies that use it
are done) on the calling thread's current stream.  On the CPU both are
plain conversions.
"""

from __future__ import annotations

import numpy as np
import torch


def upload(x, device: torch.device) -> torch.Tensor:
    """A NumPy array or tensor -> a tensor on `device`.  To a CUDA device
    the copy is enqueued on the current stream from a pinned buffer."""
    t = torch.as_tensor(x)
    if torch.device(device).type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def fetch(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a NumPy array on the host.  From the card the copy goes
    into a pinned staging buffer on the current stream, which is then
    waited for (that stream only), and from there into pageable memory: the
    staging buffer goes back to the allocator's cache at once, where an
    array handed to the caller would pin a fresh buffer, a slow allocation,
    every call."""
    if t.device.type != "cuda":
        return t.numpy()
    staging = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staging.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return staging.numpy().copy()
