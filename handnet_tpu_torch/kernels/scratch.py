"""Device scratch that outlives a launch: the arrival counters of the kernels
whose blocks meet in a workspace (``csrc/split_done.cuh``: K1's anchor
splits, K2s's and K2r's pixel splits).

A counter must be zero when its launch starts, and the launch's last block
sets it back to zero. So one zeroed tensor per (device, stream) serves every
launch on that stream, in stream order, with no clearing kernel between
them; launches on different streams never share counters.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def split_counters(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """At least ``count`` zeroed int32 counters on ``device`` for launches on
    the stream with handle ``stream``."""
    key = (device.index, stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < count:
        # a larger tensor replaces the old one, whose launches (same stream)
        # are ordered before whatever reuses its memory
        counters = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = counters
    return counters


def ptr(tensor: Optional[torch.Tensor]) -> Optional[int]:
    """``tensor.data_ptr()``, or None (a null pointer for ctypes) for no
    tensor: a launch with one split takes no workspace."""
    return None if tensor is None else tensor.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of the CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
