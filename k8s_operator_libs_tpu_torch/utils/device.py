"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU. A
caller that asks for ``cuda`` on a host without a visible card gets an
error, never a silent run on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the host"
        )
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
