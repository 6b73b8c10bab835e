"""Device selection for the entry points.

The port runs on the GPU unless the caller asks for the CPU: with no
device given it takes CUDA, and raises when no CUDA device is present
rather than running on the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(CLI: -device cpu) to run on the CPU")
    return dev
