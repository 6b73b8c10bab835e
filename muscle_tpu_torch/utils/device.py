"""Device selection for the entry points, and the card's memory.

The port runs on the GPU unless the caller asks for the CPU: with no
device given it takes CUDA, and raises when no CUDA device is present
rather than running on the CPU quietly.

The JAX package set its size limits for a 16 GB TPU. The port reads the
card's memory here, in one place, for the limits it derives from it; on
the CPU there is no card and every limit keeps the JAX package's value,
so that a CPU run raises and routes as `muscle_tpu` does.
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


def device_memory_bytes(device) -> tuple[int, int] | None:
    """(total, available) bytes of the card `device`: its memory, and
    what this process can still allocate there (cudaMemGetInfo's free
    memory plus what torch's allocator holds unused). None on the CPU. Raises
    where a card was asked for (device None or CUDA) and its memory
    cannot be read: no limit falls back to the 16 GB numbers."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    held = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(total), int(free + held)


# device memory every limit derived from the card's leaves free beside
# what it predicts (the legacy route's sub-batches, the long-pair
# router's striped groups, the MPC store guard)
MEMORY_HEADROOM = 1 << 30


def free_bytes(device) -> int | None:
    """Device memory a route may take on `device`: what this process can
    still allocate there less MEMORY_HEADROOM; None (no limit) on the
    CPU."""
    mem = device_memory_bytes(device)
    return None if mem is None else mem[1] - MEMORY_HEADROOM
