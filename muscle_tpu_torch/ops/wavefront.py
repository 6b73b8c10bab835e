"""The hand-over of the pair-HMM kernels' wavefront schedule.

Kernels 5 and 6 (ops/pairhmm_striped.py) and kernels A and B on their
wide schedule (ops/pairhmm_cuda.py) run one launch a pass: each pair's
padded row is cut into groups of G 64-lane segments that run at once on
as many SMs, each group handing its right neighbour a record a DP row
through device memory (csrc/stripe_wavefront.cuh, csrc/pairhmm_wave.cuh).
This module keeps what their wrappers share: the publication period,
the watchdog's limit and its per-device fault flag, and the zeroed
ticket, counters and records a launch takes.
"""

from __future__ import annotations

import torch

# DP rows a group runs between two publications of its progress; the
# consumer then lags its left neighbour by R to 2R rows. 8 and 4 were
# 2-7 % faster than 16 and 32 at the long pair's shape on an H100 80GB
# HBM3 at 700 W (tools/torch_striped_probe.py)
ROWS_PER_PUBLISH = 8
# a wait on the left group past this (device clock) is a deadlock: the
# kernel flags it and runs on, and `check_waits` raises
WAIT_LIMIT_NS = 10_000_000_000
# hand-over floats a record: the forward's [fold edge, M edge, IY carry,
# JY carry], the backward's [M, IY, JY, MEA, IY carry, JY carry, 0, 0]
REC_FLOATS = {"fwd": 4, "bwd": 8}

# each device's fault flag: set by a launch whose wait on a left
# neighbour passed WAIT_LIMIT_NS
_faults: dict = {}


def fault_flag(device) -> torch.Tensor:
    """The device's fault flag (one int32), made zero at first use."""
    dev = torch.device(device)
    if dev not in _faults:
        _faults[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _faults[dev]


def check_waits(device) -> None:
    """Raise if a launch on `device` since the last call flagged a wait
    past WAIT_LIMIT_NS (a deadlock in the hand-over); synchronises with
    those launches."""
    flag = _faults.get(torch.device(device))
    if flag is not None and int(flag.item()):
        flag.zero_()
        raise RuntimeError("a wavefront pass waited past its limit on a "
                           "left neighbour: the hand-over deadlocked")


def hand_bytes(b: int, groups: int, lx: int, kind: str) -> int:
    """Bytes of the hand-over records of one launch: one record a DP row
    for each of the b * groups groups."""
    return b * groups * lx * REC_FLOATS[kind] * 4


def buffers(b: int, groups: int, lx: int, kind: str, device):
    """(sync, hand) of one launch: the ticket and each group's progress
    counter (int32, zeroed), and the records (zeroed)."""
    sync = torch.zeros(1 + b * groups, dtype=torch.int32, device=device)
    hand = torch.zeros(hand_bytes(b, groups, lx, kind) // 4,
                       dtype=torch.float32, device=device)
    return sync, hand
