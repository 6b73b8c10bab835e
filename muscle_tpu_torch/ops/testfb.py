"""Total log-probability of a pair from the forward and from the backward
pass: the -testfb check (reference dev command: src/testfb.cpp).

Port of muscle_tpu.ops.pairhmm.total_prob_fwd / total_prob_bwd. The
forward total folds the forward lattice's far corner F[s](lx, ly) with
the start scores (reference: src/totalprobflat.cpp:3-16); the backward
total folds the reversed backward lattice's far corner RB[s](lx, ly)
with the same scores. The two are independent paths through the
recurrences and must agree.

On the card both come from the hand-written kernels that compute these
values on the letter path: kernel A (pairhmm_cuda.pairhmm_fwd) returns
the forward corner as `fend`, and kernel 3K (pairhmm_bwd_codes, the
legacy backward) returns the backward corner with `corner=True`. So
-testfb holds the port's own forward kernel against its own backward
kernel, as the reference's -testfb holds its own. On the CPU the
kernels' plain versions run. All pairs go into one launch of each.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pairhmm_cuda as pc
from . import wavefront
from ..utils.device import resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pair_batch(xs, ys, pack, device):
    """Kernel inputs of the pairs (xs[k], ys[k]) (unpadded int code
    arrays): codes padded with the wildcard code to multiples of 128,
    lengths, and the tables (match, insert, params) of `pack`."""
    wild = int(np.asarray(pack.insert).shape[-1]) - 1
    lx_pad = _round_up(max(len(x) for x in xs), 128)
    ly_pad = _round_up(max(len(y) for y in ys), 128)

    def pad(arrs, width):
        out = np.full((len(arrs), width), wild, dtype=np.int32)
        for i, a in enumerate(arrs):
            out[i, :len(a)] = a
        return torch.from_numpy(out).to(device)

    lens = [torch.tensor([len(a) for a in arrs], dtype=torch.int32,
                         device=device) for arrs in (xs, ys)]
    match, insert, params = pc.tables(pack, device)
    return (pad(xs, lx_pad), pad(ys, ly_pad), lens[0], lens[1], match,
            insert, params)


def total_probs(xs, ys, pack, device=None) -> tuple[np.ndarray, np.ndarray]:
    """(forward totals, backward totals), (P,) f32 each, of the pairs
    (xs[k], ys[k]): one kernel-A launch and one kernel-3K launch with
    its corner output (their plain versions on the CPU)."""
    device = resolve_device(device)
    args = pair_batch(xs, ys, pack, device)
    params = args[-1]
    _fm, fend = pc.pairhmm_fwd(*args)
    fwd = pc._total_prob(fend, params)
    _rbm, far = pc.pairhmm_bwd_codes(*args, corner=True)
    bwd = pc._total_prob(far, params)
    if device.type == "cuda":
        wavefront.check_waits(device)    # raises on a stuck hand-over
    return fwd.cpu().numpy(), bwd.cpu().numpy()


def total_prob_fwd(x, y, pack, device=None) -> float:
    """Total log-prob from the forward lattice's far corner (reference:
    src/totalprobflat.cpp:3-16). x, y: unpadded int code arrays."""
    device = resolve_device(device)
    args = pair_batch([np.asarray(x)], [np.asarray(y)], pack, device)
    _fm, fend = pc.pairhmm_fwd(*args)
    return float(pc._total_prob(fend, args[-1])[0])


def total_prob_bwd(x, y, pack, device=None) -> float:
    """Total log-prob from the backward lattice (over the reversed
    sequences, folded at its far corner), an independent path that must
    agree with total_prob_fwd."""
    device = resolve_device(device)
    args = pair_batch([np.asarray(x)], [np.asarray(y)], pack, device)
    _rbm, far = pc.pairhmm_bwd_codes(*args, corner=True)
    if device.type == "cuda":
        wavefront.check_waits(device)
    return float(pc._total_prob(far, args[-1])[0])
