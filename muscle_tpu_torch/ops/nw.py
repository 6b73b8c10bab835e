"""Batched global affine-gap Needleman-Wunsch (Viterbi) (torch port of
muscle_tpu.ops.nw).

reference: src/viterbifastmem.cpp (ViterbiFastMem: global alignment,
BLOSUM62 nats scores, gap open -3 / ext -0.5, gap of length k costs
open + (k-1)*ext, terminal gaps penalized), src/tracebackbitmem.cpp
(M/D/I path states; D consumes A, I consumes B).

One pass over the rows of A: M and D rows have no within-row
dependence, and the I row is a max-plus affine scan over the freshly
computed M row (I[i][j] = max_{k<j} M[i][k] + open + (j-1-k)*ext), the
Hillis-Steele scan of ops/sw.py. Each row emits one uint8 trace-bit row;
the final DP row of each pair is captured at its length, and the O(L)
path walk runs on the host. `nw_viterbi_plain` is that pass in torch
with the JAX package's op order, over a batch dimension;
`nw_viterbi_batch` runs it on a CPU tensor and the hand-written kernel
(ops/dp_cuda.nw_viterbi, csrc/nw_viterbi.cu) on a CUDA one.

Tie-breaking matches the reference exactly: match-state predecessor
prefers M, then D (strict >), then I (strict >); gap-open vs gap-extend
prefers open (>=) everywhere except the last row's I chain which uses
strict > (src/viterbifastmem.cpp:147 vs :100).
"""

from __future__ import annotations

import numpy as np
import torch

from .sw import BLOSUM62_21, _maxplus_scan, substitution_lattice

VITERBI_GAP_OPEN = -3.0   # reference: src/viterbifastmem.cpp:10
VITERBI_GAP_EXT = -0.5    # reference: src/viterbifastmem.cpp:11

NEG = np.float32(-1e30)

# trace bits (reference: src/tracebit.h:6-9)
TRACEBITS_DM = 0x01
TRACEBITS_IM = 0x02
TRACEBITS_MD = 0x04
TRACEBITS_MI = 0x08


def _row_bits(m, d, i_):
    """Trace bits for one DP row from its (M, D, I) values (gap open
    before extend by >=; row lx's strict MI rule is the host's,
    _last_row_bits_np)."""
    open_, ext = VITERBI_GAP_OPEN, VITERBI_GAP_EXT
    zero = torch.zeros((), dtype=torch.uint8, device=m.device)
    match_bits = torch.where(
        i_ > torch.maximum(m, d), TRACEBITS_IM,
        torch.where(d > m, TRACEBITS_DM, zero))
    md = torch.where(m + open_ >= d + ext, TRACEBITS_MD, zero)
    mi = torch.where(m + open_ >= i_ + ext, TRACEBITS_MI, zero)
    return match_bits | md | mi


def nw_viterbi_plain(xb, yb, lxb, lyb, subst):
    """The JAX package's `_nw_one` under vmap. Codes (B, BX), (B, BY) +
    lengths (B,) -> (bits (B, BX, BY+1) uint8 for rows 0..BX-1, final
    (B, 3, BY+1) f32 = the M/D/I values of row lx, scores (B,) at
    (lx, ly))."""
    e = substitution_lattice(xb, yb, subst)
    b, bx, by = e.shape
    open_, ext = VITERBI_GAP_OPEN, VITERBI_GAP_EXT
    dev = e.device
    neg = float(NEG)
    neg_col = torch.full((b, 1), neg, dtype=torch.float32, device=dev)
    lx = lxb.long()

    # row 0
    m = torch.full((b, by + 1), neg, dtype=torch.float32, device=dev)
    m[:, 0] = 0.0
    d = torch.full((b, by + 1), neg, dtype=torch.float32, device=dev)
    u = _maxplus_scan(m + open_, ext)
    i_ = torch.cat([neg_col, u[:, :-1]], dim=1)

    cap = torch.zeros((b, 3, by + 1), dtype=torch.float32, device=dev)
    bits = torch.empty((b, bx, by + 1), dtype=torch.uint8, device=dev)
    for r in range(bx):
        # capture row lx values before advancing past it
        cap = torch.where((lx == r)[:, None, None],
                          torch.stack([m, d, i_], dim=1), cap)
        bits[:, r] = _row_bits(m, d, i_)
        best = torch.maximum(torch.maximum(m, d), i_)
        m_next = torch.cat([neg_col, best[:, :-1] + e[:, r]], dim=1)
        d_next = torch.maximum(m + open_, d + ext)
        un = _maxplus_scan(m_next + open_, ext)
        i_next = torch.cat([neg_col, un[:, :-1]], dim=1)
        m, d, i_ = m_next, d_next, i_next
    cap = torch.where((lx == bx)[:, None, None],
                      torch.stack([m, d, i_], dim=1), cap)
    at = lyb.long()[:, None]
    fm, fd, fi = (cap[:, k].gather(1, at)[:, 0] for k in range(3))
    score = torch.maximum(torch.maximum(fm, fd), fi)
    return bits, cap, score


def nw_viterbi_batch(xb, yb, lxb, lyb, subst):
    """(bits, final rows, scores) as nw_viterbi_plain: the plain version
    on CPU tensors, the nw_viterbi kernel on CUDA tensors
    (ops/dp_cuda.py). What a reader may use is each pair's bit rows < lx
    and columns <= ly, its final columns <= ly and its score (all that
    _traceback and _last_row_bits_np read); on the card the cells past
    (lx, ly) are unspecified."""
    from .dp_cuda import nw_viterbi
    return nw_viterbi(xb, yb, lxb, lyb, subst)


def _traceback(bits: np.ndarray, last_row_bits: np.ndarray,
               final: np.ndarray, lx: int, ly: int) -> str:
    """Host path walk (reference: src/tracebackbitmem.cpp:8-73)."""
    fm, fd, fi = final[0, ly], final[1, ly], final[2, ly]
    state = "M"
    if fd > fm:
        state = "D"
        best = fd
    else:
        best = fm
    if fi > best:
        state = "I"
    i, j = lx, ly
    out = []
    while i > 0 or j > 0:
        out.append(state)
        if state == "M":
            t = int(bits[i - 1, j - 1]) if i - 1 < lx \
                else int(last_row_bits[j - 1])
            if t & TRACEBITS_DM:
                state = "D"
            elif t & TRACEBITS_IM:
                state = "I"
            else:
                state = "M"
            i -= 1
            j -= 1
        elif state == "D":
            t = int(bits[i - 1, j]) if i - 1 < lx \
                else int(last_row_bits[j])
            state = "M" if (t & TRACEBITS_MD) else "D"
            i -= 1
        else:
            t = int(bits[i, j - 1]) if i < lx else int(last_row_bits[j - 1])
            state = "M" if (t & TRACEBITS_MI) else "I"
            j -= 1
    return "".join(reversed(out))


def _last_row_bits_np(final: np.ndarray) -> np.ndarray:
    """Row-lx trace bits with the reference's strict-> MI rule
    (src/viterbifastmem.cpp:147)."""
    m, d, i_ = final[0], final[1], final[2]
    open_, ext = VITERBI_GAP_OPEN, VITERBI_GAP_EXT
    match_bits = np.where(i_ > np.maximum(m, d), TRACEBITS_IM,
                          np.where(d > m, TRACEBITS_DM, 0))
    md = np.where(m + open_ >= d + ext, TRACEBITS_MD, 0)
    mi = np.where(m + open_ > i_ + ext, TRACEBITS_MI, 0)
    return (match_bits | md | mi).astype(np.uint8)


# The trace bits of one launch, at most (on the device, then again on
# the host): a batch is cut into launches of fewer pairs past it. The
# pairs of a batch do not interact, so the cut changes no result.
BITS_BUDGET = 2 << 30


def nw_align_batch(codes: np.ndarray, lens: np.ndarray,
                   pairs: list[tuple[int, int]],
                   batch_size: int = 64,
                   subst: np.ndarray | None = None,
                   device=None) -> list[tuple[float, str]]:
    """(score, M/D/I path) per (i, j) pair of encoded sequences; the DP
    runs on `device` (the card unless the CPU is asked for) in batches
    of `batch_size` pairs, fewer where a batch's bits would pass
    BITS_BUDGET, the walk on the host."""
    from ..utils.device import resolve_device
    if not pairs:
        return []
    device = resolve_device(device)
    subst = torch.as_tensor(BLOSUM62_21 if subst is None else subst,
                            device=device)
    out: list[tuple[float, str]] = []
    pad = codes.shape[1]
    b = max(1, min(batch_size, len(pairs), BITS_BUDGET // (pad * (pad + 1))))
    for lo in range(0, len(pairs), b):
        chunk = pairs[lo:lo + b]
        xi = np.array([p[0] for p in chunk])
        yi = np.array([p[1] for p in chunk])
        bits, final, scores = nw_viterbi_batch(
            *(torch.from_numpy(a).to(device) for a in
              (codes[xi], codes[yi], lens[xi], lens[yi])), subst)
        bits = bits.cpu().numpy()
        final = final.cpu().numpy()
        scores = scores.cpu().numpy()
        for k, (i, j) in enumerate(chunk):
            lrb = _last_row_bits_np(final[k])
            path = _traceback(bits[k], lrb, final[k],
                              int(lens[i]), int(lens[j]))
            out.append((float(scores[k]), path))
    return out


def path_match_pairs(path: str) -> list[tuple[int, int]]:
    """(posA, posB) for every M column of an M/D/I path."""
    i = j = 0
    out = []
    for c in path:
        if c == "M":
            out.append((i, j))
            i += 1
            j += 1
        elif c == "D":
            i += 1
        else:
            j += 1
    return out
