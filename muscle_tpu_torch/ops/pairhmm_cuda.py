"""Pair-HMM posteriors on the GPU: two hand-written CUDA kernels.

Port of muscle_tpu.ops.pairhmm_pallas (the path the JAX package runs on
a TPU: `batch_posteriors_pallas` -> `_letter_path` ->
`_emissions_path_fused`):

* kernel A, `pairhmm_fwd` (csrc/pairhmm_fwd.cu), replaces `_fwd_kernel`:
  the forward recurrence, writing the forward M lattice and each pair's
  five final states at (lx, ly);
* `_total_prob`, a plain (B, 5) LOG_ADD fold in the reference order;
* kernel B, `pairhmm_bwd_post` (csrc/pairhmm_bwd_post.cu), replaces
  `_bwd_post_kernel`: the backward recurrence fused with the posterior
  combine (0.01 threshold) and the MEA row scan that gives EA.

Kernels 1M and 2M (the per-pair-table forms that
`batch_posteriors_pallas_multi` runs for the ensembles' replicate
batching) are kernels A and B, the same C entries with per_pair = 1:
each pair reads its own (K+1)^2 match table, (K+1) insert table and
(16,) params row (`batch_posteriors_cuda_multi`). `LAUNCHES` counts
them apart, as `pairhmm_fwd_multi` and `pairhmm_bwd_post_multi`. Under `fused=False` (the JAX package's
MUSCLE_TPU_FUSED=0) both entry points take the legacy route of the
letter path instead: kernel A (or 1M), kernel 3K, `pairhmm_bwd_codes`
(csrc/pairhmm_bwd_codes.cu, replaces `_bwd_kernel` with kk=K: the
reversed backward M lattice from letters, on A and B's two schedules,
its wave kernel 3's), `finish_posteriors` and kernel 4
(ops/pairhmm_emis_cuda.py).

Beside each kernel is its plain twin (`fwd_plain`, `bwd_post_plain`,
`bwd_codes_plain`; each takes shared or per-pair tables): a torch
transcription of the Pallas kernel's math over (B, Ly) rows with a
Python loop over DP rows. The twins share the kernels' summation
structure (segmented within-row scan with the degree-8 LOG_ADD,
Hillis-Steele row-0 prefix sums, the reference cubic for M/IX/JX,
products and sums rounded separately), so on the card kernel and twin
agree bit for bit (chip_smoke.py). A kernel wrapper given CPU tensors
runs the twin; given CUDA tensors it launches the kernel or raises.
`LAUNCHES` counts the kernel launches, `SCHEDULES` them by schedule
and width.

Each kernel runs on one of two schedules of the same arithmetic
(`ab_geometry`): one thread block a pair up to 2048 lanes, or, for wider
rows (the long-pair router's rungs, the bucket ladder's 3072-8192),
each pair's row as a skewed wavefront of groups of segments across SMs
(csrc/pairhmm_wave.cuh, shared with kernels 5/6; ops/wavefront.py).
`letter_path` raises after a wavefront launch whose hand-over waited
past its limit (`wavefront.check_waits`).
"""

from __future__ import annotations

import ctypes
import os
from collections import Counter
from typing import NamedTuple

import torch

from . import wavefront
from .logspace import LOG_UNDERFLOW, LOG_ZERO, _C0, _C1, _C2, _C3
from .pairhmm import MIN_SPARSE_SCORE

NEG_BIG = -1e30  # sentinel more negative than any reachable score sum

# (16,) params layout shared by the twins and the kernels
P_TSM, P_TSI, P_TSJ, P_TMM, P_TMI, P_TMJ, P_TII, P_TIM, P_TJJ, P_TJM = range(10)

# lane-axis cap of the kernels (Ly % 128 == 0): 160 segments of 64 lanes,
# five per warp. The long-pair router pads a Y side of up to 9856 to the
# rung 10240 (pipeline/posteriors.py::_long_rung).
MAX_LY = 10240

LAUNCHES = {"pairhmm_fwd": 0, "pairhmm_bwd_post": 0, "pairhmm_fwd_multi": 0,
            "pairhmm_bwd_post_multi": 0, "pairhmm_bwd_codes": 0}
# kernel launches of LAUNCHES' names, and of kernel 3
# (ops/pairhmm_emis_cuda.py, "pairhmm_bwd"), by (name, schedule, Ly)
SCHEDULES: Counter = Counter()

# the fused route (kernel B: backward, posterior and MEA in one pass);
# off, as the JAX package's MUSCLE_TPU_FUSED=0 (read as
# muscle_tpu/ops/pairhmm_pallas.py reads it), the legacy route
FUSED = os.environ.get("MUSCLE_TPU_FUSED", "1") != "0"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SCHEDULES.clear()


# ---------------------------------------------------------------------------
# the two schedules of kernels A and B (and 1M, 2M)
# ---------------------------------------------------------------------------
#
# "block": one thread block a pair, its rows a serial chain on one SM
# (csrc/pairhmm_fwd.cuh, pairhmm_bwd_post.cuh). "wave": each pair's row
# cut into groups of g 64-lane segments, one block a group, run by one
# launch as a skewed wavefront across SMs (csrc/pairhmm_wave.cuh, the
# bodies of kernels 5/6 with one stripe of the whole row and row 0 from
# the kernels' own rounds). Same operations in the same association:
# both equal the plain versions bit for bit.

# segments a group of the wave: the largest divisor of the row's
# segments up to this. On an H100 80GB HBM3 at 700 W, one 11000 x 9800
# pair at 10240 ran 18.3 / 42.0 ms (kernels A / B) at G = 2, 18.9 / 42.0
# at 4, 26.2 / 47.9 at 8 (tools/torch_ab_probe.py)
AB_GROUP_SEGMENTS = 4
# rows wider than this (S >= 2 segments a warp) take the wave whatever B:
# with one block a pair a row is a serial chain on one SM (the carry
# over S * 32 segments by one thread). On the same card the wave was
# faster at every B from 1 to 264 pairs of Lx 1024 at Ly 2176, 4352 and
# 10240 (0.63-0.89x one block a pair at B = 132-264, 0.03-0.15x at B =
# 1; tools/torch_ab_probe.py --crossover); at S = 1 one block a pair
# stays
WAVE_MIN_LY = 2048


# kernel 3K's schedule (kernel 3's wave or its own block body, which
# skips the segments past ly): rows wider than BWD_CODES_WAVE_MIN_LY
# take the wave whatever B; from BWD_CODES_FEW_MIN_LY the wave takes
# launches of at most BWD_CODES_WAVE_MAX_B pairs, where one block a pair
# leaves SMs idle (132 on the H100) and the wave spreads each row over
# its groups. B moves the crossover only there. On an H100 80GB HBM3 at
# 700 W, wave / block time (tools/torch_mea_bwd_probe.py --crossover, B
# = 1-512): 1.15-1.22 at 128 and 1.03-1.08 at 512 for every B; at 768
# 0.85 (B = 1-16), 0.88 (64), 0.96 (128), 1.09 (256), 1.05 (512); at
# 1024 0.69 (1-16), 0.73 (64), 0.90 (128), 1.00 (256), 1.05 (512); at
# 2048 0.37-0.87 for every B
BWD_CODES_WAVE_MIN_LY = 1024
BWD_CODES_FEW_MIN_LY = 768
BWD_CODES_WAVE_MAX_B = 128


class ABGeometry(NamedTuple):
    """The schedule of one launch of kernel A or B: "block", or "wave"
    with groups of `g` segments, `groups` a pair."""
    schedule: str
    g: int = 0
    groups: int = 0


def ab_geometry(b: int, ly: int, schedule: str | None = None,
                g: int | None = None) -> ABGeometry:
    """The schedule of a launch of B pairs at width Ly: `schedule` if
    given ("block" or "wave"), else the wave for Ly > WAVE_MIN_LY (S >= 2
    segments a warp); for the wave, groups of `g` segments if given (a
    divisor of the Ly / 64 segments, at most 32), else the largest
    divisor up to AB_GROUP_SEGMENTS. (B does not enter the choice.)"""
    nseg = ly // 64
    if schedule is None:
        schedule = "wave" if ly > WAVE_MIN_LY else "block"
    if schedule == "block":
        if g is not None:
            raise ValueError("g is the wave's group size")
        return ABGeometry("block")
    if schedule != "wave":
        raise ValueError(f"schedule {schedule!r}: want 'block' or 'wave'")
    if g is None:
        g = max(d for d in range(1, AB_GROUP_SEGMENTS + 1) if nseg % d == 0)
    if not 1 <= g <= 32 or nseg % g:
        raise ValueError(f"{g} segments a group: want a divisor of the "
                         f"{nseg} segments, at most 32")
    return ABGeometry("wave", g, nseg // g)


# ---------------------------------------------------------------------------
# log-space helpers of the Pallas kernels (plain torch, no FMA)
# ---------------------------------------------------------------------------

def _logexp1_sel(x):
    """Reference cubic with the segment's coefficients selected first."""
    s1 = x <= 1.0
    s2 = x <= 2.5
    s3 = x <= 4.5

    def pick(i):
        return torch.where(s2, torch.where(s1, _C0[i], _C1[i]),
                           torch.where(s3, _C2[i], _C3[i])).float()
    c0, c1, c2, c3 = pick(0), pick(1), pick(2), pick(3)
    return ((c0 * x + c1) * x + c2) * x + c3


def _log_add(x, y):
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = hi - lo
    small = (lo <= LOG_ZERO) | (d >= LOG_UNDERFLOW)
    return torch.where(small, hi,
                       lo + _logexp1_sel(torch.clamp(d, 0.0, LOG_UNDERFLOW)))


def _log_add5(x1, x2, x3, x4, x5):
    return _log_add(x1, _log_add(x2, _log_add(x3, _log_add(x4, x5))))


# degree-8 fit of log(1 + e^x) on [0, 7.5] used inside the within-row
# scans (muscle_tpu/ops/pairhmm_pallas.py `_P8`)
_P8 = (-6.73338208e-07, 2.39144278e-05, -3.51821887e-04, 2.68814008e-03,
       -1.01874083e-02, 4.79808334e-03, 1.22831020e-01, 5.00330250e-01,
       6.93143978e-01)


def _log_add_p(x, y):
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = torch.clamp(hi - lo, max=LOG_UNDERFLOW)
    small = (lo <= LOG_ZERO) | (d >= LOG_UNDERFLOW)
    r = torch.full_like(d, _P8[0])
    for c in _P8[1:]:
        r = r * d + c
    return torch.where(small, hi, lo + r)


def _shift_fill(x, fill):
    """Shift lanes right by one; lane 0 takes `fill` ((B,1) or scalar)."""
    out = torch.roll(x, 1, dims=1)
    out[:, :1] = fill
    return out


_SEG = 64   # segment width of the two-level within-row scan


def _seg_rounds(a, c):
    """The Hillis-Steele rounds of the affine scan inside each 64-lane
    segment (the kernels' seg_scan): (a, c) after them."""
    width = a.shape[1]
    seg = min(_SEG, width)
    seg_pos = (torch.arange(width, device=a.device) % seg)[None, :]
    k = 1
    while k < seg:
        valid = seg_pos >= k
        a_prev = torch.where(valid, torch.roll(a, k, dims=1), 0.0)
        c_prev = torch.where(valid, torch.roll(c, k, dims=1), NEG_BIG)
        c = _log_add_p(c_prev + a, c)
        a = a + a_prev
        k *= 2
    return a, c


def _affine_scan_seg(a, c):
    """Inclusive scan of T_j(u) = LOG_ADD_p(u + a_j, c_j), u_0 = -inf:
    Hillis-Steele rounds inside 64-lane segments, a sequential carry
    chain over the segment totals, one combine per lane."""
    width = a.shape[1]
    seg = min(_SEG, width)
    a, c = _seg_rounds(a, c)
    n_seg = width // seg
    if n_seg <= 1:
        return c
    carry = torch.full_like(a[:, :1], NEG_BIG)
    carries = [carry]
    for s in range(n_seg - 1):
        e = (s + 1) * seg
        carry = _log_add_p(carry + a[:, e - 1:e], c[:, e - 1:e])
        carries.append(carry)
    carry_vec = torch.cat([cc.expand(-1, seg) for cc in carries], dim=1)
    return _log_add_p(carry_vec + a, c)


def _scan2(a1, c1, a2, c2):
    b = a1.shape[0]
    c = _affine_scan_seg(torch.cat([a1, a2]), torch.cat([c1, c2]))
    return c[:b], c[b:]


def _cumsum_lanes(x):
    """Hillis-Steele prefix sum over the full lane width."""
    lane = torch.arange(x.shape[1], device=x.device)[None, :]
    k = 1
    while k < x.shape[1]:
        x = x + torch.where(lane >= k, torch.roll(x, k, dims=1), 0.0)
        k *= 2
    return x


def params_vec(pack, device) -> torch.Tensor:
    """(16,) f32 [tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM, 0...]."""
    p = torch.zeros(16, dtype=torch.float32)
    p[P_TSM] = float(pack.start[0])
    p[P_TSI] = float(pack.start[1])
    p[P_TSJ] = float(pack.start[3])
    p[3:10] = torch.tensor([pack.tMM, pack.tMI, pack.tMJ, pack.tII,
                            pack.tIM, pack.tJJ, pack.tJM])
    return p.to(device)


def tables(pack, device):
    """(match (K+1)^2, insert (K+1,), params (16,)) f32 on `device`."""
    return (torch.as_tensor(pack.match, dtype=torch.float32).to(device),
            torch.as_tensor(pack.insert, dtype=torch.float32).to(device),
            params_vec(pack, device))


def params_rows(start_b, tv_b):
    """(B, 16) f32 params rows from per-pair start (B, 5) and transition
    (B, 7) scores (the JAX package's _params_rows_multi: lanes 0-9)."""
    p = torch.zeros((start_b.shape[0], 16), dtype=torch.float32,
                    device=start_b.device)
    p[:, P_TSM] = start_b[:, 0]
    p[:, P_TSI] = start_b[:, 1]
    p[:, P_TSJ] = start_b[:, 3]
    p[:, 3:10] = tv_b[:, :7]
    return p


def _unpack(params):
    """The ten scores of a (16,) params vector (scalars), or of (B, 16)
    rows ((B, 1) columns that broadcast over a DP row like the scalar)."""
    if params.dim() == 1:
        return [params[k] for k in range(10)]
    return [params[:, k:k + 1] for k in range(10)]


def _letters(xb, yb, match, insert):
    """The letter emission source of the plain versions: (row(xi) ->
    (match scores of x position xi against every y, (B, Ly); insert
    score of x position xi, (B, 1)), for one xi or one a pair, (B,);
    y insert scores (B, Ly)), from one table set (match (K+1, K+1),
    insert (K+1,)) or one a pair (match (B, K+1, K+1), insert
    (B, K+1)). Both give the same numbers for the same tables."""
    xb = xb.long()
    yb = yb.long()
    ar = torch.arange(xb.shape[0], device=xb.device)
    if match.dim() == 2:
        def row(xi):
            c = xb[ar, xi]
            return match[c[:, None], yb], insert[c][:, None]
        return row, insert[yb]

    def row_b(xi):
        c = xb[ar, xi]
        return match[ar[:, None], c[:, None], yb], insert[ar, c][:, None]
    return row_b, torch.gather(insert, 1, yb)


# ---------------------------------------------------------------------------
# plain twins (torch transcriptions of the Pallas kernels)
# ---------------------------------------------------------------------------

def fwd_plain(xb, yb, lxb, lyb, match, insert, params):
    """Twin of kernels A (one table set) and 1M (match (B, K+1, K+1),
    insert (B, K+1), params (B, 16)). Returns (fm (B, Lx, Ly) forward M
    rows 1..Lx over columns 1..Ly, fend (B, 5) states [M, IX, IY, JX,
    JY] at (lx, ly)). reference: src/fwdflat3.cpp:12-153."""
    row, insy = _letters(xb, yb, match, insert)
    return fwd_rows(row, insy, lxb, lyb, params, xb.shape[1])


def fwd_rows(row, insy, lxb, lyb, params, lx_pad):
    """The forward recurrence of kernels A and 1E over lx_pad DP rows:
    row(i) gives row i's emissions (B, Ly) and x insert scores (B, 1),
    insy (B, Ly) the y insert scores. Returns (fm, fend) as fwd_plain."""
    (tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM) = _unpack(params)
    b, width = insy.shape
    dev = insy.device
    lane = torch.arange(width, device=dev)[None, :]
    lz = torch.full((b, width), LOG_ZERO, dtype=torch.float32, device=dev)
    # row 0 boundary (reference: src/fwdflat3.cpp:35-93)
    m, ix, jx = lz, lz, lz
    iy = tSI - tII + _cumsum_lanes(insy + tII)
    jy = tSJ - tJJ + _cumsum_lanes(insy + tJJ)
    ix0 = torch.full((b, 1), LOG_ZERO, dtype=torch.float32, device=dev)
    jx0 = ix0
    fm = torch.empty((b, lx_pad, width), dtype=torch.float32, device=dev)
    fend = torch.full((b, 5), LOG_ZERO, dtype=torch.float32, device=dev)
    ar = torch.arange(b, device=dev)
    for i in range(lx_pad):
        e_row, insx = row(i)
        # M row: fold the five predecessors, shift the fold once
        comb = _log_add5(m + tMM, ix + tIM, jx + tJM, iy + tIM, jy + tJM)
        m_new = _shift_fill(comb, _log_add(ix0 + tIM, jx0 + tJM)) + e_row
        if i == 0:
            m_new = torch.where(lane == 0, tSM + e_row, m_new)
        ix_new = _log_add(ix + tII, m + tMI) + insx
        jx_new = _log_add(jx + tJJ, m + tMJ) + insx
        if i == 0:
            ix0, jx0 = tSI + insx, tSJ + insx
        else:
            ix0, jx0 = ix0 + tII + insx, jx0 + tJJ + insx
        m_sh = _shift_fill(m_new, LOG_ZERO)
        iy, jy = _scan2(insy + tII, m_sh + tMI + insy,
                        insy + tJJ, m_sh + tMJ + insy)
        m, ix, jx = m_new, ix_new, jx_new
        fm[:, i] = m
        last = lxb == i + 1
        if bool(last.any()):
            col = (lyb.long() - 1)
            vals = torch.stack([r[ar, col] for r in (m, ix, iy, jx, jy)],
                               dim=1)
            fend = torch.where(last[:, None], vals, fend)
    return fm, fend


def _total_prob(fend, params):
    """Total log-prob per pair: LOG_ADD fold over the states of
    F[s](lx, ly) + the start scores, in the reference order
    (src/totalprobflat.cpp:3-16); the start scores are shared ((16,)
    params) or each pair's ((B, 16) rows: the JAX package's bstart_b,
    [M, IX, IY, JX, JY] = start[0], start[1], start[1], start[3],
    start[3])."""
    bstart = (params[..., P_TSM], params[..., P_TSI], params[..., P_TSI],
              params[..., P_TSJ], params[..., P_TSJ])
    tot = torch.full(fend.shape[:1], LOG_ZERO, dtype=torch.float32,
                     device=fend.device)
    for s in range(5):
        tot = _log_add(tot, fend[:, s] + bstart[s])
    return tot


def bwd_post_plain(xb, yb, lxb, lyb, match, insert, params, tot, fm,
                   with_mea: bool = True):
    """Twin of kernels B and 2M (tables as fwd_plain). Returns (post
    (B, Lx, Ly), mea (B,) MEA score).

    Lane q holds forward column Ly-1-q (sequences plainly flipped, so
    each pair's real lanes end-align); padding lanes q < Ly-ly carry the
    column boundary chains and rows u <= Lx-lx keep the boundary state.
    reference: src/bwdflat3.cpp:10-190, src/calcposteriorflat.cpp:4-27,
    src/calcalnscoreflat.cpp:4-32.
    """
    row, insy = _letters(xb, yb.flip(1), match, insert)
    return bwd_post_rows(row, insy, lxb, lyb, params, tot, fm, with_mea)


def bwd_post_rows(row, insy_raw, lxb, lyb, params, tot, fm,
                  with_mea: bool = True):
    """The backward + posterior + MEA recurrence of kernels B and 2E:
    row(xi) gives the emissions of x position xi in lane order (lane q
    is column Ly-1-q), (B, Ly), and its x insert scores (B, 1); insy_raw
    (B, Ly) the y insert scores in lane order. Returns (post, mea) as
    bwd_post_plain."""
    (tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM) = _unpack(params)
    b, n_rows = fm.shape[:2]
    width = insy_raw.shape[1]
    dev = insy_raw.device
    lxv = lxb.float()[:, None]
    u0 = float(n_rows) - lxv                     # last pinned row
    lane = torch.arange(width, device=dev)[None, :].float()
    padmask = lane < (float(width) - lyb.float()[:, None])
    insy = torch.where(padmask, LOG_ZERO, insy_raw)
    tot = tot[:, None]

    cum_i = _cumsum_lanes(torch.where(padmask, 0.0, insy_raw + tII))
    iy = torch.where(padmask, tSI, tSI + cum_i)
    cum_j = _cumsum_lanes(torch.where(padmask, 0.0, insy_raw + tJJ))
    jy = torch.where(padmask, tSJ, tSJ + cum_j)
    m = _log_add(tMI + _shift_fill(iy, tSI) + insy,
                 tMJ + _shift_fill(jy, tSJ) + insy)
    m = torch.where(padmask, tSM, m)
    lz = torch.full((b, width), LOG_ZERO, dtype=torch.float32, device=dev)
    ix = torch.where(padmask, tSI, lz)
    jx = torch.where(padmask, tSJ, lz)
    col = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    ix0, jx0, m0 = col + tSI, col + tSJ, col + tSM
    mea = torch.zeros((b, width), dtype=torch.float32, device=dev)
    post = torch.empty((b, n_rows, width), dtype=torch.float32, device=dev)

    for u in range(n_rows):
        if u > 0:
            e_row, insx = row(n_rows - u)
            e_row = torch.where(padmask, LOG_ZERO, e_row)
            next_m = _shift_fill(m, m0) + e_row
            next_ix = ix + insx
            next_jx = jx + insx
            ix_new = _log_add(tII + next_ix, tIM + next_m)
            jx_new = _log_add(tJJ + next_jx, tJM + next_m)
            ix0_new = tII + ix0 + insx
            jx0_new = tJJ + jx0 + insx
            m0_new = _log_add(tMI + ix0 + insx, tMJ + jx0 + insx)
            iy_new, jy_new = _scan2(insy + tII, tIM + next_m,
                                    insy + tJJ, tJM + next_m)
            next_iy = _shift_fill(iy_new, LOG_ZERO) + insy
            next_jy = _shift_fill(jy_new, LOG_ZERO) + insy
            m_new = _log_add5(tMM + next_m, tMI + next_ix, tMJ + next_jx,
                              tMI + next_iy, tMJ + next_jy)
            pin = float(u) <= u0
            m = torch.where(pin, m, m_new)
            ix = torch.where(pin, ix, ix_new)
            iy = torch.where(pin, iy, iy_new)
            jx = torch.where(pin, jx, jx_new)
            jy = torch.where(pin, jy, jy_new)
            ix0 = torch.where(pin, ix0, ix0_new)
            jx0 = torch.where(pin, jx0, jx0_new)
            m0 = torch.where(pin, m0, m0_new)
        # combine with forward row n_rows-1-u, threshold at 0.01
        pf = n_rows - 1 - u
        score = fm[:, pf].flip(1) + _shift_fill(m, m0) - tot
        valid = (float(pf) < lxv) & ~padmask
        post_nat = torch.where((score >= MIN_SPARSE_SCORE) & valid,
                               torch.exp(torch.clamp(score, max=0.0)), 0.0)
        post[:, pf] = post_nat.flip(1)
        if with_mea:
            e = torch.maximum(_shift_fill(mea, 0.0) + post_nat, mea)
            mea = torch.cummax(torch.clamp(e, min=0.0), dim=1).values
    return post, mea[:, -1]


def reversed_lanes(a, lens):
    """out[b, v] = a[b, lens[b]-1-v] for v < lens[b], LOG_ZERO beyond,
    for a (B, L): the per-pair reversal the legacy backward reads."""
    v = torch.arange(a.shape[1], device=a.device)
    idx = lens.long()[:, None] - 1 - v[None, :]
    return torch.where(idx >= 0, torch.gather(a, 1, idx.clamp(min=0)),
                       LOG_ZERO)


def bwd_rows(row, ins_y, lxb, lyb, params, n_rows, corner: bool = False):
    """The legacy backward recurrence of kernels 3 and 3K (the Pallas
    `_bwd_kernel`) over the reversed sequences: row(xi) gives x position
    xi's emissions in forward column order (B, Ly) and its insert scores
    (B, 1) for each pair's xi, (B,); ins_y (B, Ly) the y insert scores.
    Both are read through reversed indices (row u takes x position
    lx-u, lane v column ly-1-v, LOG_ZERO for v >= ly), so no reversed
    copy is built. Returns RB_M (B, n_rows, Ly); rows u >= lx are zero.
    With `corner`, returns (RB_M, (B, 5)): the five states [M, IX, IY,
    JX, JY] of the reversed lattice at its far corner (row lx, column
    ly: lane ly-1 of the unshifted state rows, rows run up to lx even
    where lx = n_rows), which total_prob_bwd folds with the start
    scores. reference: src/bwdflat3.cpp:10-190."""
    (tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM) = _unpack(params)
    b, width = ins_y.shape
    dev = ins_y.device
    lx = lxb.long()
    insy = reversed_lanes(ins_y, lyb)
    iy0 = tSI + _cumsum_lanes(insy + tII)
    jy0 = tSJ + _cumsum_lanes(insy + tJJ)
    m = _log_add(tMI + _shift_fill(iy0, tSI) + insy,
                 tMJ + _shift_fill(jy0, tSJ) + insy)
    lz = torch.full((b, width), LOG_ZERO, dtype=torch.float32, device=dev)
    ix, jx, iy, jy = lz, lz, iy0, jy0
    col = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    ix0, jx0, m0 = col + tSI, col + tSJ, col + tSM
    rbm = torch.empty((b, n_rows, width), dtype=torch.float32, device=dev)
    rbm[:, 0] = _shift_fill(m, tSM)
    last = n_rows - 1
    if corner:
        last = max(last, int(lx.max()))
        far = torch.full((b, 5), LOG_ZERO, dtype=torch.float32, device=dev)
        at = (lyb.long() - 1)[:, None]
    for u in range(1, last + 1):
        e_fwd, insx = row((lx - u).clamp(min=0))
        e_row = reversed_lanes(e_fwd, lyb)
        next_m = _shift_fill(m, m0) + e_row
        next_ix = ix + insx
        next_jx = jx + insx
        ix_new = _log_add(tII + next_ix, tIM + next_m)
        jx_new = _log_add(tJJ + next_jx, tJM + next_m)
        ix0_new = tII + ix0 + insx
        jx0_new = tJJ + jx0 + insx
        m0 = _log_add(tMI + ix0 + insx, tMJ + jx0 + insx)
        iy, jy = _scan2(insy + tII, tIM + next_m, insy + tJJ, tJM + next_m)
        next_iy = _shift_fill(iy, LOG_ZERO) + insy
        next_jy = _shift_fill(jy, LOG_ZERO) + insy
        m = _log_add5(tMM + next_m, tMI + next_ix, tMJ + next_jx,
                      tMI + next_iy, tMJ + next_jy)
        ix, jx, ix0, jx0 = ix_new, jx_new, ix0_new, jx0_new
        if u < n_rows:
            rbm[:, u] = _shift_fill(m, m0)
        if corner:
            vals = torch.cat([torch.gather(r, 1, at)
                              for r in (m, ix, iy, jx, jy)], dim=1)
            far = torch.where((lx == u)[:, None], vals, far)
    rows = torch.arange(n_rows, device=dev)[None, :, None]
    rbm = torch.where(rows < lx[:, None, None], rbm, 0.0)
    return (rbm, far) if corner else rbm


def bwd_codes_plain(xb, yb, lxb, lyb, match, insert, params,
                    corner: bool = False):
    """Twin of kernel 3K (tables as fwd_plain): the legacy backward from
    letters, the codes read through reversed indices (the JAX package
    reads its rolled copies roll(x[::-1], lx - Lx), whose position k < lx
    is x[lx-1-k]). Returns RB_M (B, Lx, Ly); rows u >= lx are zero. With
    `corner`, (RB_M, the far corner's five states (B, 5)), as bwd_rows."""
    row, insy = _letters(xb, yb, match, insert)
    return bwd_rows(row, insy, lxb, lyb, params, xb.shape[1], corner)


# ---------------------------------------------------------------------------
# kernel build + launch
# ---------------------------------------------------------------------------

_KERNELS = ("pairhmm_fwd", "pairhmm_bwd_post", "pairhmm_bwd_codes")
_libs: dict = {}


def kernel_specs(names=_KERNELS):
    """Build specs of the pair-HMM kernel libraries `names`: each from
    csrc/<name>.cu, keyed on the shared headers too (kernels A/1M/1E
    share pairhmm_fwd.cuh, B/2M/2E pairhmm_bwd_post.cuh, 3/3K
    pairhmm_bwd.cuh; A/B's wide schedule and kernels 5/6 pairhmm_wave.cuh
    and stripe_wavefront.cuh)."""
    from ..utils.build import CUDA_FLAGS, LibSpec, nvcc, package_path
    deps = tuple(package_path("csrc", h) for h in (
        "pairhmm_common.cuh", "pairhmm_fwd.cuh", "pairhmm_bwd_post.cuh",
        "pairhmm_bwd.cuh", "stripe_wavefront.cuh", "pairhmm_wave.cuh"))
    return [LibSpec(name=k, compiler=nvcc(), flags=CUDA_FLAGS,
                    sources=(package_path("csrc", f"{k}.cu"),), deps=deps)
            for k in names]


def load_libs(specs, argtypes: dict, into: dict) -> None:
    """Build the pair-HMM kernel libraries `specs` and load each into
    `into` by name: its kernel function (arguments argtypes[name],
    returning a cudaError_t as an int) and `pairhmm_error_string`
    (pairhmm_common.cuh)."""
    from ..utils.build import ensure_built
    paths = ensure_built(specs)
    for spec in specs:
        lib = ctypes.CDLL(paths[spec.name])
        fn = getattr(lib, spec.name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes[spec.name]
        lib.pairhmm_error_string.restype = ctypes.c_char_p
        lib.pairhmm_error_string.argtypes = [ctypes.c_int]
        into[spec.name] = lib


def _lib(name: str):
    if name not in _libs:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        wave = [ci] * 2 + [ll] + [vp] * 4   # G, R, wait_ns, 4 buffers
        load_libs(kernel_specs(),
                  {"pairhmm_fwd": [vp] * 7 + [ci] * 5 + wave + [vp] * 3,
                   "pairhmm_bwd_post": [vp] * 7 + [ci] + [vp] + [ci] * 5
                   + wave + [vp] * 4,
                   "pairhmm_bwd_codes": [vp] * 7 + [ci] * 5 + wave
                   + [vp] * 3},
                  _libs)
    return _libs[name]


def _check_inputs(xb, yb, lxb, lyb, match, insert, params):
    """Shapes of a letter-path launch: one table set (match (K+1, K+1),
    insert (K+1,), params (16,)) or one a pair ((B, K+1, K+1), (B, K+1),
    (B, 16)). Returns (B, Lx, Ly, K+1)."""
    dev = xb.device
    for name, t in (("xb", xb), ("yb", yb), ("lxb", lxb), ("lyb", lyb)):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {dev}")
    for name, t in (("match", match), ("insert", insert), ("params", params)):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32 on {dev}")
    b, lx = xb.shape
    ly = yb.shape[1]
    if yb.shape[0] != b or lxb.shape != (b,) or lyb.shape != (b,):
        raise ValueError("batch shapes disagree")
    if ly % 128 or not 0 < ly <= MAX_LY or lx < 1:
        raise ValueError(f"Ly={ly} must be a multiple of 128 in "
                         f"[128, {MAX_LY}]")
    kk = insert.shape[-1]
    per_pair = match.dim() == 3
    lead = (b,) if per_pair else ()
    if (match.shape != lead + (kk, kk) or insert.shape != lead + (kk,)
            or params.shape != lead + (16,)):
        raise ValueError("score table shapes")
    return b, lx, ly, kk


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _on_card(t) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    tensor (the kernel launches); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _wave_args(geo: ABGeometry, b: int, lx: int, ly: int, kind: str, dev):
    """(args, buffers): the C entries' wave arguments (G, R, wait_ns,
    sync, fault, hand, row0) for a launch on schedule `geo`, and the
    tensors behind them, which the caller keeps until it has launched:
    zero and null pointers for the block schedule; else a zeroed ticket,
    counters and records, the device's fault flag and row 0's 4 B Ly
    floats."""
    if geo.schedule == "block":
        null = ctypes.c_void_p(0)
        return (0, 0, 0, null, null, null, null), ()
    sync, hand = wavefront.buffers(b, geo.groups, lx, kind, dev)
    row0 = torch.empty(4 * b * ly, dtype=torch.float32, device=dev)
    bufs = (sync, wavefront.fault_flag(dev), hand, row0)
    return (geo.g, wavefront.ROWS_PER_PUBLISH, wavefront.WAIT_LIMIT_NS,
            *(_ptr(t) for t in bufs)), bufs


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.pairhmm_error_string(rc).decode()}")


def pairhmm_fwd(xb, yb, lxb, lyb, match, insert, params,
                schedule: str | None = None, g: int | None = None):
    """Kernel A (forward, one table set) or, given per-pair tables
    (match (B, K+1, K+1), insert (B, K+1), params (B, 16)), kernel 1M,
    on the schedule `ab_geometry(B, Ly, schedule, g)` picks. CPU tensors
    run `fwd_plain`. Cells outside (lx, ly) of fm are unspecified."""
    geo = ab_geometry(xb.shape[0], yb.shape[1], schedule, g)
    if not _on_card(xb):
        return fwd_plain(xb, yb, lxb, lyb, match, insert, params)
    b, lx, ly, kk = _check_inputs(xb, yb, lxb, lyb, match, insert, params)
    per_pair = match.dim() == 3
    name = "pairhmm_fwd_multi" if per_pair else "pairhmm_fwd"
    fm = torch.empty((b, lx, ly), dtype=torch.float32, device=xb.device)
    fend = torch.empty((b, 5), dtype=torch.float32, device=xb.device)
    lib = _lib("pairhmm_fwd")
    wave, _bufs = _wave_args(geo, b, lx, ly, "fwd", xb.device)
    rc = lib.pairhmm_fwd(_ptr(xb), _ptr(yb), _ptr(lxb), _ptr(lyb),
                         _ptr(match), _ptr(insert), _ptr(params),
                         int(per_pair), b, lx, ly, kk, *wave,
                         _ptr(fm), _ptr(fend), _stream(xb))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    SCHEDULES[(name, geo.schedule, ly)] += 1
    return fm, fend


def pairhmm_bwd_post(xb, yb, lxb, lyb, match, insert, params, tot, fm,
                     with_mea: bool = True, schedule: str | None = None,
                     g: int | None = None):
    """Kernel B (backward + posterior + MEA, one table set) or, given
    per-pair tables, kernel 2M (always with the MEA), on the schedule
    `ab_geometry(B, Ly, schedule, g)` picks (the wave always computes
    the MEA). CPU tensors run `bwd_post_plain`."""
    geo = ab_geometry(xb.shape[0], yb.shape[1], schedule, g)
    if not _on_card(xb):
        return bwd_post_plain(xb, yb, lxb, lyb, match, insert, params, tot,
                              fm, with_mea)
    b, lx, ly, kk = _check_inputs(xb, yb, lxb, lyb, match, insert, params)
    per_pair = match.dim() == 3
    if (tot.dtype != torch.float32 or tot.shape != (b,)
            or tot.device != xb.device or not tot.is_contiguous()
            or fm.shape != (b, lx, ly)
            or fm.dtype != torch.float32 or fm.device != xb.device
            or not fm.is_contiguous()):
        raise ValueError("tot (B,) / fm (B, Lx, Ly) float32 on the device")
    if per_pair and not with_mea:
        raise ValueError("kernel 2M always computes the MEA")
    post = torch.empty((b, lx, ly), dtype=torch.float32, device=xb.device)
    mea = torch.empty((b,), dtype=torch.float32, device=xb.device)
    name = "pairhmm_bwd_post_multi" if per_pair else "pairhmm_bwd_post"
    lib = _lib("pairhmm_bwd_post")
    wave, _bufs = _wave_args(geo, b, lx, ly, "bwd", xb.device)
    rc = lib.pairhmm_bwd_post(_ptr(xb), _ptr(yb), _ptr(lxb), _ptr(lyb),
                              _ptr(match), _ptr(insert), _ptr(params),
                              int(per_pair), _ptr(tot), b, lx, ly, kk,
                              int(with_mea), *wave,
                              _ptr(fm), _ptr(post), _ptr(mea), _stream(xb))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    SCHEDULES[(name, geo.schedule, ly)] += 1
    return post, mea


def bwd_codes_geometry(b: int, ly: int, schedule: str | None = None,
                       g: int | None = None) -> ABGeometry:
    """Kernel 3K's schedule for B pairs at width Ly: `schedule` if given,
    else the wave beyond BWD_CODES_WAVE_MIN_LY, and from
    BWD_CODES_FEW_MIN_LY for at most BWD_CODES_WAVE_MAX_B pairs; G as
    `ab_geometry`. Its block body runs one segment a warp, so "block"
    beyond WAVE_MIN_LY raises."""
    if schedule is None:
        wave = ly > BWD_CODES_WAVE_MIN_LY or (
            ly >= BWD_CODES_FEW_MIN_LY and b <= BWD_CODES_WAVE_MAX_B)
        schedule = "wave" if wave else "block"
    if schedule == "block" and ly > WAVE_MIN_LY:
        raise ValueError(f"kernel 3K's block body runs up to {WAVE_MIN_LY} "
                         f"lanes, not {ly}: the wave takes wider rows")
    return ab_geometry(b, ly, schedule, g)


def pairhmm_bwd_codes(xb, yb, lxb, lyb, match, insert, params,
                      schedule: str | None = None, g: int | None = None,
                      corner: bool = False):
    """Kernel 3K (legacy backward from letters: RB_M (B, Lx, Ly), rows
    u >= lx zero, on the block schedule the lanes past ly of rows u < lx
    unwritten), with one table set or one a pair, on the schedule
    `bwd_codes_geometry(B, Ly, schedule, g)` picks (the wave: kernel 3's;
    the caller then runs `wavefront.check_waits`). CPU tensors run
    `bwd_codes_plain`.

    With `corner`, returns (RB_M, (B, 5)): each pair's five backward
    states at the reversed lattice's far corner (row lx, column ly), as
    `bwd_codes_plain(..., corner=True)`. The kernel then runs one step
    more, row lx, which it does not write to RB_M: it is launched on
    codes padded to Lx + 1 rows (so that step exists where lx = Lx), and
    the first Lx rows of its RB_M are returned (a view)."""
    geo = bwd_codes_geometry(wavefront.geometry_pairs(xb.shape[0]),
                             yb.shape[1], schedule, g)
    if not _on_card(xb):
        return bwd_codes_plain(xb, yb, lxb, lyb, match, insert, params,
                               corner)
    b, lx, ly, kk = _check_inputs(xb, yb, lxb, lyb, match, insert, params)
    per_pair = match.dim() == 3
    lx_pad = lx
    far = None
    if corner:
        xb = torch.nn.functional.pad(xb, (0, 1)).contiguous()
        lx = lx + 1
        far = torch.empty((b, 5), dtype=torch.float32, device=xb.device)
    rbm = torch.empty((b, lx, ly), dtype=torch.float32, device=xb.device)
    lib = _lib("pairhmm_bwd_codes")
    wave, _bufs = _wave_args(geo, b, lx, ly, "bwd", xb.device)
    rc = lib.pairhmm_bwd_codes(_ptr(xb), _ptr(yb), _ptr(lxb), _ptr(lyb),
                               _ptr(match), _ptr(insert), _ptr(params),
                               int(per_pair), b, lx, ly, kk, *wave,
                               _ptr(rbm),
                               ctypes.c_void_p(0) if far is None
                               else _ptr(far), _stream(xb))
    _raise_on(lib, rc, "pairhmm_bwd_codes")
    LAUNCHES["pairhmm_bwd_codes"] += 1
    SCHEDULES[("pairhmm_bwd_codes", geo.schedule, ly)] += 1
    if corner:
        return rbm[:, :lx_pad], far
    return rbm


def letter_path(xb, yb, lxb, lyb, match, insert, params, with_mea=True,
                fused=None):
    """Posteriors (B, Lx, Ly) f32 and EA (B,) f32 of a letter batch with
    one table set or one a pair (the JAX package's `_letter_path`
    without its emission-lattice branch: the lattice route gives these
    kernels' bits, PERF.md). Fused (default FUSED): kernel A/1M, the
    total-probability fold, kernel B/2M. Legacy: kernel A/1M, kernel 3K,
    `finish_posteriors` (each pair's start scores) and kernel 4; the
    route's hand-overs checked after it (`wavefront.check_waits`)."""
    if fused is None:
        fused = FUSED
    xb = xb.to(torch.int32).contiguous()
    yb = yb.to(torch.int32).contiguous()
    lxb = lxb.to(torch.int32).contiguous()
    lyb = lyb.to(torch.int32).contiguous()
    fm, fend = pairhmm_fwd(xb, yb, lxb, lyb, match, insert, params)
    if fused:
        tot = _total_prob(fend, params).contiguous()
        post, mea = pairhmm_bwd_post(xb, yb, lxb, lyb, match, insert, params,
                                     tot, fm, with_mea)
    else:
        from .pairhmm_emis_cuda import finish_posteriors, mea_scores
        rbm = pairhmm_bwd_codes(xb, yb, lxb, lyb, match, insert, params)
        post = finish_posteriors(fm, rbm, fend, lxb, lyb, params)
        del rbm
        mea = mea_scores(post, lxb, lyb) if with_mea else None
    if _on_card(xb) and (not fused
                         or ab_geometry(*yb.shape).schedule == "wave"):
        wavefront.check_waits(xb.device)    # raises on a stuck hand-over
    if with_mea:
        ea = mea / torch.minimum(lxb, lyb).float()
    else:
        ea = torch.zeros(xb.shape[0], dtype=torch.float32, device=xb.device)
    return post, ea


def batch_posteriors_cuda(xb, yb, lxb, lyb, pack, with_mea: bool = True,
                          fused=None):
    """Posteriors (B, Lx, Ly) f32 and EA (B,) f32 for a batch of pairs
    under one score pack (`letter_path`). Same contract as
    ops.pairhmm.batch_posteriors."""
    match, insert, params = tables(pack, xb.device)
    return letter_path(xb, yb, lxb, lyb, match, insert, params, with_mea,
                       fused)


def batch_posteriors_cuda_multi(xb, yb, lxb, lyb, match_b, insert_b, start_b,
                                tv_b, fused=None):
    """batch_posteriors_cuda with per-pair score tables (the JAX
    package's batch_posteriors_pallas_multi): match_b (B, K+1, K+1),
    insert_b (B, K+1), start_b (B, 5), tv_b (B, 7). Fused: kernels 1M,
    2M; legacy: 1M, 3K, finish_posteriors, 4."""
    return letter_path(xb, yb, lxb, lyb, match_b.contiguous(),
                       insert_b.contiguous(), params_rows(start_b, tv_b),
                       True, fused)
