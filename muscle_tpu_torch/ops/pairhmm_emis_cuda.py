"""Pair-HMM posteriors from a precomputed emission lattice on the GPU
(the Muscle-3D feature-profile HMM): four hand-written CUDA kernels.

Port of muscle_tpu.ops.pairhmm_pallas's emissions entry
(`batch_posteriors_pallas_emissions`), which takes one of two routes by
the padded lane width Ly, at the JAX package's FUSED_MAX_LY:

* fused, Ly <= FUSED_MAX_LY (`emissions_path_fused`, JAX
  `_emissions_path_fused`): kernel 1E, `pairhmm_fwd_emis`
  (csrc/pairhmm_fwd_emis.cu, replaces `_fwd_kernel` with kk=None), the
  total-probability fold, kernel 2E, `pairhmm_bwd_post_emis`
  (csrc/pairhmm_bwd_post_emis.cu, replaces `_bwd_post_kernel` with
  kk=None, flip_e=True): backward, posterior and MEA in one pass;
* legacy, beyond it (`emissions_path_legacy`): kernel 1E, kernel 3,
  `pairhmm_bwd` (csrc/pairhmm_bwd.cu, replaces `_bwd_kernel`: the
  reversed backward M lattice), `finish_posteriors` (plain torch, JAX
  `_finish_posteriors`), kernel 4, `mea_scores` (csrc/mea_scores.cu,
  replaces `_mea_kernel`).

Kernel 1E runs on kernel A's two schedules (`pairhmm_cuda.ab_geometry`):
one block a pair up to WAVE_MIN_LY = 2048 lanes, beyond it each pair's
row as a skewed wavefront of groups of G segments across SMs
(csrc/pairhmm_wave.cuh's forward body, the lattice read a row ahead;
`fwd_wave_plain` is its twin). Kernel 3 runs on the wave at every width
(`bwd_geometry`: the backward body in kernel 3's layout;
`bwd_wave_plain` is its twin, and kernel 3K's on the wave). A caller
runs `wavefront.check_waits` after a wave launch, as both routes do.
Kernel 4 runs each pair's rows as a wavefront of bands of 32 rows, a
round of up to 16 bands a block and the next round on another block,
which reads the round's last row from device memory (csrc/mea_wave.cuh,
shared with mea_dirs; `mea_scores_warps` picks the bands a block from B
and Lx; `mea_scores_wave_plain` is its twin); the legacy route checks
the waits of its kernels once, after kernel 4.

Kernels 1E and 2E are kernels A and B (ops/pairhmm_cuda.py) with the
lattice as their emission source (csrc/pairhmm_common.cuh); fed the
letter lattice match[x_i, y_j] they give kernels A and B's bits.

Beside each kernel is its plain version (`*_plain`), the torch
transcription of the kernel's own association: kernel and plain version
agree bit for bit on the card (chip_smoke.py). A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the
kernel or raises. `LAUNCHES` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import devjoin_cuda as djc
from . import wavefront
from .logspace import LOG_ZERO
from .pairhmm import MIN_SPARSE_SCORE
from .pairhmm_cuda import (NEG_BIG, SCHEDULES, _cumsum_lanes, _log_add,
                           _log_add5, _log_add_p, _on_card, _ptr, _raise_on,
                           _seg_rounds, _shift_fill, _stream, _total_prob,
                           _unpack, _wave_args, ab_geometry, bwd_post_rows,
                           bwd_rows, fwd_rows, load_libs, params_vec,
                           reversed_lanes)

# lane-axis cap of the fused route, the JAX package's value (there, the
# fused backward's VMEM scratch); the legacy route takes wider pads
FUSED_MAX_LY = 9856
# lane-axis cap of the emissions path: the legacy route's rung 12288,
# chains of up to 12288 residues. Kernels 1E and 3 run wider rows on the
# wave; what stops wider pads is the sparsify's whole-row sort
# (ops/sparse.py; ROADMAP.md, queue 1, item 4)
MAX_LY = 12288

LAUNCHES = {"pairhmm_fwd_emis": 0, "pairhmm_bwd_post_emis": 0,
            "pairhmm_bwd": 0, "mea_scores": 0}

# kernel 4 (csrc/mea_scores.cu, whose constants these repeat; its stage
# and hand-over rings are mea_dirs', devjoin_cuda.MEA_*): at most this
# many warps a block, and a round's last row published to the next
# round's block every LINK_HAND columns
MEA_SCORES_MAX_WARPS = 16
MEA_SCORES_LINK_HAND = 32

# batches each route took since the last reset_routes()
ROUTES = {"fused": 0, "legacy": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_routes() -> None:
    for k in ROUTES:
        ROUTES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fwd_emis_plain(e, ins_x, ins_y, lxb, lyb, params):
    """Plain version of kernel 1E: kernel A's recurrence (fwd_rows) over
    the lattice e (B, Lx, Ly) with x / y insert scores (B, Lx), (B, Ly).
    Returns (fm (B, Lx, Ly), fend (B, 5))."""
    return fwd_rows(lambda i: (e[:, i], ins_x[:, i:i + 1]), ins_y, lxb, lyb,
                    params, e.shape[1])


def bwd_post_emis_plain(e, ins_x, ins_y, lxb, lyb, params, tot, fm):
    """Plain version of kernel 2E: kernel B's recurrence (bwd_post_rows)
    reading the forward-layout lattice through reversed lanes (lane q is
    column Ly-1-q). Returns (post (B, Lx, Ly), mea (B,))."""
    return bwd_post_rows(lambda xi: (e[:, xi].flip(1), ins_x[:, xi:xi + 1]),
                         ins_y.flip(1), lxb, lyb, params, tot, fm, True)


def bwd_plain(e, ins_x, ins_y, lxb, lyb, params):
    """Plain version of kernel 3: the Pallas `_bwd_kernel` over the
    reversed sequences (bwd_rows), reading e through reversed indices
    (e_rev[b, u, v] = e[b, lx-1-u, ly-1-v], LOG_ZERO for v >= ly).
    Returns RB_M (B, Lx, Ly); rows u >= lx are zero.
    reference: src/bwdflat3.cpp:10-190."""
    ar = torch.arange(e.shape[0], device=e.device)
    return bwd_rows(lambda xi: (e[ar, xi], ins_x[ar, xi][:, None]), ins_y,
                    lxb, lyb, params, e.shape[1])


def fwd_wave_plain(e, ins_x, ins_y, lxb, lyb, params, g: int):
    """Twin of kernel 1E's wide schedule (csrc/pairhmm_wave.cuh's
    forward body with the lattice source): each pair's row cut into
    groups of g 64-lane segments, run here group after group, each row
    of a group taking from its left neighbour's record of that row what
    the block kernel reads across the edge: the fold's last lane (left
    of the M shift), the M row's last lane (left of the scans' M shift)
    and the IY/JY carries leaving it (the chain continued in segment
    order); group 0 the column-0 chains. Row 0's IY/JY come from the
    launch's full-width rounds (`_cumsum_lanes`, as row_cumsum2).
    Returns (fm, fend) as fwd_emis_plain (fm on the real cells)."""
    (tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM) = _unpack(params)
    b, n_rows, width = e.shape
    dev = e.device
    ar = torch.arange(b, device=dev)
    iy0 = tSI - tII + _cumsum_lanes(ins_y + tII)
    jy0 = tSJ - tJJ + _cumsum_lanes(ins_y + tJJ)
    gw = 64 * g
    fm = torch.empty((b, n_rows, width), dtype=torch.float32, device=dev)
    fend = torch.full((b, 5), LOG_ZERO, dtype=torch.float32, device=dev)
    lx = lxb.long()
    left = None     # the left group's records, (B, n_rows) each
    for g0 in range(0, width, gw):
        sl = slice(g0, g0 + gw)
        insy = ins_y[:, sl]
        lz = torch.full((b, gw), LOG_ZERO, dtype=torch.float32, device=dev)
        m, ix, jx, iy, jy = lz, lz, lz, iy0[:, sl], jy0[:, sl]
        ix0 = jx0 = torch.full((b, 1), LOG_ZERO, dtype=torch.float32,
                               device=dev)
        rec = {k: torch.empty((b, n_rows), dtype=torch.float32, device=dev)
               for k in ("c", "m", "ci", "cj")}
        col = lyb.long() - 1 - g0
        holds = (col >= 0) & (col < gw)
        col = col.clamp(0, gw - 1)
        for i in range(n_rows):
            e_row, insx = e[:, i, sl], ins_x[:, i:i + 1]
            comb = _log_add5(m + tMM, ix + tIM, jx + tJM, iy + tIM, jy + tJM)
            fill = (left["c"][:, i:i + 1] if left
                    else _log_add(ix0 + tIM, jx0 + tJM))
            m_new = _shift_fill(comb, fill) + e_row
            if left is None and i == 0:
                m_new[:, :1] = tSM + e_row[:, :1]
            ix_new = _log_add(ix + tII, m + tMI) + insx
            jx_new = _log_add(jx + tJJ, m + tMJ) + insx
            if i == 0:
                ix0, jx0 = tSI + insx, tSJ + insx
            else:
                ix0, jx0 = ix0 + tII + insx, jx0 + tJJ + insx
            m_sh = _shift_fill(m_new, left["m"][:, i:i + 1] if left
                               else LOG_ZERO)
            iy, ci = _group_scan(insy + tII, m_sh + tMI + insy,
                                 left["ci"][:, i:i + 1] if left else NEG_BIG)
            jy, cj = _group_scan(insy + tJJ, m_sh + tMJ + insy,
                                 left["cj"][:, i:i + 1] if left else NEG_BIG)
            m, ix, jx = m_new, ix_new, jx_new
            fm[:, i, sl] = m
            rec["c"][:, i], rec["m"][:, i] = comb[:, -1], m[:, -1]
            rec["ci"][:, i], rec["cj"][:, i] = ci[:, 0], cj[:, 0]
            last = holds & (lx == i + 1)
            if bool(last.any()):
                vals = torch.stack([r[ar, col] for r in (m, ix, iy, jx, jy)],
                                   dim=1)
                fend = torch.where(last[:, None], vals, fend)
        left = rec
    return fm, fend


def _group_scan(a, c, carry):
    """The IY/JY scan of one group of the wave: the rounds inside each
    64-lane segment, then the carry chain over the group's segments
    continued from `carry` (the chain leaving the left group, NEG_BIG
    for group 0). Returns (scanned c, the carry leaving the group)."""
    a, c = _seg_rounds(a, c)
    out = []
    for k in range(0, a.shape[1], 64):
        seg = slice(k, k + 64)
        out.append(_log_add_p(carry + a[:, seg], c[:, seg]))
        carry = _log_add_p(carry + a[:, k + 63:k + 64], c[:, k + 63:k + 64])
    return torch.cat(out, dim=1), carry


def bwd_wave_plain(e, ins_x, ins_y, lxb, lyb, params, g: int):
    """Twin of kernel 3's wide schedule (csrc/pairhmm_wave.cuh's
    backward body, kLegacy): each pair's row cut into groups of g
    64-lane segments, run here group after group, each step of a group
    taking from its left neighbour's record of that step what the block
    kernel reads across the edge: the last lane's M (of the step before,
    for the M shift; of the step, for RB_M's shift), IY and JY, and the
    IY/JY carries leaving it (the chain continued in segment order);
    group 0 the column-0 chains. The boundary row comes from the
    launch's full-width rounds (`_cumsum_lanes`, as row_cumsum2).
    Returns RB_M as bwd_plain."""
    (tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM) = _unpack(params)
    b, n_rows, width = e.shape
    dev = e.device
    ar = torch.arange(b, device=dev)
    lx = lxb.long()
    insy_all = reversed_lanes(ins_y, lyb)
    iy0 = tSI + _cumsum_lanes(insy_all + tII)
    jy0 = tSJ + _cumsum_lanes(insy_all + tJJ)
    gw = 64 * g
    rbm = torch.empty((b, n_rows, width), dtype=torch.float32, device=dev)
    col = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    left = None     # the left group's records, (B, n_rows) each
    for g0 in range(0, width, gw):
        sl = slice(g0, g0 + gw)
        insy = insy_all[:, sl]
        fill_i = iy0[:, g0 - 1:g0] if left else tSI
        fill_j = jy0[:, g0 - 1:g0] if left else tSJ
        m = _log_add(tMI + _shift_fill(iy0[:, sl], fill_i) + insy,
                     tMJ + _shift_fill(jy0[:, sl], fill_j) + insy)
        lz = torch.full((b, gw), LOG_ZERO, dtype=torch.float32, device=dev)
        ix, jx, iy, jy = lz, lz, iy0[:, sl], jy0[:, sl]
        ix0, jx0, m0 = col + tSI, col + tSJ, col + tSM
        rec = {k: torch.empty((b, n_rows), dtype=torch.float32, device=dev)
               for k in ("m", "iy", "jy", "ci", "cj")}

        def edge(k, u, own):
            return left[k][:, u:u + 1] if left else own

        rbm[:, 0, sl] = _shift_fill(m, edge("m", 0, m0))
        rec["m"][:, 0], rec["iy"][:, 0], rec["jy"][:, 0] = (
            m[:, -1], iy[:, -1], jy[:, -1])
        rec["ci"][:, 0] = rec["cj"][:, 0] = NEG_BIG
        for u in range(1, n_rows):
            xi = (lx - u).clamp(min=0)
            e_row = reversed_lanes(e[ar, xi], lyb)[:, sl]
            insx = ins_x[ar, xi][:, None]
            next_m = _shift_fill(m, edge("m", u - 1, m0)) + e_row
            next_ix = ix + insx
            next_jx = jx + insx
            ix = _log_add(tII + next_ix, tIM + next_m)
            jx = _log_add(tJJ + next_jx, tJM + next_m)
            m0 = _log_add(tMI + ix0 + insx, tMJ + jx0 + insx)
            ix0, jx0 = tII + ix0 + insx, tJJ + jx0 + insx
            iy, ci = _group_scan(insy + tII, tIM + next_m,
                                 edge("ci", u, NEG_BIG))
            jy, cj = _group_scan(insy + tJJ, tJM + next_m,
                                 edge("cj", u, NEG_BIG))
            next_iy = _shift_fill(iy, edge("iy", u, LOG_ZERO)) + insy
            next_jy = _shift_fill(jy, edge("jy", u, LOG_ZERO)) + insy
            m = _log_add5(tMM + next_m, tMI + next_ix, tMJ + next_jx,
                          tMI + next_iy, tMJ + next_jy)
            rbm[:, u, sl] = _shift_fill(m, edge("m", u, m0))
            rec["m"][:, u], rec["iy"][:, u], rec["jy"][:, u] = (
                m[:, -1], iy[:, -1], jy[:, -1])
            rec["ci"][:, u], rec["cj"][:, u] = ci[:, 0], cj[:, 0]
        left = rec
    rows = torch.arange(n_rows, device=dev)[None, :, None]
    return torch.where(rows < lx[:, None, None], rbm, 0.0)


def mea_scores_plain(post):
    """Plain version of kernel 4 (the Pallas `_mea_kernel`): the MEA row
    scan over every row of post (B, Lx, Ly); the score is the last lane.
    reference: src/calcalnscoreflat.cpp:4-32."""
    old = torch.zeros((post.shape[0], post.shape[2]), dtype=torch.float32,
                      device=post.device)
    for i in range(post.shape[1]):
        e = torch.maximum(_shift_fill(old, 0.0) + post[:, i], old)
        old = torch.cummax(torch.clamp(e, min=0.0), dim=1).values
    return old[:, -1]


def mea_scores_warps(b: int, lx: int, sms: int = 132) -> int:
    """Warps a block of kernel 4 (bands of 32 rows a round), at most one
    a band of the Lx padded rows: 16 while B pairs in blocks of 16 bands
    fill fewer than two waves of the card's `sms` SMs (a block of 16
    warps takes an SM's shared memory), so that a pair's chain crosses
    the fewest links between blocks; 8 below three waves; else 4, so
    that less of each block idles in the skew of its bands. On an H100
    80GB HBM3 at 700 W (132 SMs; tools/torch_mea_bwd_probe.py --time
    --warps) 16 was fastest at mega-long's chunk (8 x 12288^2), at 16-132
    ragged pairs at 512 and 64 at 2048, 8 at 264 pairs at 512, 4 at 512
    pairs at 512 (0.199 ms against 0.290 at 16)."""
    nb = -(-lx // 32)
    blocks = b * -(-nb // MEA_SCORES_MAX_WARPS)
    warps = (MEA_SCORES_MAX_WARPS if blocks < 2 * sms
             else 8 if blocks < 3 * sms else 4)
    return max(1, min(nb, warps))


def mea_scores_rounds(lx: int, warps: int) -> int:
    """Rounds of bands a pair, one block each, over the Lx padded rows."""
    return -(-(-(-lx // 32)) // warps)


def mea_scores_buffers(b: int, lx: int, ly: int, warps: int, device):
    """(sync, links) of a launch of kernel 4: the ticket and each block's
    link count (int32, zeroed), and the link rows, Ly floats for each
    block of every round but the last (whose blocks hand nothing on)."""
    rounds = mea_scores_rounds(lx, warps)
    sync = torch.zeros(1 + b * rounds, dtype=torch.int32, device=device)
    links = torch.empty(max(1, b * (rounds - 1) * ly), dtype=torch.float32,
                        device=device)
    return sync, links


class _Band:
    """One warp of kernel 4's schedule: its band, step and stage ring (32
    rows and the link row, slot 0 also past the last, and the link
    positions it holds), and its lanes' registers (one row a lane)."""

    def __init__(self, w: int, band: int):
        self.w, self.band = w, band
        self.s = 0
        self.next_chunk = 0
        cols = djc.MEA_CHUNK * (djc.MEA_SLOTS + 1)
        self.stage = np.zeros((33, cols), np.float32)
        self.stage_pos = np.full(cols, -1, np.int64)
        # columns -31 .. -1 (the last two slots) read as zeros
        ring_cols = djc.MEA_CHUNK * djc.MEA_SLOTS
        self.stage[:32, ring_cols - 2 * djc.MEA_CHUNK:ring_cols] = 0.0
        self.cur = np.zeros(32, np.float32)
        self.oldj = np.zeros(32, np.float32)
        self.hcol = np.zeros(djc.MEA_HAND, np.float32)
        lanes = np.arange(32)
        self.jm = np.where(lanes == 0, 0, ring_cols - lanes)


class _Round:
    """One block of kernel 4's schedule: ticket t, round t // B of pair
    t % B, its warps' bands and their hand-over rings."""

    def __init__(self, t: int, b_count: int, warps: int, lxs, lys):
        self.t, self.r, self.b = t, t // b_count, t % b_count
        self.lx, self.ly = int(lxs[self.b]), int(lys[self.b])
        self.nb = -(-self.lx // 32) if self.ly > 0 else 0
        self.bands = [_Band(w, self.r * warps + w) for w in range(warps)
                      if self.r * warps + w < self.nb]
        self.ring = np.zeros((warps, djc.MEA_RING), np.float32)
        self.ring_pos = np.full((warps, djc.MEA_RING), -1, np.int64)
        self.taken = np.zeros(warps, np.int64)


def mea_scores_wave_plain(post, lxb, lyb, warps: int | None = None,
                          resident: int | None = None):
    """Kernel 4's schedule on the CPU (csrc/mea_scores.cu), numpy: blocks
    taking tickets in order (at most `resident` at once, all if None),
    ticket t running round t // B of pair t % B with `warps` warps
    (default mea_scores_warps), one band of 32 rows a warp; lane t of a
    band computes row 32 band + t's column s - t at band step s from
    lane t-1's values of the step before, on every step (zeros before
    its row starts and past ly); lane 0 from the band above, HAND
    columns at a time, through warp w-1's ring inside the block (waiting
    while a slot holds another position; lane 31 waits for room) or, for
    warp 0 of a later round, from the link row of the block of ticket t
    - B, staged chunk by chunk once its count covers the chunk (each read
    checks that its slot holds the column it wants: a read before the
    write raises); the posterior through the stage ring's slots, rows
    past lx and columns past ly as zeros. Every warp takes one step a
    tick when its waits allow; a tick where none can and no block can
    start is a deadlock and raises. Returns the (B,) scores, as
    mea_scores_plain for a posterior zero outside each pair's (lx, ly)."""
    p = post.detach().cpu().numpy().astype(np.float32, copy=False)
    b_count, n_rows, width = p.shape
    w_count = warps or mea_scores_warps(b_count, n_rows)
    tickets = b_count * mea_scores_rounds(n_rows, w_count)
    lxs = np.minimum(lxb.cpu().numpy(), n_rows)
    lys = np.minimum(lyb.cpu().numpy(), width)
    chunk, hand, ring_n = djc.MEA_CHUNK, djc.MEA_HAND, djc.MEA_RING
    ring_cols = chunk * djc.MEA_SLOTS
    out = np.zeros(b_count, np.float32)
    links = np.zeros((tickets, width), np.float32)
    link_pos = np.full((tickets, width), -1, np.int64)
    counts = np.zeros(tickets, np.int64)
    lanes = np.arange(32)

    def stage_chunk(blk: _Round, wp: _Band, c: int, link_in: bool) -> bool:
        """Chunk c into its slot (slot 0 also past the last), zeros past
        lx and ly; False (nothing staged) while the link's count is short
        of it."""
        col0 = c * chunk
        src = blk.t - b_count
        if (link_in and col0 < blk.ly
                and counts[src] < min(col0 + chunk, blk.ly)):
            return False
        part = np.zeros((32, chunk), np.float32)
        r0 = wp.band * 32
        cut = p[blk.b, r0:min(r0 + 32, blk.lx), col0:min(col0 + chunk, blk.ly)]
        part[:cut.shape[0], :cut.shape[1]] = cut
        slot = (c % djc.MEA_SLOTS) * chunk
        for at in ((slot, ring_cols) if slot == 0 else (slot,)):
            wp.stage[:32, at:at + chunk] = part
            if link_in and col0 < blk.ly:
                wp.stage[32, at:at + chunk] = links[src, col0:col0 + chunk]
                wp.stage_pos[at:at + chunk] = link_pos[src, col0:col0 + chunk]
        return True

    def step(blk: _Round, wp: _Band) -> bool:
        """Band step s of warp wp; False when a wait holds it."""
        w, s, ly = wp.w, wp.s, blk.ly
        has_out = wp.band + 1 < blk.nb
        ring_in, link_in = w > 0, w == 0 and blk.r > 0
        ring_out = has_out and w < w_count - 1
        link_out = has_out and w == w_count - 1
        s0, k = s - s % chunk, s % chunk
        while wp.next_chunk <= s0 // chunk + djc.MEA_AHEAD:
            if not stage_chunk(blk, wp, wp.next_chunk, link_in):
                return False
            wp.next_chunk += 1
        if k % hand == 0:
            # the band above's next n columns, every slot written, or wait
            n = max(0, min(hand, ly - s))
            want = s + np.arange(n)
            hcol = np.zeros(hand, np.float32)
            if ring_in and n:
                slot = want % ring_n
                if (blk.ring_pos[w - 1, slot] != want).any():
                    return False
                hcol[:n] = blk.ring[w - 1, slot]
                blk.taken[w - 1] = want[-1] + 1
            if link_in and n:
                at = wp.jm[0] + k + np.arange(n)
                if (wp.stage_pos[at] != want).any():
                    raise RuntimeError(
                        f"mea_scores schedule: ticket {blk.t} band "
                        f"{wp.band} wants link columns {want}, its slots "
                        f"hold {wp.stage_pos[at]}")
                hcol[:n] = wp.stage[32, at]
            last31 = min(s + hand - 1 - 31, ly - 1)
            if (ring_out and last31 >= 0
                    and blk.taken[w] < last31 + 1 - ring_n):
                return False            # lane 31 waits on the ring's room
            wp.hcol = hcol
        x = np.roll(wp.cur, 1)
        x[0] = wp.hcol[k % hand]
        wp.cur = np.maximum(wp.cur, np.maximum(
            wp.oldj + wp.stage[lanes, wp.jm + k], x))
        wp.oldj = x
        j31 = s - 31
        if 0 <= j31 < ly:
            if ring_out:
                blk.ring[w, j31 % ring_n] = wp.cur[31]
                blk.ring_pos[w, j31 % ring_n] = j31
            if link_out:
                links[blk.t, j31], link_pos[blk.t, j31] = wp.cur[31], j31
        linked = min(max(s0 + chunk - 31, 0), ly)
        if (link_out and k == chunk - 1 and linked > 0
                and ((s0 // chunk) % (MEA_SCORES_LINK_HAND // chunk)
                     == MEA_SCORES_LINK_HAND // chunk - 1
                     or (linked == ly and s0 - 31 < ly))):
            counts[blk.t] = linked
        wp.s += 1
        if k == chunk - 1:
            wp.jm = (wp.jm + chunk) % ring_cols
        return True

    def finished(blk: _Round, wp: _Band) -> bool:
        if wp.s < -(-(blk.ly + 31) // chunk) * chunk:
            return False
        if wp.band == (blk.lx - 1) // 32:
            out[blk.b] = wp.cur[(blk.lx - 1) % 32]
        return True

    running, nxt = [], 0
    while nxt < tickets or running:
        while nxt < tickets and (resident is None or len(running) < resident):
            running.append(_Round(nxt, b_count, w_count, lxs, lys))
            nxt += 1
        moved = False
        for blk in running:
            for wp in list(blk.bands):
                if step(blk, wp):
                    moved = True
                    if finished(blk, wp):
                        blk.bands.remove(wp)
        done = [blk for blk in running if not blk.bands]
        running = [blk for blk in running if blk.bands]
        if not moved and not done:
            raise RuntimeError("mea_scores schedule: deadlock")
    return torch.from_numpy(out).to(post.device)


# ---------------------------------------------------------------------------
# kernel build + launch
# ---------------------------------------------------------------------------

_libs: dict = {}


def kernel_specs():
    from ..utils.build import cuda_spec
    from .pairhmm_cuda import kernel_specs as pair_specs
    return (pair_specs(("pairhmm_fwd_emis", "pairhmm_bwd_post_emis",
                        "pairhmm_bwd"))
            + [cuda_spec("mea_scores", deps=djc.mea_deps())])


def _lib(name: str):
    if name not in _libs:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        specs = kernel_specs()
        load_libs(specs[:3],
                  {"pairhmm_fwd_emis": [vp] * 6 + [ci] * 6
                   + [ctypes.c_longlong] + [vp] * 7,
                   "pairhmm_bwd_post_emis": [vp] * 6 + [ci] + [vp]
                   + [ci] * 3 + [vp] * 4,
                   "pairhmm_bwd": [vp] * 6 + [ci] * 6
                   + [ctypes.c_longlong] + [vp] * 6},
                  _libs)
        from ..utils.build import load_kernel
        _libs["mea_scores"] = load_kernel(specs[3], [vp] * 3 + [ci] * 4
                                          + [ctypes.c_longlong] + [vp] * 5)
    return _libs[name]


def _check(e, ins_x, ins_y, lxb, lyb, params, max_ly):
    dev = e.device
    for name, t in (("e", e), ("ins_x", ins_x), ("ins_y", ins_y),
                    ("params", params)):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32 on {dev}")
    for name, t in (("lxb", lxb), ("lyb", lyb)):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {dev}")
    b, lx, ly = e.shape
    if (ins_x.shape != (b, lx) or ins_y.shape != (b, ly)
            or lxb.shape != (b,) or lyb.shape != (b,)
            or params.shape not in ((16,), (b, 16))):
        raise ValueError("shapes disagree")
    if ly % 128 or not 0 < ly <= max_ly or lx < 1:
        raise ValueError(f"Ly={ly} must be a multiple of 128 in "
                         f"[128, {max_ly}]")
    return b, lx, ly


def _per_pair(params) -> int:
    """0 for one (16,) params vector, 1 for (B, 16) rows, one a pair."""
    return int(params.dim() == 2)


def pairhmm_fwd_emis(e, ins_x, ins_y, lxb, lyb, params,
                     schedule: str | None = None, g: int | None = None):
    """Kernel 1E (forward from the lattice), on the schedule
    `ab_geometry(B, Ly, schedule, g)` picks: one block a pair up to
    WAVE_MIN_LY, the wave beyond (the caller then runs
    `wavefront.check_waits`). CPU tensors run `fwd_emis_plain`. Returns
    (fm (B, Lx, Ly), rows >= lx unwritten; fend (B, 5))."""
    geo = ab_geometry(e.shape[0], e.shape[2], schedule, g)
    if not _on_card(e):
        return fwd_emis_plain(e, ins_x, ins_y, lxb, lyb, params)
    b, lx, ly = _check(e, ins_x, ins_y, lxb, lyb, params, MAX_LY)
    fm = torch.empty((b, lx, ly), dtype=torch.float32, device=e.device)
    fend = torch.empty((b, 5), dtype=torch.float32, device=e.device)
    lib = _lib("pairhmm_fwd_emis")
    wave, _bufs = _wave_args(geo, b, lx, ly, "fwd", e.device)
    rc = lib.pairhmm_fwd_emis(_ptr(e), _ptr(ins_x), _ptr(ins_y), _ptr(lxb),
                              _ptr(lyb), _ptr(params), _per_pair(params), b,
                              lx, ly, *wave, _ptr(fm), _ptr(fend), _stream(e))
    _raise_on(lib, rc, "pairhmm_fwd_emis")
    LAUNCHES["pairhmm_fwd_emis"] += 1
    SCHEDULES[("pairhmm_fwd_emis", geo.schedule, ly)] += 1
    return fm, fend


def pairhmm_bwd_post_emis(e, ins_x, ins_y, lxb, lyb, params, tot, fm):
    """Kernel 2E (backward + posterior + MEA from the same lattice). CPU
    tensors run `bwd_post_emis_plain`."""
    if not _on_card(e):
        return bwd_post_emis_plain(e, ins_x, ins_y, lxb, lyb, params, tot,
                                   fm)
    b, lx, ly = _check(e, ins_x, ins_y, lxb, lyb, params, FUSED_MAX_LY)
    if (tot.dtype != torch.float32 or tot.shape != (b,)
            or tot.device != e.device or not tot.is_contiguous()
            or fm.shape != e.shape
            or fm.dtype != torch.float32 or fm.device != e.device
            or not fm.is_contiguous()):
        raise ValueError("tot (B,) / fm (B, Lx, Ly) float32 on the device")
    post = torch.empty((b, lx, ly), dtype=torch.float32, device=e.device)
    mea = torch.empty((b,), dtype=torch.float32, device=e.device)
    lib = _lib("pairhmm_bwd_post_emis")
    rc = lib.pairhmm_bwd_post_emis(
        _ptr(e), _ptr(ins_x), _ptr(ins_y), _ptr(lxb), _ptr(lyb),
        _ptr(params), _per_pair(params), _ptr(tot), b, lx, ly, _ptr(fm),
        _ptr(post), _ptr(mea), _stream(e))
    _raise_on(lib, rc, "pairhmm_bwd_post_emis")
    LAUNCHES["pairhmm_bwd_post_emis"] += 1
    return post, mea


def bwd_geometry(b: int, ly: int):
    """Kernel 3's wave at width Ly: groups of the largest divisor of the
    Ly / 64 segments up to AB_GROUP_SEGMENTS, as kernels A and B's wide
    schedule (`pairhmm_cuda.ab_geometry`)."""
    return ab_geometry(b, ly, "wave")


def pairhmm_bwd(e, ins_x, ins_y, lxb, lyb, params):
    """Kernel 3 (legacy backward: RB_M (B, Lx, Ly), rows >= lx zero), on
    the wave of `bwd_geometry`. CPU tensors run `bwd_plain`. The launch's
    hand-over is checked by the caller (`wavefront.check_waits`, as
    `emissions_path_legacy` does)."""
    if not _on_card(e):
        return bwd_plain(e, ins_x, ins_y, lxb, lyb, params)
    b, lx, ly = _check(e, ins_x, ins_y, lxb, lyb, params, MAX_LY)
    geo = bwd_geometry(b, ly)
    rbm = torch.empty((b, lx, ly), dtype=torch.float32, device=e.device)
    lib = _lib("pairhmm_bwd")
    wave, _bufs = _wave_args(geo, b, lx, ly, "bwd", e.device)
    rc = lib.pairhmm_bwd(_ptr(e), _ptr(ins_x), _ptr(ins_y), _ptr(lxb),
                         _ptr(lyb), _ptr(params), _per_pair(params), b, lx, ly,
                         *wave, _ptr(rbm), _stream(e))
    _raise_on(lib, rc, "pairhmm_bwd")
    LAUNCHES["pairhmm_bwd"] += 1
    SCHEDULES[("pairhmm_bwd", "wave", ly)] += 1
    return rbm


def mea_scores(post, lxb, lyb, warps: int | None = None):
    """Kernel 4 (MEA score, a wavefront of row bands): (B, Lx, Ly)
    posterior, zero outside each pair's (lx, ly) -> (B,) MEA scores; the
    kernel reads no row past lx and no column past ly. Blocks of `warps`
    warps (default mea_scores_warps), one round of bands of a pair each.
    A hand-over that waited past MEA_WAIT_CYCLES sets the fault flag: the
    caller then runs `wavefront.check_waits`, as both routes do. CPU
    tensors run `mea_scores_plain`."""
    if not _on_card(post):
        return mea_scores_plain(post)
    b, lx, ly = post.shape
    dev = post.device
    if (post.dtype != torch.float32 or not post.is_contiguous()
            or post.data_ptr() % 16 or ly % 16 or lx < 1
            or any(t.dtype != torch.int32 or t.shape != (b,)
                   or t.device != dev or not t.is_contiguous()
                   for t in (lxb, lyb))):
        raise ValueError("post (B, Lx, Ly) contiguous float32, Ly % 16 == "
                         "0; lxb, lyb (B,) int32 on the device")
    warps = warps or mea_scores_warps(
        b, lx, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    sync, links = mea_scores_buffers(b, lx, ly, warps, dev)
    fn, err = _lib("mea_scores")
    rc = fn(_ptr(post), _ptr(lxb), _ptr(lyb), b, lx, ly, warps,
            djc.MEA_WAIT_CYCLES, _ptr(sync),
            _ptr(wavefront.fault_flag(dev)), _ptr(links), _ptr(out),
            _stream(post))
    if rc != 0:
        raise RuntimeError(f"mea_scores launch failed: {err(rc).decode()}")
    LAUNCHES["mea_scores"] += 1
    return out


# ---------------------------------------------------------------------------
# the two routes
# ---------------------------------------------------------------------------

def emissions_path_fused(e, ins_x, ins_y, lxb, lyb, params):
    """Kernel 1E, the total-probability fold, kernel 2E (JAX
    `_emissions_path_fused`). Returns (post (B, Lx, Ly), ea (B,))."""
    fm, fend = pairhmm_fwd_emis(e, ins_x, ins_y, lxb, lyb, params)
    if _on_card(e) and ab_geometry(e.shape[0], e.shape[2]).schedule == "wave":
        wavefront.check_waits(e.device)    # raises on a stuck hand-over
    tot = _total_prob(fend, params)
    post, mea = pairhmm_bwd_post_emis(e, ins_x, ins_y, lxb, lyb, params, tot,
                                      fm)
    return post, mea / torch.minimum(lxb, lyb).float()


def finish_posteriors(fm, rbm, fend, lxb, lyb, params):
    """JAX `_finish_posteriors` (or `_finish_posteriors_b`, with each
    pair's start scores from (B, 16) params rows) without its MEA:
    combine the forward M lattice with RB_M, per pair flipped on both
    axes and rolled by (lx - Lx, ly - Ly), into exp(F + B - total), zero
    below the 0.01 threshold and outside (lx, ly). Plain torch, a pair
    at a time; the posterior is written over fm.
    reference: src/calcposteriorflat.cpp:4-27."""
    tot = _total_prob(fend, params)
    b, bx, by = fm.shape
    ii = torch.arange(bx, device=fm.device)[:, None]
    jj = torch.arange(by, device=fm.device)[None, :]
    for k, (lx, ly) in enumerate(zip(lxb.tolist(), lyb.tolist())):
        bm = torch.roll(rbm[k].flip(0, 1), shifts=(lx - bx, ly - by),
                        dims=(0, 1))
        score = fm[k] + bm - tot[k]
        del bm
        keep = (score >= MIN_SPARSE_SCORE) & (ii < lx) & (jj < ly)
        fm[k] = torch.where(keep, torch.exp(torch.clamp(score, max=0.0)), 0.0)
    return fm


def emissions_path_legacy(e, ins_x, ins_y, lxb, lyb, params):
    """Kernel 1E, kernel 3, finish_posteriors, kernel 4 (JAX
    `batch_posteriors_pallas_emissions` beyond FUSED_MAX_LY). Returns
    (post (B, Lx, Ly), ea (B,))."""
    fm, fend = pairhmm_fwd_emis(e, ins_x, ins_y, lxb, lyb, params)
    rbm = pairhmm_bwd(e, ins_x, ins_y, lxb, lyb, params)
    post = finish_posteriors(fm, rbm, fend, lxb, lyb, params)
    del rbm
    mea = mea_scores(post, lxb, lyb)
    if _on_card(e):
        wavefront.check_waits(e.device)    # raises on a stuck hand-over
    return post, mea / torch.minimum(lxb, lyb).float()


def batch_posteriors_emissions_cuda(e, ins_x, ins_y, lxb, lyb, pack):
    """Posteriors (B, Lx, Ly) f32 and EA (B,) f32 from an emission lattice
    e (B, Lx, Ly) and insert scores (B, Lx), (B, Ly); transitions from
    `pack`. The route follows the padded width as in the JAX package:
    fused up to FUSED_MAX_LY, legacy beyond (no reversed lattice is
    built: kernel 3 reads e through reversed indices)."""
    ly = e.shape[2]
    if ly > MAX_LY:
        raise NotImplementedError(
            f"Muscle-3D pads beyond {MAX_LY} (chains over {MAX_LY} residues) "
            "are not ported yet: ROADMAP.md, queue 1, item 4")
    params = params_vec(pack, e.device)
    lxb = lxb.to(torch.int32).contiguous()
    lyb = lyb.to(torch.int32).contiguous()
    args = (e.contiguous(), ins_x.contiguous(), ins_y.contiguous(), lxb, lyb,
            params)
    if ly <= FUSED_MAX_LY:
        ROUTES["fused"] += 1
        return emissions_path_fused(*args)
    ROUTES["legacy"] += 1
    return emissions_path_legacy(*args)
