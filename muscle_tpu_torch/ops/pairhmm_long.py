"""Long-sequence pair-HMM: row-block checkpointing + recompute.

Torch port of muscle_tpu.ops.pairhmm_long, the route the JAX package's
long-pair router takes for pairs beyond every kernel's budget, and for
every long pair on the CPU. The reference hard-caps pairwise alignment
at LX*LY*5+100 <= INT_MAX (~21k x 21k, reference: src/calcpost.cpp:8-9,
src/fwdflat3.cpp:17-18) because it materializes full forward+backward
lattices. Here the Forward and Backward scans run once storing only
O(Lx/R) checkpointed carry rows (5 states x (Ly+1) floats each), then
each R-row block of the posterior is rebuilt by re-running the scans
from the nearest checkpoints, combined with the total probability,
thresholded at 0.01 and sparsified to the fixed-K row layout at once.
Peak memory is O(Ly * (Lx/R + R + K)) instead of O(Lx * Ly).

All math is the row step of ops/pairhmm.py (`_fwd_step`, `_bwd_step` and
the boundary rows), so the blocked output equals the monolithic
`batch_posteriors` wherever both fit. JAX runs this route as a
`lax.scan`, with no Pallas kernel; the port runs the same steps as a
Python loop over rows, on the device it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pairhmm as ph
from .logspace import LOG_ZERO, exp_f32, log_add
from .sparse import sparsify


def _ceil_div(a, b):
    return -(-a // b)


def _run_block(xrows, y, row_state, i_start: int, match, insert, start, tv,
               bwd: bool):
    """Run len(xrows) scan rows from the carry `row_state` (the first of
    them is row i_start, 1-based), building emissions on the device.
    Returns (M rows (n, Ly+1), final state)."""
    e = match[xrows][:, y]
    insx = insert[xrows]
    ins_y = insert[y][None, :]
    state = row_state
    rows = []
    for t in range(xrows.shape[0]):
        if bwd:
            state = ph._bwd_step(state, e[t:t + 1], insx[t:t + 1, None],
                                 ins_y, tv)
        else:
            state = ph._fwd_step(state, i_start + t, e[t:t + 1],
                                 insx[t:t + 1, None], ins_y, start, tv)
        rows.append(state[0])
    return torch.cat(rows), state


def _combine_block(fm_rows, rb_all, i0: int, u_base: int, lx: int, total,
                   mea_row, k: int):
    """Posterior rows for forward rows i = i0+1 .. i0+R from F_M rows and
    recomputed RB_M rows (rb_all[t] = RB_M(u_base + t)). Returns (vals,
    cols, updated MEA running row); the posterior as
    ops/pairhmm.py::batch_posteriors computes it."""
    r = fm_rows.shape[0]
    dev = fm_rows.device
    # B_M(i, j) = RB_M(lx - i, ly - j); block row t has i = i0 + 1 + t
    loc = (lx - i0 - 1 - torch.arange(r, device=dev)) - u_base
    b_m = rb_all[loc].flip(1)[:, 1:]         # col j-1 = RB[.., ly-j]
    score = fm_rows[:, 1:] + b_m - total
    post = torch.where(score >= ph.MIN_SPARSE_SCORE,
                       exp_f32(torch.clamp(score, ph.MIN_SPARSE_SCORE - 1.0,
                                           0.0)),
                       torch.zeros((), dtype=torch.float32, device=dev))
    # MEA running row (reference: src/calcalnscoreflat.cpp)
    for prow in post:
        cand = torch.maximum(mea_row[:-1] + prow, mea_row[1:])
        mea_row = torch.cat([mea_row[:1] * 0, torch.cummax(cand, 0).values])
    v, c, _ = sparsify(post[None], k)
    return v[0], c[0], mea_row


def long_pair_posterior_sparse(x_codes, y_codes, pack, k: int = 32,
                               row_block: int = 512, device="cpu"):
    """Posterior of one (possibly very long) pair in sparse form.

    x_codes/y_codes: int codes (unpadded). Returns
    (vals (Lx, k) f32, cols (Lx, k) int32, ea float, total float), the
    arrays on the host.
    """
    match, insert, start, tv = ph.score_args(pack, device)
    lx, ly = len(x_codes), len(y_codes)
    x = torch.as_tensor(np.asarray(x_codes, np.int64), device=device)
    y = torch.as_tensor(np.asarray(y_codes, np.int64), device=device)
    xr, yr = x.flip(0), y.flip(0)
    nb = _ceil_div(lx, row_block)

    def run_ckpt(codes_rows, codes_cols, boundary, bwd):
        state = boundary
        cks = [state]
        for b in range(nb):
            rows = codes_rows[b * row_block:min((b + 1) * row_block, lx)]
            _, state = _run_block(rows, codes_cols, state, b * row_block + 1,
                                  match, insert, start, tv, bwd)
            cks.append(state)
        return cks

    fwd_bound = ph.fwd_boundary_row(insert[y][None, :], start, tv)
    bwd_bound = ph.bwd_boundary_row(insert[yr][None, :], start, tv)
    with torch.no_grad():
        fwd_cks = run_ckpt(x, y, fwd_bound, False)
        bwd_cks = run_ckpt(xr, yr, bwd_bound, True)

        # total prob: fold F[s](lx, ly) + start over the states
        # (src/totalprobflat.cpp:3-16)
        fstate = fwd_cks[-1]
        bstart = (start[0], start[1], start[1], start[3], start[3])
        total = torch.full((), LOG_ZERO, dtype=torch.float32, device=device)
        for s in range(5):
            total = log_add(total, fstate[s][0, ly] + bstart[s])

        vals_out = np.zeros((lx, k), np.float32)
        cols_out = np.full((lx, k), -1, np.int32)
        mea_row = torch.zeros((ly + 1,), dtype=torch.float32, device=device)
        for b in range(nb):
            i0 = b * row_block
            r = min(row_block, lx - i0)
            fm_rows, _ = _run_block(x[i0:i0 + r], y, fwd_cks[b], i0 + 1,
                                    match, insert, start, tv, False)
            # backward rows u in [lx-i0-r, lx-i0-1]; resume from the
            # checkpoint at or below u_lo (spans <= 2 backward blocks).
            # The checkpoint's own row u_ck leads rb_all: u_lo == u_ck
            # whenever lx is a multiple of row_block, and the JAX package,
            # which starts rb_all at u_ck + 1 for u_ck > 0, then reads
            # index -1 for that row (ROADMAP.md, faults)
            u_lo = lx - i0 - r
            u_hi = lx - i0 - 1
            cb_lo = u_lo // row_block
            u_ck = cb_lo * row_block
            need = u_hi - u_ck
            rb_all = [bwd_cks[cb_lo][0]]
            if need > 0:
                rb_all.append(_run_block(xr[u_ck:u_ck + need], yr,
                                         bwd_cks[cb_lo], u_ck + 1, match,
                                         insert, start, tv, True)[0])
            v, c, mea_row = _combine_block(fm_rows, torch.cat(rb_all), i0,
                                           u_ck, lx, total, mea_row, k)
            vals_out[i0:i0 + r] = v.cpu().numpy()
            cols_out[i0:i0 + r] = c.cpu().numpy()

    mea = float(mea_row[ly])
    ea = mea / min(lx, ly)
    return vals_out, cols_out, ea, float(total)
