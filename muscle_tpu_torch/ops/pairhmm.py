"""Batched pair-HMM Forward/Backward/posterior, plain torch (CPU path).

Torch port of muscle_tpu.ops.pairhmm (the XLA-scan reference path the
JAX package takes on the CPU). The reference walks the (LX+1)x(LY+1)
lattice cell by cell (reference: src/fwdflat3.cpp:12-153,
src/bwdflat3.cpp:10-190, src/calcposteriorflat.cpp:4-27); here a
Python loop walks DP rows for a whole batch of pairs at once:

* the M/IX/JX updates of a row are elementwise given the previous row;
* the within-row IY/JY dependence is an affine recurrence in the log
  semiring, u_j = LOG_ADD(u_{j-1} + a_j, c_j), solved by a parallel
  prefix scan whose pairing tree is that of jax.lax.associative_scan
  (`_assoc_scan`), so the CPU results agree with the JAX package's;
* row-0 prefix sums follow XLA's CPU cumsum grouping (`_cumsum_xla`).

Backward runs as a forward-style scan over the reversed sequences
(RB[s](u,v) = Bwd[s](LX-u, LY-v)), so right-padded batches stay exact.
States are ordered [M, IX, IY, JX, JY] as in src/pairhmm.h:11-19.

On a CUDA device the pipeline takes ops/pairhmm_cuda.py instead.
"""

from __future__ import annotations

import numpy as np
import torch

from .logspace import LOG_ZERO, exp_f32, log_add, log_add5

MIN_SPARSE_PROB = 0.01                   # reference: src/mysparsemx.h:3
MIN_SPARSE_SCORE = float(np.log(0.01))   # reference: src/mysparsemx.h:4


def _trans_vec(pack, device="cpu"):
    """Scalar transition scores as a (7,) f32 tensor."""
    return torch.tensor(
        [pack.tMM, pack.tMI, pack.tMJ, pack.tII, pack.tIM, pack.tJJ, pack.tJM],
        dtype=torch.float32, device=device)


def score_args(pack, device="cpu"):
    """ScorePack -> (match, insert, start, tv) tensors for batch_posteriors."""
    return (torch.as_tensor(pack.match, dtype=torch.float32, device=device),
            torch.as_tensor(pack.insert, dtype=torch.float32, device=device),
            torch.as_tensor(pack.start, dtype=torch.float32, device=device),
            _trans_vec(pack, device))


def _interleave(a, b):
    """[a0, b0, a1, b1, ...] along the last axis (len(a) - len(b) in {0, 1})."""
    out = a.new_empty(a.shape[:-1] + (a.shape[-1] + b.shape[-1],))
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def _assoc_scan(fn, elems):
    """Inclusive scan along the last axis with jax.lax.associative_scan's
    pairing tree (combine adjacent pairs, recurse on the half-size
    sequence, fill in the even positions)."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[..., 0:-1:2] for e in elems),
                 tuple(e[..., 1::2] for e in elems))
    odd = _assoc_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(o[..., :-1] for o in odd),
                  tuple(e[..., 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[..., 2::2] for e in elems))
    even = tuple(torch.cat([e[..., :1], r], dim=-1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(ev, od) for ev, od in zip(even, odd))


def _row_affine_scan(a, c):
    """Solve u_j = LOG_ADD(u_{j-1} + a_j, c_j), u_0 = LOG_ZERO, j = 1..n.

    Returns u_1..u_n for a, c of shape (..., n). Composition:
    T2∘T1 = (a1 + a2, LOG_ADD(c1 + a2, c2)).
    """
    def combine(x, y):
        a1, c1 = x
        a2, c2 = y
        return a1 + a2, log_add(c1 + a2, c2)

    _, u = _assoc_scan(combine, (a, c))
    return u


def _cumsum_seq(x):
    """Left-to-right f32 prefix sum along the last axis (0 + x0 + x1 ...)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def _cumsum_xla(x, base: int = 16):
    """Prefix sum along the last axis grouped as XLA's CPU cumsum: blocks
    of `base` summed sequentially, block totals scanned recursively, the
    exclusive block prefix added last."""
    n = x.shape[-1]
    if n <= base:
        return _cumsum_seq(x)
    m = -(-n // base)
    xp = torch.nn.functional.pad(x, (0, m * base - n))
    loc = _cumsum_seq(xp.reshape(x.shape[:-1] + (m, base)))
    inc = _cumsum_xla(loc[..., -1], base)
    exc = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], dim=-1)
    out = (loc + exc[..., None]).reshape(x.shape[:-1] + (m * base,))
    return out[..., :n]


def _col(t, k):
    """Score k of a shared vector (a scalar) or of per-pair rows (B, n)
    (a (B, 1) column that broadcasts over a DP row like the scalar)."""
    return t[k] if t.dim() == 1 else t[:, k:k + 1]


def _lz(b, n, device):
    return torch.full((b, n), LOG_ZERO, dtype=torch.float32, device=device)


def fwd_boundary_row(ins_y, start, tv):
    """Forward row 0 (i = 0) boundary for a batch: src/fwdflat3.cpp:35-93.
    ins_y (B, By) -> 5 rows of (B, By+1)."""
    b, by = ins_y.shape
    tII, tJJ = _col(tv, 3), _col(tv, 5)
    tSI, tSJ = _col(start, 1), _col(start, 3)
    lz = _lz(b, by + 1, ins_y.device)
    ext_i = torch.cat([tSI + ins_y[:, :1], tII + ins_y[:, 1:]], dim=1)
    ext_j = torch.cat([tSJ + ins_y[:, :1], tJJ + ins_y[:, 1:]], dim=1)
    iy0 = torch.cat([lz[:, :1], _cumsum_xla(ext_i)], dim=1)
    jy0 = torch.cat([lz[:, :1], _cumsum_xla(ext_j)], dim=1)
    return (lz, lz, iy0, lz, jy0)


def _scan2(a1, c1, a2, c2):
    """Two affine scans as one (stacked along the batch axis)."""
    b = a1.shape[0]
    u = _row_affine_scan(torch.cat([a1, a2]), torch.cat([c1, c2]))
    return u[:b], u[b:]


def _fwd_step(prev, i, emit_row, insx, ins_y, start, tv):
    """Forward row i (1-based) from row i-1; emit_row (B, By), insx (B, 1)."""
    tMM, tMI, tMJ, tII, tIM, tJJ, tJM = (_col(tv, k) for k in range(7))
    tSM, tSI, tSJ = _col(start, 0), _col(start, 1), _col(start, 3)
    m_p, ix_p, iy_p, jx_p, jy_p = prev
    b = emit_row.shape[0]

    m_new = log_add5(m_p[:, :-1] + tMM, ix_p[:, :-1] + tIM,
                     jx_p[:, :-1] + tJM, iy_p[:, :-1] + tIM,
                     jy_p[:, :-1] + tJM) + emit_row
    if i == 1:
        # start transition: M(1,1) = tSM + emit (src/fwdflat3.cpp:110-111)
        m_new[:, :1] = tSM + emit_row[:, :1]
    ix_new = log_add(ix_p[:, 1:] + tII, m_p[:, 1:] + tMI) + insx
    jx_new = log_add(jx_p[:, 1:] + tJJ, m_p[:, 1:] + tMJ) + insx
    if i == 1:
        ix0 = tSI + insx
        jx0 = tSJ + insx
    else:
        ix0 = ix_p[:, :1] + tII + insx
        jx0 = jx_p[:, :1] + tJJ + insx
    lz1 = _lz(b, 1, emit_row.device)
    m_row = torch.cat([lz1, m_new], dim=1)
    iy_new, jy_new = _scan2(tII + ins_y, m_row[:, :-1] + tMI + ins_y,
                            tJJ + ins_y, m_row[:, :-1] + tMJ + ins_y)
    return (m_row, torch.cat([ix0, ix_new], dim=1),
            torch.cat([lz1, iy_new], dim=1),
            torch.cat([jx0, jx_new], dim=1),
            torch.cat([lz1, jy_new], dim=1))


def bwd_boundary_row(ins_y, start, tv):
    """Backward (reversed-scan) row u = 0 (i = LX) boundary for a batch."""
    b, by = ins_y.shape
    tII, tJJ = _col(tv, 3), _col(tv, 5)
    tSM, tSI, tSJ = _col(start, 0), _col(start, 1), _col(start, 3)
    tMI, tMJ = _col(tv, 1), _col(tv, 2)
    zero = torch.zeros((b, 1), dtype=torch.float32, device=ins_y.device)
    iy0 = tSI + torch.cat([zero, _cumsum_xla(ins_y + tII)], dim=1)
    jy0 = tSJ + torch.cat([zero, _cumsum_xla(ins_y + tJJ)], dim=1)
    m0_tail = log_add(tMI + iy0[:, :-1] + ins_y, tMJ + jy0[:, :-1] + ins_y)
    m0 = torch.cat([zero + tSM, m0_tail], dim=1)
    ix0 = _lz(b, by + 1, ins_y.device)
    ix0[:, :1] = tSI
    jx0 = _lz(b, by + 1, ins_y.device)
    jx0[:, :1] = tSJ
    return (m0, ix0, iy0, jx0, jy0)


def _bwd_step(prev, emit_row, insx, ins_y, tv):
    """Backward (reversed-scan) row u from row u-1."""
    tMM, tMI, tMJ, tII, tIM, tJJ, tJM = (_col(tv, k) for k in range(7))
    m_p, ix_p, iy_p, jx_p, jy_p = prev
    b = emit_row.shape[0]

    next_m = m_p[:, :-1] + emit_row            # at (u-1, v-1)
    next_ix = ix_p[:, 1:] + insx               # at (u-1, v)
    next_jx = jx_p[:, 1:] + insx
    ix_new = log_add(tII + next_ix, tIM + next_m)
    jx_new = log_add(tJJ + next_jx, tJM + next_m)
    ix_c0 = tII + ix_p[:, :1] + insx
    jx_c0 = tJJ + jx_p[:, :1] + insx

    iy_new, jy_new = _scan2(tII + ins_y, tIM + next_m,
                            tJJ + ins_y, tJM + next_m)
    lz1 = _lz(b, 1, emit_row.device)
    iy_row = torch.cat([lz1, iy_new], dim=1)
    jy_row = torch.cat([lz1, jy_new], dim=1)
    next_iy = iy_row[:, :-1] + ins_y
    next_jy = jy_row[:, :-1] + ins_y
    m_new = log_add5(tMM + next_m, tMI + next_ix, tMJ + next_jx,
                     tMI + next_iy, tMJ + next_jy)
    m_c0 = log_add(tMI + ix_p[:, :1] + insx, tMJ + jx_p[:, :1] + insx)
    return (torch.cat([m_c0, m_new], dim=1),
            torch.cat([ix_c0, ix_new], dim=1), iy_row,
            torch.cat([jx_c0, jx_new], dim=1), jy_row)


def _forward_m(e, ins_x, ins_y, lxb, lyb, start, tv):
    """Forward M lattice (B, Bx+1, By+1) and the 5 states at (lx, ly)."""
    b, bx, by = e.shape
    prev = fwd_boundary_row(ins_y, start, tv)
    m_lat = e.new_empty((b, bx + 1, by + 1))
    m_lat[:, 0] = prev[0]
    end = e.new_full((b, 5), LOG_ZERO)
    ar = torch.arange(b, device=e.device)
    for i in range(1, bx + 1):
        prev = _fwd_step(prev, i, e[:, i - 1], ins_x[:, i - 1:i], ins_y,
                         start, tv)
        m_lat[:, i] = prev[0]
        hit = lxb == i
        if bool(hit.any()):
            vals = torch.stack([r[ar, lyb] for r in prev], dim=1)
            end = torch.where(hit[:, None], vals, end)
    return m_lat, end


def _backward_m(e_rev, ins_xr, ins_yr, start, tv):
    """RB_M lattice (B, Bx+1, By+1) and the 5 states at RB(0, 0)."""
    b, bx, by = e_rev.shape
    prev = bwd_boundary_row(ins_yr, start, tv)
    corner = torch.stack([r[:, 0] for r in prev], dim=1)
    m_lat = e_rev.new_empty((b, bx + 1, by + 1))
    m_lat[:, 0] = prev[0]
    for u in range(1, bx + 1):
        prev = _bwd_step(prev, e_rev[:, u - 1], ins_xr[:, u - 1:u], ins_yr,
                         tv)
        m_lat[:, u] = prev[0]
    return m_lat, corner


def _mea_score(post):
    """Max-expected-accuracy DP score over (B, Bx, By) posteriors.

    NewRow[j] = max(Old[j-1] + P[i,j], Old[j], NewRow[j-1]) with zero
    boundaries; valid because post is zero outside (lx, ly).
    reference: src/calcalnscoreflat.cpp:4-32.
    """
    b, bx, by = post.shape
    old = post.new_zeros((b, by + 1))
    for i in range(bx):
        cand = torch.maximum(old[:, :-1] + post[:, i], old[:, 1:])
        old = torch.cat([old[:, :1] * 0, torch.cummax(cand, dim=1).values],
                        dim=1)
    return old[:, by]


def reverse_padded(arr, lens):
    """Per-row reverse of right-padded data: out[k] = arr[len-1-k]
    (positions past len wrap as jnp.roll(jnp.flip(a), len - n) does)."""
    n = arr.shape[1]
    k = torch.arange(n, device=arr.device)
    idx = torch.remainder(lens[:, None].long() - 1 - k[None, :], n)
    return torch.gather(arr, 1, idx)


def batch_posteriors_emissions(e, e_rev, ins_x, ins_y, ins_xr, ins_yr,
                               lxb, lyb, start, tv, with_mea: bool = True):
    """Posteriors (+ EA) from precomputed emission lattices — shared by
    the letter pair-HMM and the Muscle-3D feature-profile HMM.

    e (B, Bx, By) emissions, e_rev (B, Bx, By) those of the per-pair
    reversed sequences (reverse_padded), ins_* (B, Bx or By) the insert
    scores of x, y and their reversals, lxb / lyb (B,) true lengths;
    start (5,) / tv (7,) shared by every pair, or start (B, 5) / tv
    (B, 7), one a pair: the recurrence reads each score as a (B, 1)
    column where the shared form reads a scalar, so every lane gets the
    bits of the shared form run on its own pack. Returns (post (B, Bx, By) f32, zero outside the valid region; ea (B,)
    f32, zeros if with_mea=False).
    """
    lxb = lxb.long()
    lyb = lyb.long()
    b, bx, by = e.shape
    dev = e.device
    fm, f_end = _forward_m(e, ins_x, ins_y, lxb, lyb, start, tv)
    rbm, corner = _backward_m(e_rev, ins_xr, ins_yr, start, tv)

    # total prob: LOG_ADD fold over states of F[s](lx,ly) + B[s](lx,ly)
    # where B(lx,ly) = RB(0,0) (src/totalprobflat.cpp:3-16)
    total = torch.full((b,), LOG_ZERO, dtype=torch.float32, device=dev)
    for s in range(5):
        total = log_add(total, f_end[:, s] + corner[:, s])

    # B_M(i,j) = RB_M(lx-i, ly-j): the flip + per-pair roll as a gather
    ii = torch.arange(bx, device=dev)
    jj = torch.arange(by, device=dev)
    ui = torch.remainder(lxb[:, None] - 1 - ii[None, :], bx)     # (B, Bx)
    vj = torch.remainder(lyb[:, None] - 1 - jj[None, :], by)     # (B, By)
    rb = rbm[:, :bx, :by]
    b_m = rb[torch.arange(b, device=dev)[:, None, None],
             ui[:, :, None], vj[:, None, :]]
    score = fm[:, 1:, 1:] + b_m - total[:, None, None]
    valid = (ii[None, :, None] < lxb[:, None, None]) & \
            (jj[None, None, :] < lyb[:, None, None])
    # the exp's argument is clamped to [MIN_SPARSE_SCORE - 1, 0]: only
    # scores >= MIN_SPARSE_SCORE are kept
    post = torch.where((score >= MIN_SPARSE_SCORE) & valid,
                       exp_f32(torch.clamp(score, MIN_SPARSE_SCORE - 1.0,
                                           0.0)),
                       torch.zeros((), dtype=torch.float32, device=dev))
    if with_mea:
        ea = _mea_score(post) / torch.minimum(lxb, lyb).float()
    else:
        ea = torch.zeros(b, dtype=torch.float32, device=dev)
    return post, ea


def batch_posteriors(xb, yb, lxb, lyb, match, insert, start, tv,
                     with_mea: bool = True):
    """Posteriors (+ MEA/EA scores) for a batch of sequence pairs.

    Args:
      xb: (B, Bx) int codes, right-padded.  yb: (B, By).
      lxb, lyb: (B,) true lengths.
      match, insert, start, tv: score tables (see `score_args`).

    Returns:
      post: (B, Bx, By) f32 posterior matrices (zero outside valid region)
      ea:   (B,) f32 expected accuracy = MEA score / min(lx, ly)
            (reference: src/calcposteriorflat.cpp:89-91) — zeros if
            with_mea=False.
    """
    xb = xb.long()
    yb = yb.long()
    lxb = lxb.long()
    lyb = lyb.long()
    xr = reverse_padded(xb, lxb)
    yr = reverse_padded(yb, lyb)
    e = match[xb[:, :, None], yb[:, None, :]]
    e_rev = match[xr[:, :, None], yr[:, None, :]]
    return batch_posteriors_emissions(
        e, e_rev, insert[xb], insert[yb], insert[xr], insert[yr], lxb, lyb,
        start, tv, with_mea=with_mea)


# ---------------------------------------------------------------------------
# per-pair score tables (ensemble replicate batching)
# ---------------------------------------------------------------------------

# the JAX package's name for the per-pair form: batch_posteriors_emissions
# reads start_b (B, 5) / tv_b (B, 7) as it reads one (5,) / (7,) pack
batch_posteriors_emissions_multi = batch_posteriors_emissions


def batch_posteriors_multi(xb, yb, lxb, lyb, match_b, insert_b, start_b,
                           tv_b, with_mea: bool = True):
    """batch_posteriors with per-pair score tables: match_b (B, K+1, K+1),
    insert_b (B, K+1), start_b (B, 5), tv_b (B, 7)."""
    xb = xb.long()
    yb = yb.long()
    lxb = lxb.long()
    lyb = lyb.long()
    xr = reverse_padded(xb, lxb)
    yr = reverse_padded(yb, lyb)
    ar = torch.arange(xb.shape[0], device=xb.device)[:, None, None]
    e = match_b[ar, xb[:, :, None], yb[:, None, :]]
    e_rev = match_b[ar, xr[:, :, None], yr[:, None, :]]

    def ins(c):
        return torch.gather(insert_b, 1, c)
    return batch_posteriors_emissions(
        e, e_rev, ins(xb), ins(yb), ins(xr), ins(yr), lxb, lyb, start_b,
        tv_b, with_mea=with_mea)


def score_args_multi(packs, rep_idx, device="cpu"):
    """Stacked per-pair score tables for batch_posteriors_multi:
    packs[rep_idx[i]] supplies pair i's tables. Returns (match_b
    (B, K+1, K+1), insert_b (B, K+1), start_b (B, 5), tv_b (B, 7))
    float32 tensors on `device`."""
    ri = torch.as_tensor(np.asarray(rep_idx, dtype=np.int64), device=device)
    match = torch.as_tensor(np.stack([p.match for p in packs]),
                            dtype=torch.float32, device=device)
    insert = torch.as_tensor(np.stack([p.insert for p in packs]),
                             dtype=torch.float32, device=device)
    start = torch.as_tensor(np.stack([p.start for p in packs]),
                            dtype=torch.float32, device=device)
    tv = torch.stack([_trans_vec(p, device) for p in packs])
    return match[ri], insert[ri], start[ri], tv[ri]
