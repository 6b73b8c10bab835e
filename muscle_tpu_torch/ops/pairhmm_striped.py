"""Y-striped pair-HMM posteriors for long pairs: kernels 5 and 6.

Port of muscle_tpu.ops.pairhmm_striped, the path the JAX package's long-
pair router takes for pairs whose both sides exceed the lane cap of
kernels A and B (pipeline/posteriors.py::_long_pairs_sparse). The JAX
package launches its two kernels once per stripe of W lanes; the port
runs every stripe of a pass in one launch:

* kernel 5, `pairhmm_fwd_striped` (csrc/pairhmm_fwd_stripe.cu), replaces
  `_fwd_stripe_kernel`: the forward recurrence of kernel A on each
  stripe, where a stripe reads the previous stripe's last column at
  every DP row (the M shift-in, and the IY/JY carries injected into lane
  0 of the within-row scan as u_0 = LOG_ADD(carry + a_0, c_0)); it
  returns the (B, Lx, By) M lattice and the final states at (lx, ly);
* kernel 6, `pairhmm_bwd_striped` (csrc/pairhmm_bwd_stripe.cu), replaces
  `_bwd_stripe_kernel`: the backward recurrence, posterior and MEA row of
  kernel B on each reversed stripe, with the same carries plus the MEA
  row's max-plus carry, the posterior written over the M lattice in
  place (JAX's arrays are immutable; the port saves the second lattice,
  ~20 GB at the router's striped cell budget).

Each launch runs the stripes as a skewed wavefront of groups of G
64-lane segments (`_geometry`), handing each DP row's edge values from
group to group through device memory (csrc/stripe_wavefront.cuh); the
arithmetic and its association are those of the per-stripe kernels.
`striped_posteriors_sparse` orchestrates as JAX does: the global row-0
closed forms (XLA-grouped prefix sums, `_cumsum_xla`), pass A, the
total probability, pass B, each stripe's top-K right to left and the
exact top-K merge. JAX recomputes each forward stripe in pass B to keep
one M stripe alive in TPU memory; the recompute gives the same bits, so
pass A keeps the whole M lattice instead: 1.6 GB for one 19k x 19k
pair, at most ~22 GB for 8 pairs at the router's striped cell budget.

Beside the kernels are their plain twins: `fwd_stripe_plain` and
`bwd_stripe_plain`, a torch transcription of the Pallas kernels on one
stripe over (B, W) rows with a Python loop over DP rows, in the kernels'
association (that of ops/pairhmm_cuda.py), with the boundary column of a
stripe as (B, Lx, 8) f32 rows [M, IX, IY, JX, JY, MEA, 0, 0] (the
forward's row i is DP row i + 1, the backward's row u its step u); and
`fwd_striped_plain`, `bwd_striped_plain`, which chain them over the
stripes as the JAX package's launches do. A wrapper given CPU tensors
runs the whole-pass twin; given CUDA tensors it launches the kernel or
raises. `LAUNCHES` counts the kernel launches, one a pass.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import wavefront
from .logspace import LOG_ZERO
from .pairhmm import MIN_SPARSE_SCORE, _cumsum_xla
from .pairhmm_cuda import (NEG_BIG, P_TII, P_TJJ, P_TSI, P_TSJ, _log_add,
                           _log_add5, _on_card, _ptr, _raise_on, _scan2,
                           _shift_fill, _total_prob, _unpack, load_libs,
                           tables)

BND = 8   # boundary slots per row
B_M, B_IX, B_IY, B_JX, B_JY, B_MEA = range(6)

MAX_W = 2048    # one 64-lane segment per warp, at most 32 warps

LAUNCHES = {"pairhmm_fwd_stripe": 0, "pairhmm_bwd_stripe": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _col(x, slot):
    return x[:, slot:slot + 1]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def fwd_stripe_plain(xb, yb, lxb, lyb, match, insert, params, iy0, jy0,
                     bnd_in, s: int, w: int):
    """Twin of kernel 5 on stripe s (lanes s*w .. s*w+w-1 of yb).

    iy0, jy0: (B, By) DP row 0 of IY/JY over the whole padded row;
    bnd_in: (B, Lx, 8) boundary of stripe s-1 (None for s = 0).
    Returns (bnd_out (B, Lx, 8), fend (B, 5) final states [M, IX, IY,
    JX, JY] at (lx, ly) where this stripe holds column ly, else NEG_BIG,
    fm (B, Lx, w) M rows). Rows >= lx are zero.
    reference: src/fwdflat3.cpp:12-153.
    """
    (tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM) = _unpack(params)
    xb = xb.long()
    yb = yb.long()
    b, n_rows = xb.shape
    dev = xb.device
    j0 = s * w
    first = s == 0
    lane = torch.arange(w, device=dev)[None, :]
    ys = yb[:, j0:j0 + w]
    insy = insert[ys]
    lz = torch.full((b, w), LOG_ZERO, dtype=torch.float32, device=dev)
    m, ix, jx = lz, lz, lz
    iy = iy0[:, j0:j0 + w]
    jy = jy0[:, j0:j0 + w]
    lz1 = lz[:, :1]
    ix0, jx0 = lz1, lz1
    bnd = torch.zeros((b, n_rows, BND), dtype=torch.float32, device=dev)
    fm = torch.zeros((b, n_rows, w), dtype=torch.float32, device=dev)
    fend = torch.full((b, 5), NEG_BIG, dtype=torch.float32, device=dev)
    col = lyb.long() - 1 - j0
    holds = (col >= 0) & (col < w)
    col = col.clamp(0, w - 1)
    ar = torch.arange(b, device=dev)
    for i in range(int(lxb.max())):      # rows past every lx stay zero
        e_row = match[xb[:, i:i + 1], ys]
        insx = insert[xb[:, i]][:, None]
        comb = _log_add5(m + tMM, ix + tIM, jx + tJM, iy + tIM, jy + tJM)
        if first:
            fill = _log_add(ix0 + tIM, jx0 + tJM)
        else:
            # the previous stripe's last column at DP row i
            if i == 0:
                pm = pix = pjx = lz1
                piy = iy0[:, j0 - 1:j0]
                pjy = jy0[:, j0 - 1:j0]
            else:
                prev = bnd_in[:, i - 1]
                pm, pix, piy, pjx, pjy = (_col(prev, k) for k in range(5))
            fill = _log_add5(pm + tMM, pix + tIM, pjx + tJM, piy + tIM,
                             pjy + tJM)
        m_new = _shift_fill(comb, fill) + e_row
        if first and i == 0:
            m_new = torch.where(lane == 0, tSM + e_row, m_new)
        ix_new = _log_add(ix + tII, m + tMI) + insx
        jx_new = _log_add(jx + tJJ, m + tMJ) + insx
        if first:
            if i == 0:
                ix0, jx0 = tSI + insx, tSJ + insx
            else:
                ix0, jx0 = ix0 + tII + insx, jx0 + tJJ + insx
        a_i = insy + tII
        a_j = insy + tJJ
        if first:
            m_sh = _shift_fill(m_new, LOG_ZERO)
        else:
            carr = bnd_in[:, i]     # previous stripe, DP row i + 1
            m_sh = _shift_fill(m_new, _col(carr, B_M))
        c_i = m_sh + tMI + insy
        c_j = m_sh + tMJ + insy
        if not first:
            c_i[:, :1] = _log_add(_col(carr, B_IY) + a_i[:, :1], c_i[:, :1])
            c_j[:, :1] = _log_add(_col(carr, B_JY) + a_j[:, :1], c_j[:, :1])
        iy, jy = _scan2(a_i, c_i, a_j, c_j)
        m, ix, jx = m_new, ix_new, jx_new
        rows = (m, ix, iy, jx, jy)
        bnd[:, i, :5] = torch.cat([r[:, -1:] for r in rows], dim=1)
        fm[:, i] = m
        last = holds & (lxb == i + 1)
        if bool(last.any()):
            vals = torch.stack([r[ar, col] for r in rows], dim=1)
            fend = torch.where(last[:, None], vals, fend)
    past = torch.arange(n_rows, device=dev)[None, :] >= lxb[:, None]
    bnd[past] = 0.0
    fm[past] = 0.0
    return bnd, fend, fm


def bwd_stripe_plain(xb, yb, lxb, lyb, match, insert, params, tot, iy0b,
                     jy0b, bnd_in, fm, sp: int, w: int):
    """Twin of kernel 6 on reversed stripe sp (flipped lanes sp*w ..
    sp*w+w-1, forward stripe S-1-sp).

    iy0b, jy0b: (B, By) the backward boundary row B(lx, .) of IY/JY in
    flipped lanes; bnd_in: (B, Lx, 8) boundary of reversed stripe sp-1
    (None for sp = 0); fm: (B, Lx, w) forward M rows of stripe S-1-sp.
    Returns (post (B, Lx, w) in forward lanes, bnd_out (B, Lx, 8), mea
    (B,) the MEA row's last lane). Flipped lanes below By-ly carry the
    column boundary chains, steps u <= Lx-lx keep the boundary state.
    reference: src/bwdflat3.cpp:10-190, src/calcposteriorflat.cpp:4-27,
    src/calcalnscoreflat.cpp:4-32.
    """
    (tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM) = _unpack(params)
    xb = xb.long()
    yb = yb.long()
    b, n_rows = xb.shape
    by = yb.shape[1]
    dev = xb.device
    g0 = sp * w
    first = sp == 0
    lxv = lxb.float()[:, None]
    u0 = float(n_rows) - lxv
    glane = (g0 + torch.arange(w, device=dev))[None, :].float()
    padmask = glane < (float(by) - lyb.float()[:, None])
    yfl = yb.flip(1)[:, g0:g0 + w]
    insy = torch.where(padmask, LOG_ZERO, insert[yfl])
    tot = tot[:, None]

    iy = iy0b[:, g0:g0 + w]
    jy = jy0b[:, g0:g0 + w]
    f_iy = tSI if first else iy0b[:, g0 - 1:g0]
    f_jy = tSJ if first else jy0b[:, g0 - 1:g0]
    m = _log_add(tMI + _shift_fill(iy, f_iy) + insy,
                 tMJ + _shift_fill(jy, f_jy) + insy)
    m = torch.where(padmask, tSM, m)
    lz = torch.full((b, w), LOG_ZERO, dtype=torch.float32, device=dev)
    ix = torch.where(padmask, tSI, lz)
    jx = torch.where(padmask, tSJ, lz)
    c = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    ix0, jx0, m0 = c + tSI, c + tSJ, c + tSM
    mea = torch.zeros((b, w), dtype=torch.float32, device=dev)
    post = torch.zeros((b, n_rows, w), dtype=torch.float32, device=dev)
    bnd = torch.zeros((b, n_rows, BND), dtype=torch.float32, device=dev)
    # steps before the longest pair's first row keep every pair's
    # boundary state, with zero posterior and MEA
    u_first = n_rows - int(lxb.max())
    bnd[:, :u_first, :5] = torch.cat([r[:, -1:] for r in (m, ix, iy, jx,
                                                           jy)], dim=1)[:, None]

    for u in range(u_first, n_rows):
        if not first:
            carr = bnd_in[:, u]     # previous stripe, same step
        if u > 0:
            xi = n_rows - u
            e_row = torch.where(padmask, LOG_ZERO,
                                match[xb[:, xi:xi + 1], yfl])
            insx = insert[xb[:, xi]][:, None]
            f_m = m0 if first else _col(bnd_in[:, u - 1], B_M)
            next_m = _shift_fill(m, f_m) + e_row
            next_ix = ix + insx
            next_jx = jx + insx
            ix_new = _log_add(tII + next_ix, tIM + next_m)
            jx_new = _log_add(tJJ + next_jx, tJM + next_m)
            if first:
                ix0_new = tII + ix0 + insx
                jx0_new = tJJ + jx0 + insx
                m0_new = _log_add(tMI + ix0 + insx, tMJ + jx0 + insx)
            a_i = insy + tII
            a_j = insy + tJJ
            c_i = tIM + next_m
            c_j = tJM + next_m
            if not first:
                c_i[:, :1] = _log_add(_col(carr, B_IY) + a_i[:, :1],
                                      c_i[:, :1])
                c_j[:, :1] = _log_add(_col(carr, B_JY) + a_j[:, :1],
                                      c_j[:, :1])
            iy_new, jy_new = _scan2(a_i, c_i, a_j, c_j)
            fy = LOG_ZERO if first else _col(carr, B_IY)
            fj = LOG_ZERO if first else _col(carr, B_JY)
            next_iy = _shift_fill(iy_new, fy) + insy
            next_jy = _shift_fill(jy_new, fj) + insy
            m_new = _log_add5(tMM + next_m, tMI + next_ix, tMJ + next_jx,
                              tMI + next_iy, tMJ + next_jy)
            pin = float(u) <= u0
            m = torch.where(pin, m, m_new)
            ix = torch.where(pin, ix, ix_new)
            iy = torch.where(pin, iy, iy_new)
            jx = torch.where(pin, jx, jx_new)
            jy = torch.where(pin, jy, jy_new)
            if first:
                ix0 = torch.where(pin, ix0, ix0_new)
                jx0 = torch.where(pin, jx0, jx0_new)
                m0 = torch.where(pin, m0, m0_new)
        # combine with forward row n_rows-1-u, threshold at 0.01
        pf = n_rows - 1 - u
        b_fill = m0 if first else _col(carr, B_M)
        score = fm[:, pf].flip(1) + _shift_fill(m, b_fill) - tot
        valid = (float(pf) < lxv) & ~padmask
        post_nat = torch.where((score >= MIN_SPARSE_SCORE) & valid,
                               torch.exp(torch.clamp(score, max=0.0)), 0.0)
        post[:, pf] = post_nat.flip(1)
        # MEA running row, carried across the stripe edge
        f_old = 0.0 if first or u == 0 else _col(bnd_in[:, u - 1], B_MEA)
        e = torch.maximum(_shift_fill(mea, f_old) + post_nat, mea)
        mea = torch.cummax(torch.clamp(e, min=0.0), dim=1).values
        if not first:
            mea = torch.maximum(mea, _col(carr, B_MEA))
        bnd[:, u, :6] = torch.cat([r[:, -1:] for r in (m, ix, iy, jx, jy,
                                                       mea)], dim=1)
    return post, bnd, mea[:, -1]


# ---------------------------------------------------------------------------
# whole-pass twins: the per-stripe twins chained as the kernels' one
# launch chains the stripes
# ---------------------------------------------------------------------------

def fwd_striped_plain(xb, yb, lxb, lyb, match, insert, params, iy0, jy0,
                      w: int):
    """Twin of kernel 5: `fwd_stripe_plain` on stripes 0 .. S-1, each on
    the boundary of the one before. Returns (fm (B, Lx, By), fend (B, 5),
    the stripes' final states merged by max)."""
    bnd, fms, fend = None, [], None
    for s in range(yb.shape[1] // w):
        bnd, fe, fm = fwd_stripe_plain(xb, yb, lxb, lyb, match, insert,
                                       params, iy0, jy0, bnd, s, w)
        fms.append(fm)
        fend = fe if fend is None else torch.maximum(fend, fe)
    return torch.cat(fms, dim=2), fend


def bwd_striped_plain(xb, yb, lxb, lyb, match, insert, params, tot, iy0b,
                      jy0b, fm, w: int):
    """Twin of kernel 6: `bwd_stripe_plain` on reversed stripes 0 ..
    S-1 (forward stripe S-1-sp's M rows), each on the boundary of the
    one before; each stripe's posterior is written over its M rows in
    fm, as the kernel does. Returns (post (B, Lx, By), which is fm, mea
    (B,))."""
    n_s = yb.shape[1] // w
    bnd, mea = None, None
    for sp in range(n_s):
        cols = slice((n_s - 1 - sp) * w, (n_s - sp) * w)
        post, bnd, mea = bwd_stripe_plain(xb, yb, lxb, lyb, match, insert,
                                          params, tot, iy0b, jy0b, bnd,
                                          fm[:, :, cols], sp, w)
        fm[:, :, cols] = post
    return fm, mea


# ---------------------------------------------------------------------------
# kernel build + launch
# ---------------------------------------------------------------------------

_KERNELS = ("pairhmm_fwd_stripe", "pairhmm_bwd_stripe")
_libs: dict = {}

# 64-lane segments a group at most: G = 4 ran one pass at the long
# pair's shape fastest at B = 1 and B = 8 copies, against G = 1, 2, 8,
# 16, 32 (same probe): fewer warps a group lengthen the wavefront's skew
# (a group starts ~R rows after its left neighbour), more lengthen each
# row (the carry chain, barriers over more warps)
GROUP_SEGMENTS = 4
# the top-K's device bytes beside the lattice (striped_need_bytes): a
# stripe's slice copied contiguous (4 B a cell), its sort's values and
# int64 indices (12) with as much again of the sort's own buffers (12),
# its nonzero mask (1); a kept slot: value and column (8), their
# concatenation (8) and the merge's sort (12), its gathered columns and
# the outputs (8). Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
# phase_capacity), the route's peak beside its store: 5.83 / 5.43 / 5.13
# B a lattice cell at 19456 x 20480, 2 x 26112 x 26624 and 34816 x
# 34816, where this model gives 7.46 / 6.79 / 6.27
STRIPE_SORT_BYTES = 29
TOPK_SLOT_BYTES = 36
# the hand-over's record of each kernel (ops/wavefront.py REC_FLOATS)
_KIND = {"pairhmm_fwd_stripe": "fwd", "pairhmm_bwd_stripe": "bwd"}


class Geometry(NamedTuple):
    """One pass of kernel 5 or 6: groups of `g` 64-lane segments (one
    warp each), `groups` a pair."""
    g: int
    groups: int

    def hand_bytes(self, b: int, lx: int, kernel: str) -> int:
        """Bytes of the hand-over records of one launch: one record a
        DP row for each group."""
        return wavefront.hand_bytes(b, self.groups, lx, _KIND[kernel])


def _geometry(b: int, by: int, w: int, g: int | None = None) -> Geometry:
    """Segments a group: `g` if given (a divisor of 32 and of the
    stripe's w / 64 segments, so that a group never straddles a stripe
    edge), else the largest power of two up to GROUP_SEGMENTS that
    divides the stripe's segments, whatever B and By."""
    nseg_w = w // 64
    if g is None:
        g = GROUP_SEGMENTS
        while nseg_w % g:
            g //= 2
    if g < 1 or 32 % g or nseg_w % g:
        raise ValueError(f"{g} segments a group: want a divisor of 32 and "
                         f"of the stripe's {nseg_w} segments")
    return Geometry(g, by // (64 * g))


def striped_need_bytes(b: int, px: int, py: int, w: int, k: int) -> int:
    """Device bytes of striped_posteriors_sparse on b pairs padded to
    (px, py) in stripes of w lanes: the (B, Lx, By) M lattice (4 B a
    cell; the posterior is written over it) and, beside it, the larger
    of the backward pass's hand-over records and the top-K's
    temporaries: one stripe's sort (STRIPE_SORT_BYTES a cell of the
    stripe) and every stripe's K slots with their merge
    (TOPK_SLOT_BYTES a slot)."""
    lattice = 4 * b * px * py
    hand = _geometry(b, py, w).hand_bytes(b, px, "pairhmm_bwd_stripe")
    topk = b * px * (STRIPE_SORT_BYTES * w + TOPK_SLOT_BYTES * (py // w) * k)
    return lattice + max(hand, topk)


def kernel_specs():
    from ..utils.build import cuda_spec, package_path
    deps = tuple(package_path("csrc", h) for h in (
        "pairhmm_common.cuh", "stripe_wavefront.cuh", "pairhmm_wave.cuh"))
    return [cuda_spec(k, deps=deps) for k in _KERNELS]


def _lib(name: str):
    if name not in _libs:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        load_libs(kernel_specs(),
                  {"pairhmm_fwd_stripe": [vp] * 9 + [ci] * 7 + [ll]
                   + [vp] * 6,
                   "pairhmm_bwd_stripe": [vp] * 10 + [ci] * 7 + [ll]
                   + [vp] * 6},
                  _libs)
    return _libs[name]


def _check(xb, yb, lxb, lyb, match, insert, params, floats, w):
    """Shapes, types and devices of a pass; returns (B, Lx, By, K+1)."""
    dev = xb.device
    for name, t in (("xb", xb), ("yb", yb), ("lxb", lxb), ("lyb", lyb)):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {dev}")
    for name, t in (("match", match), ("insert", insert),
                    ("params", params)) + tuple(floats.items()):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32 on {dev}")
    b, lx = xb.shape
    by = yb.shape[1]
    if yb.shape[0] != b or lxb.shape != (b,) or lyb.shape != (b,) or lx < 1:
        raise ValueError("batch shapes disagree")
    if w % 64 or not 0 < w <= MAX_W or by % w:
        raise ValueError(f"stripes of width {w} over By={by}: want a "
                         f"64-multiple width <= {MAX_W} dividing By")
    kk = insert.shape[0]
    if match.shape != (kk, kk) or params.shape != (16,):
        raise ValueError("score table shapes")
    return b, lx, by, kk


def _launch(name, geo, ins, dims, outs):
    """Launch kernel `name` on input tensors `ins`, (B, Lx, By, W, K+1)
    `dims` and output tensors `outs`, with a zeroed ticket, progress
    counters and hand-over records of its own."""
    b, lx, by, w, kk = dims
    dev = ins[0].device
    sync, hand = wavefront.buffers(b, geo.groups, lx, _KIND[name], dev)
    lib = _lib(name)
    rc = getattr(lib, name)(
        *(_ptr(t) for t in ins), b, lx, by, w, geo.g, kk,
        wavefront.ROWS_PER_PUBLISH, wavefront.WAIT_LIMIT_NS, _ptr(sync),
        _ptr(wavefront.fault_flag(dev)), _ptr(hand),
        *(_ptr(t) for t in outs),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1


def pairhmm_fwd_striped(xb, yb, lxb, lyb, match, insert, params, iy0, jy0,
                        w: int, g: int | None = None):
    """Kernel 5: the forward pass over every stripe of width w, one
    launch (`g` segments a group, `_geometry`'s choice if None). CPU
    tensors run `fwd_striped_plain`. Returns (fm (B, Lx, By), fend (B,
    5))."""
    b, lx, by, kk = _check(xb, yb, lxb, lyb, match, insert, params,
                           {"iy0": iy0, "jy0": jy0}, w)
    if iy0.shape != (b, by) or jy0.shape != (b, by):
        raise ValueError("iy0/jy0: (B, By)")
    geo = _geometry(b, by, w, g)
    if not _on_card(xb):
        return fwd_striped_plain(xb, yb, lxb, lyb, match, insert, params,
                                 iy0, jy0, w)
    fend = torch.full((b, 5), NEG_BIG, dtype=torch.float32, device=xb.device)
    fm = torch.zeros((b, lx, by), dtype=torch.float32, device=xb.device)
    _launch("pairhmm_fwd_stripe", geo,
            (xb, yb, lxb, lyb, match, insert, params, iy0, jy0),
            (b, lx, by, w, kk), (fend, fm))
    return fm, fend


def pairhmm_bwd_striped(xb, yb, lxb, lyb, match, insert, params, tot, iy0b,
                        jy0b, fm, w: int, g: int | None = None):
    """Kernel 6: the backward pass, posterior and MEA row over every
    reversed stripe of width w, one launch. The posterior is written
    over fm in place and returned as `post` (the same tensor). CPU
    tensors run `bwd_striped_plain`. Returns (post (B, Lx, By), mea
    (B,))."""
    b, lx, by, kk = _check(xb, yb, lxb, lyb, match, insert, params,
                           {"tot": tot, "iy0b": iy0b, "jy0b": jy0b,
                            "fm": fm}, w)
    if (tot.shape != (b,) or iy0b.shape != (b, by) or jy0b.shape != (b, by)
            or fm.shape != (b, lx, by)):
        raise ValueError("tot (B,), iy0b/jy0b (B, By), fm (B, Lx, By)")
    geo = _geometry(b, by, w, g)
    if not _on_card(xb):
        return bwd_striped_plain(xb, yb, lxb, lyb, match, insert, params,
                                 tot, iy0b, jy0b, fm, w)
    mea = torch.empty((b,), dtype=torch.float32, device=xb.device)
    _launch("pairhmm_bwd_stripe", geo,
            (xb, yb, lxb, lyb, match, insert, params, tot, iy0b, jy0b),
            (b, lx, by, w, kk), (fm, mea))
    return fm, mea


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _top_k(x, k: int):
    """lax.top_k along the last axis: descending, ties to the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def row0_closed_forms(yb, lyb, insert, params):
    """DP row 0 of IY/JY for the forward (B, By) and the backward boundary
    row B(lx, .) in flipped lanes, over the whole padded row, with XLA's
    prefix-sum grouping (muscle_tpu/ops/pairhmm_striped.py:597-599,
    :652-659)."""
    tSI, tSJ = params[P_TSI], params[P_TSJ]
    tII, tJJ = params[P_TII], params[P_TJJ]
    yb = yb.long()
    by = yb.shape[1]
    insy = insert[yb]
    iy0 = tSI - tII + _cumsum_xla(insy + tII)
    jy0 = tSJ - tJJ + _cumsum_xla(insy + tJJ)
    insyf = insert[yb.flip(1)]
    pm = (torch.arange(by, device=yb.device)[None, :].float()
          < float(by) - lyb.float()[:, None])
    cum_i = _cumsum_xla(torch.where(pm, 0.0, insyf + tII))
    cum_j = _cumsum_xla(torch.where(pm, 0.0, insyf + tJJ))
    iy0b = torch.where(pm, tSI, tSI + cum_i)
    jy0b = torch.where(pm, tSJ, tSJ + cum_j)
    return (iy0.contiguous(), jy0.contiguous(), iy0b.contiguous(),
            jy0b.contiguous())


def striped_posteriors_sparse(xb, yb, lxb, lyb, pack, k: int = 32,
                              stripe_w: int = 2048, g: int | None = None):
    """Sparse posteriors + EA for long pairs via the Y-striped kernels.

    xb/yb: (B, Bx)/(B, By) wildcard-padded codes, By a multiple of
    stripe_w; `g` segments a group (the kernels' geometry if None).
    Returns (vals (B, Bx, K), cols (B, Bx, K), ea (B,), max_nnz int) —
    the contract of sparsify(batch_posteriors(...)) with EA.
    """
    dev = xb.device
    match, insert, params = tables(pack, dev)
    xb = xb.to(torch.int32).contiguous()
    yb = yb.to(torch.int32).contiguous()
    lxb = lxb.to(torch.int32).contiguous()
    lyb = lyb.to(torch.int32).contiguous()
    by = yb.shape[1]
    if by % stripe_w:
        raise ValueError(f"By={by} is not a multiple of {stripe_w}")
    n_s = by // stripe_w
    iy0, jy0, iy0b, jy0b = row0_closed_forms(yb, lyb, insert, params)
    args = (xb, yb, lxb, lyb, match, insert, params)

    # pass A: the M lattice and the final states, every stripe
    fm, fend = pairhmm_fwd_striped(*args, iy0, jy0, stripe_w, g)
    tot = _total_prob(fend, params).contiguous()
    # pass B: backward, posterior and MEA row of every reversed stripe,
    # the posterior written over fm
    post, mea = pairhmm_bwd_striped(*args, tot, iy0b, jy0b, fm, stripe_w, g)
    del fm

    # each stripe's top-K, right to left, then the exact merge: the global
    # top-K is the top-K of the stripes' top-Ks. Only a stripe's K slots
    # are kept (not views of its sorted row), and its nonzero count, so
    # that the temporaries beside the lattice are one stripe's
    # (striped_need_bytes)
    vals_parts, cols_parts = [], []
    nnz = 0
    for sp in range(n_s):
        sigma = n_s - 1 - sp
        part = post[..., sigma * stripe_w:(sigma + 1) * stripe_w]
        v, c = _top_k(part, k)
        v = v.contiguous()
        vals_parts.append(v)
        cols_parts.append(torch.where(v > 0, c.to(torch.int32)
                                      + sigma * stripe_w, -1))
        nnz = nnz + (part > 0).sum(dim=-1)
        del part, c
    del post
    v, idx = _top_k(torch.cat(vals_parts, dim=-1), k)
    c = torch.gather(torch.cat(cols_parts, dim=-1), -1, idx)
    valid = v > 0.0
    vals = torch.where(valid, v, 0.0)
    cols = torch.where(valid, c, -1).to(torch.int32)
    ea = mea / torch.minimum(lxb, lyb).float()
    if _on_card(xb):
        wavefront.check_waits(dev)
    return vals, cols, ea, int(nnz.max())
