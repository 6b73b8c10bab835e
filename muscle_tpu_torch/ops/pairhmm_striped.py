"""Y-striped pair-HMM posteriors for long pairs: kernels 5 and 6.

Port of muscle_tpu.ops.pairhmm_striped, the path the JAX package's long-
pair router takes for pairs whose both sides exceed the lane cap of
kernels A and B (pipeline/posteriors.py::_long_pairs_sparse):

* kernel 5, `pairhmm_fwd_stripe` (csrc/pairhmm_fwd_stripe.cu), replaces
  `_fwd_stripe_kernel`: the forward recurrence of kernel A on one stripe
  of W lanes. It reads the previous stripe's last column at every DP row
  (the M shift-in, and the IY/JY carries injected into lane 0 of the
  within-row scan as u_0 = LOG_ADD(carry + a_0, c_0)) and writes its own,
  with the final states where the stripe holds column ly and the
  stripe's M rows;
* kernel 6, `pairhmm_bwd_stripe` (csrc/pairhmm_bwd_stripe.cu), replaces
  `_bwd_stripe_kernel`: the backward recurrence, posterior and MEA row of
  kernel B on one reversed stripe, with the same carries plus the MEA
  row's max-plus carry.

Boundary columns are kept as (B, Lx, 8) f32 rows [M, IX, IY, JX, JY, MEA,
0, 0]: the forward's row i is DP row i + 1, the backward's row u its step
u. Stripes run in order, one launch each. `striped_posteriors_sparse`
orchestrates as JAX does: the global row-0 closed forms (XLA-grouped
prefix sums, `_cumsum_xla`), pass A (M rows, boundaries and final states
of every stripe), the total probability, pass B right to left (backward
stripe S-1-sigma on forward stripe sigma's M rows, the stripe's top-K),
and the exact top-K merge. JAX recomputes each forward stripe in pass B
to keep one M stripe alive in TPU memory; the recompute gives the same
bits, so pass A keeps the whole (B, Lx, By) M lattice instead: 1.6 GB
for one 19k x 19k pair, at most ~22 GB for 8 pairs at the router's
striped cell budget.

Beside each kernel is its plain twin (`fwd_stripe_plain`,
`bwd_stripe_plain`), a torch transcription of the Pallas kernel over
(B, W) rows with a Python loop over DP rows, in the kernels' association
(that of ops/pairhmm_cuda.py). A wrapper given CPU tensors runs the twin;
given CUDA tensors it launches the kernel or raises. `LAUNCHES` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .logspace import LOG_ZERO
from .pairhmm import MIN_SPARSE_SCORE, _cumsum_xla
from .pairhmm_cuda import (NEG_BIG, P_TII, P_TJJ, P_TSI, P_TSJ, _log_add,
                           _log_add5, _ptr, _raise_on, _scan2, _shift_fill,
                           _total_prob, _unpack, load_libs, tables)

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
# kernel build + launch
# ---------------------------------------------------------------------------

_KERNELS = ("pairhmm_fwd_stripe", "pairhmm_bwd_stripe")
_libs: dict = {}


def kernel_specs():
    from ..utils.build import CUDA_FLAGS, LibSpec, nvcc, package_path
    dep = package_path("csrc", "pairhmm_common.cuh")
    return [LibSpec(name=k, compiler=nvcc(), flags=CUDA_FLAGS,
                    sources=(package_path("csrc", f"{k}.cu"),), deps=(dep,))
            for k in _KERNELS]


def _lib(name: str):
    if name not in _libs:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        load_libs(kernel_specs(),
                  {"pairhmm_fwd_stripe": [vp] * 10 + [ci] * 6 + [vp] * 4,
                   "pairhmm_bwd_stripe": [vp] * 12 + [ci] * 6 + [vp] * 4},
                  _libs)
    return _libs[name]


def _check(xb, yb, lxb, lyb, match, insert, params, floats, s, w, bnd_in):
    """Shapes, types and devices of a stripe launch; returns (B, Lx, By)."""
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
    if w % 64 or not 0 < w <= MAX_W or by % w or not 0 <= s < by // w:
        raise ValueError(f"stripe {s} of width {w} over By={by}: want a "
                         f"64-multiple width <= {MAX_W} dividing By")
    if (bnd_in is None) != (s == 0) or (
            bnd_in is not None and bnd_in.shape != (b, lx, BND)):
        raise ValueError("bnd_in: (B, Lx, 8) from the previous stripe, "
                         "None for the first")
    kk = insert.shape[0]
    if match.shape != (kk, kk) or params.shape != (16,):
        raise ValueError("score table shapes")
    return b, lx, by, kk


def pairhmm_fwd_stripe(xb, yb, lxb, lyb, match, insert, params, iy0, jy0,
                       bnd_in, s: int, w: int):
    """Kernel 5 on stripe s. CPU tensors run `fwd_stripe_plain`."""
    if xb.device.type == "cpu":
        return fwd_stripe_plain(xb, yb, lxb, lyb, match, insert, params, iy0,
                                jy0, bnd_in, s, w)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    floats = {"iy0": iy0, "jy0": jy0}
    if bnd_in is not None:
        floats["bnd_in"] = bnd_in
    b, lx, by, kk = _check(xb, yb, lxb, lyb, match, insert, params, floats,
                           s, w, bnd_in)
    if iy0.shape != (b, by) or jy0.shape != (b, by):
        raise ValueError("iy0/jy0: (B, By)")
    dev = xb.device
    bnd = torch.zeros((b, lx, BND), dtype=torch.float32, device=dev)
    fend = torch.full((b, 5), NEG_BIG, dtype=torch.float32, device=dev)
    fm = torch.zeros((b, lx, w), dtype=torch.float32, device=dev)
    lib = _lib("pairhmm_fwd_stripe")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pairhmm_fwd_stripe(
        _ptr(xb), _ptr(yb), _ptr(lxb), _ptr(lyb), _ptr(match), _ptr(insert),
        _ptr(params), _ptr(iy0), _ptr(jy0),
        None if bnd_in is None else _ptr(bnd_in), b, lx, by, s, w, kk,
        _ptr(bnd), _ptr(fend), _ptr(fm),
        ctypes.c_void_p(stream))
    _raise_on(lib, rc, "pairhmm_fwd_stripe")
    LAUNCHES["pairhmm_fwd_stripe"] += 1
    return bnd, fend, fm


def pairhmm_bwd_stripe(xb, yb, lxb, lyb, match, insert, params, tot, iy0b,
                       jy0b, bnd_in, fm, sp: int, w: int):
    """Kernel 6 on reversed stripe sp. CPU tensors run `bwd_stripe_plain`."""
    if xb.device.type == "cpu":
        return bwd_stripe_plain(xb, yb, lxb, lyb, match, insert, params, tot,
                                iy0b, jy0b, bnd_in, fm, sp, w)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    floats = {"tot": tot, "iy0b": iy0b, "jy0b": jy0b, "fm": fm}
    if bnd_in is not None:
        floats["bnd_in"] = bnd_in
    b, lx, by, kk = _check(xb, yb, lxb, lyb, match, insert, params, floats,
                           sp, w, bnd_in)
    if (tot.shape != (b,) or iy0b.shape != (b, by) or jy0b.shape != (b, by)
            or fm.shape != (b, lx, w)):
        raise ValueError("tot (B,), iy0b/jy0b (B, By), fm (B, Lx, W)")
    dev = xb.device
    post = torch.empty((b, lx, w), dtype=torch.float32, device=dev)
    bnd = torch.empty((b, lx, BND), dtype=torch.float32, device=dev)
    mea = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = _lib("pairhmm_bwd_stripe")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pairhmm_bwd_stripe(
        _ptr(xb), _ptr(yb), _ptr(lxb), _ptr(lyb), _ptr(match), _ptr(insert),
        _ptr(params), _ptr(tot), _ptr(iy0b), _ptr(jy0b),
        None if bnd_in is None else _ptr(bnd_in), _ptr(fm), b, lx, by, sp, w,
        kk, _ptr(post), _ptr(bnd), _ptr(mea), ctypes.c_void_p(stream))
    _raise_on(lib, rc, "pairhmm_bwd_stripe")
    LAUNCHES["pairhmm_bwd_stripe"] += 1
    return post, bnd, mea


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
                              stripe_w: int = 2048):
    """Sparse posteriors + EA for long pairs via the Y-striped kernels.

    xb/yb: (B, Bx)/(B, By) wildcard-padded codes, By a multiple of
    stripe_w. Returns (vals (B, Bx, K), cols (B, Bx, K), ea (B,), max_nnz
    int) — the contract of sparsify(batch_posteriors(...)) with EA.
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

    # pass A: M rows, boundaries and final states of every stripe
    fms, bnd, fend = [], None, None
    for s in range(n_s):
        bnd, fe, fm = pairhmm_fwd_stripe(*args, iy0, jy0, bnd, s, stripe_w)
        fms.append(fm)
        fend = fe if fend is None else torch.maximum(fend, fe)
    del bnd
    tot = _total_prob(fend, params).contiguous()

    # pass B, right to left: backward stripe S-1-sigma on forward stripe
    # sigma's M rows, then the stripe's top-K
    vals_parts, cols_parts, nnz = [], [], 0
    bwd_bnd, mea = None, None
    for sp in range(n_s):
        sigma = n_s - 1 - sp
        post, bwd_bnd, mea = pairhmm_bwd_stripe(
            *args, tot, iy0b, jy0b, bwd_bnd, fms.pop(), sp, stripe_w)
        v, c = _top_k(post, k)
        vals_parts.append(v)
        cols_parts.append(torch.where(v > 0, c.to(torch.int32)
                                      + sigma * stripe_w, -1))
        nnz = nnz + (post > 0).sum(dim=-1)
        del post

    # exact merge: the global top-K is the top-K of the stripes' top-Ks
    v, idx = _top_k(torch.cat(vals_parts, dim=-1), k)
    c = torch.gather(torch.cat(cols_parts, dim=-1), -1, idx)
    valid = v > 0.0
    vals = torch.where(valid, v, 0.0)
    cols = torch.where(valid, c, -1).to(torch.int32)
    ea = mea / torch.minimum(lxb, lyb).float()
    return vals, cols, ea, int(nnz.max())
