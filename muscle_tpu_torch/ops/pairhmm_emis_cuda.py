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
`bwd_wave_plain` is its twin). A caller runs `wavefront.check_waits`
after a wave launch, as both routes do.

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

import torch

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


# ---------------------------------------------------------------------------
# kernel build + launch
# ---------------------------------------------------------------------------

_libs: dict = {}


def kernel_specs():
    from ..utils.build import cuda_spec
    from .pairhmm_cuda import kernel_specs as pair_specs
    return (pair_specs(("pairhmm_fwd_emis", "pairhmm_bwd_post_emis",
                        "pairhmm_bwd")) + [cuda_spec("mea_scores")])


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
        _libs["mea_scores"] = load_kernel(specs[3], [vp] * 2 + [ci] * 3
                                          + [vp] * 2)
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


def mea_scores(post, lxb):
    """Kernel 4 (MEA row scan): (B, Lx, Ly) posterior, zero outside each
    pair's (lx, ly) -> (B,) MEA scores. CPU tensors run
    `mea_scores_plain`."""
    if not _on_card(post):
        return mea_scores_plain(post)
    b, lx, ly = post.shape
    if (post.dtype != torch.float32 or not post.is_contiguous()
            or lxb.dtype != torch.int32 or lxb.shape != (b,)
            or lxb.device != post.device or not lxb.is_contiguous()
            or ly % 128 or ly > 16384):
        raise ValueError("post (B, Lx, Ly) float32, Ly % 128 == 0 and "
                         "<= 16384; lxb (B,) int32 on the device")
    out = torch.empty((b,), dtype=torch.float32, device=post.device)
    fn, err = _lib("mea_scores")
    rc = fn(_ptr(post), _ptr(lxb), b, lx, ly, _ptr(out),
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
    if _on_card(e):
        wavefront.check_waits(e.device)    # raises on a stuck hand-over
    post = finish_posteriors(fm, rbm, fend, lxb, lyb, params)
    del rbm
    return post, mea_scores(post, lxb) / torch.minimum(lxb, lyb).float()


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
