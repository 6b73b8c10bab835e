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

from .pairhmm import MIN_SPARSE_SCORE
from .pairhmm_cuda import (_on_card, _ptr, _raise_on, _shift_fill, _stream,
                           _total_prob, bwd_post_rows, bwd_rows, fwd_rows,
                           load_libs, params_vec,
                           reversed_lanes)  # noqa: F401 (tests, chip_smoke)

# lane-axis cap of the fused route, the JAX package's value (there, the
# fused backward's VMEM scratch); the legacy route takes wider pads
FUSED_MAX_LY = 9856
# lane-axis cap of kernels 1E and 3 (S = 6 segments a warp): the
# legacy route's rung 12288, chains of up to 12288 residues
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
                  {"pairhmm_fwd_emis": [vp] * 6 + [ci] * 4 + [vp] * 3,
                   "pairhmm_bwd_post_emis": [vp] * 6 + [ci] + [vp]
                   + [ci] * 3 + [vp] * 4,
                   "pairhmm_bwd": [vp] * 6 + [ci] * 4 + [vp] * 2},
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


def pairhmm_fwd_emis(e, ins_x, ins_y, lxb, lyb, params):
    """Kernel 1E (forward from the lattice). CPU tensors run
    `fwd_emis_plain`. Returns (fm (B, Lx, Ly), rows >= lx unwritten;
    fend (B, 5))."""
    if not _on_card(e):
        return fwd_emis_plain(e, ins_x, ins_y, lxb, lyb, params)
    b, lx, ly = _check(e, ins_x, ins_y, lxb, lyb, params, MAX_LY)
    fm = torch.empty((b, lx, ly), dtype=torch.float32, device=e.device)
    fend = torch.empty((b, 5), dtype=torch.float32, device=e.device)
    lib = _lib("pairhmm_fwd_emis")
    rc = lib.pairhmm_fwd_emis(_ptr(e), _ptr(ins_x), _ptr(ins_y), _ptr(lxb),
                              _ptr(lyb), _ptr(params), _per_pair(params), b,
                              lx, ly, _ptr(fm), _ptr(fend), _stream(e))
    _raise_on(lib, rc, "pairhmm_fwd_emis")
    LAUNCHES["pairhmm_fwd_emis"] += 1
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


def pairhmm_bwd(e, ins_x, ins_y, lxb, lyb, params):
    """Kernel 3 (legacy backward: RB_M (B, Lx, Ly), rows >= lx zero).
    CPU tensors run `bwd_plain`."""
    if not _on_card(e):
        return bwd_plain(e, ins_x, ins_y, lxb, lyb, params)
    b, lx, ly = _check(e, ins_x, ins_y, lxb, lyb, params, MAX_LY)
    rbm = torch.empty((b, lx, ly), dtype=torch.float32, device=e.device)
    lib = _lib("pairhmm_bwd")
    rc = lib.pairhmm_bwd(_ptr(e), _ptr(ins_x), _ptr(ins_y), _ptr(lxb),
                         _ptr(lyb), _ptr(params), _per_pair(params), b, lx, ly,
                         _ptr(rbm), _stream(e))
    _raise_on(lib, rc, "pairhmm_bwd")
    LAUNCHES["pairhmm_bwd"] += 1
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
            "are not ported yet: ROADMAP.md, queue 1, item 10")
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
