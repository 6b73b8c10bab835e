"""The pair-HMM in the reference binary's LOG_ADD order on the GPU
(MUSCLE_TPU_EXACT_ASSOC=1): two hand-written CUDA kernels.

The JAX package matches the reference binary bit for bit under this
flag by running its XLA scan (muscle_tpu/ops/pairhmm.py with
EXACT_ASSOC) for every pair-HMM pass: the within-row chains, row 0 and
the backward's column 0 go term by term in the binary's order. Here the
same recurrences run as two kernels (csrc/pairhmm_exact.cu):

* `pairhmm_fwd_exact`: the forward M lattice and each pair's five
  states at (lx, ly);
* `pairhmm_bwd_exact`: the reversed backward M lattice (RB_M) and its
  five states at (lx, ly), the far corner that -testfb folds;

each a wavefront of row bands over the pair's lattice: a warp a band of
32 rows (one a lane, a column a step, the row above handed on by
shuffles), a block a round of up to 4 bands, rounds on as many
SMs at once, each taking the round above's last row from device memory
(`exact_geometry`). Their plain versions are ops/pairhmm.py's
`fwd_exact_wave` / `bwd_exact_wave` (the same cells, one diagonal at a
time, in torch); kernel and plain version agree bit for bit.
`exact_band_plain` runs the kernels' schedule itself on the CPU (its
lanes, bands, hand-over ring, link and M tile, step by step) and checks
every hand-over read.

Emission sources: `Letters` (codes with one table set, or one a pair:
the letter path and the ensembles' replicate batching) and `Lattice`
(a (B, Lx, Ly) emission lattice: Muscle-3D). Both kernels read the
source itself, the backward through reversed positions.

`exact_posteriors` is the route every pair-HMM pass of the port takes on
the card in this mode: the two kernels, the total-probability fold and
the posterior combine of ops/pairhmm.py (torch; the JAX scan backend's
own tail, so the same bits), then kernel 4 (`pairhmm_emis_cuda.
mea_scores`) for EA. On CPU tensors the same route runs the plain
versions and `pairhmm._mea_score`. A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches its kernel or raises.
`LAUNCHES` counts the launches, `ROUTES` the batches by source.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import pairhmm as ph
from . import wavefront
from .devjoin_cuda import MEA_WAIT_CYCLES
from .logspace import LOG_ZERO
from .pairhmm_cuda import (P_TSI, P_TSJ, P_TSM, _on_card, _ptr, _stream,
                           params_rows, params_vec, tables)

LAUNCHES = {"pairhmm_fwd_exact": 0, "pairhmm_bwd_exact": 0}
# batches through exact_posteriors by emission source, and the long pairs
# among them (pipeline/posteriors.py's long-pair router)
ROUTES = {"letters": 0, "tables": 0, "lattice": 0, "long_pairs": 0}

# csrc/pairhmm_exact.cu's constants (a CPU test reads them there): bands
# (warps) a block at most, steps a run (columns a take from the band
# above), hand-over ring slots, M tile columns, columns a write of the
# tile
EXACT_MAX_WARPS = 4
EXACT_HC = 8
EXACT_RING = 128
EXACT_MC = 64
EXACT_CWM = 16
# pairs a posterior combine takes at once: its temporaries stay near
# 1 GB each
COMBINE_CELLS = 1 << 28


class Letters(NamedTuple):
    """Codes xb (B, Lx), yb (B, Ly) int32 with one table set (match
    (K+1, K+1), insert (K+1,)) or one a pair ((B, K+1, K+1), (B, K+1))."""
    xb: torch.Tensor
    yb: torch.Tensor
    match: torch.Tensor
    insert: torch.Tensor


class Lattice(NamedTuple):
    """An emission lattice e (B, Lx, Ly) f32 with the x and y insert
    scores ins_x (B, Lx), ins_y (B, Ly)."""
    e: torch.Tensor
    ins_x: torch.Tensor
    ins_y: torch.Tensor


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_routes() -> None:
    for k in ROUTES:
        ROUTES[k] = 0


def exact_geometry(lx: int, warps: int | None = None) -> tuple[int, int]:
    """(warps a block, rounds a pair) of a launch over `lx` padded rows: a
    round is one block of `warps` bands of 32 rows (EXACT_MAX_WARPS, at
    most one a band, by default); the launch has B * rounds blocks, those
    past a pair's own lx rows end at once. A block's warps share its SM's
    4 schedulers and a pair's bands all run at the pace of the slowest,
    so a long pair (~45 bands at work at once) wants a warp a scheduler;
    and blocks of at most 4 warps let a thread have up to 255 registers,
    which sped every shape but the backward at 512 x 512^2 up, by up to
    29 % (tools/torch_exact_probe.py on an H100 80GB HBM3 at 700 W; 8
    and 16 warps a block were no faster anywhere)."""
    nb = -(-lx // 32)
    warps = warps or max(1, min(nb, EXACT_MAX_WARPS))
    if not 1 <= warps <= EXACT_MAX_WARPS:
        raise ValueError(f"warps {warps} not in 1..{EXACT_MAX_WARPS}")
    return warps, -(-nb // warps)


def start_scores(params, b: int) -> torch.Tensor:
    """(B, 5) start scores [tSM, tSI, tSI, tSJ, tSJ] of (16,) params or
    (B, 16) rows: the states at RB(0, 0), which the total folds."""
    s = params[..., [P_TSM, P_TSI, P_TSI, P_TSJ, P_TSJ]]
    return s.expand(b, 5) if s.dim() == 1 else s


def _start_tv(params):
    """(start, tv) in ops/pairhmm.py's layout from (16,) / (B, 16)."""
    return params[..., [P_TSM, P_TSI, P_TSI, P_TSJ, P_TSJ]], params[..., 3:10]


def _lattice(src: Letters):
    """(e, ins_x, ins_y) of a letter source."""
    xb, yb = src.xb.long(), src.yb.long()
    if src.match.dim() == 2:
        return (src.match[xb[:, :, None], yb[:, None, :]], src.insert[xb],
                src.insert[yb])
    ar = torch.arange(xb.shape[0], device=xb.device)[:, None, None]
    return (src.match[ar, xb[:, :, None], yb[:, None, :]],
            torch.gather(src.insert, 1, xb), torch.gather(src.insert, 1, yb))


def _reversed(src, lxb, lyb):
    """(e_rev, ins_xr, ins_yr) of the per-pair reversed sequences, as the
    JAX package builds them (reverse_padded: position k < len is
    len-1-k)."""
    if isinstance(src, Letters):
        return _lattice(src._replace(xb=ph.reverse_padded(src.xb, lxb),
                                     yb=ph.reverse_padded(src.yb, lyb)))
    b, nx, ny = src.e.shape
    dev = src.e.device
    ix = torch.remainder(lxb.long()[:, None] - 1
                         - torch.arange(nx, device=dev)[None, :], nx)
    iy = torch.remainder(lyb.long()[:, None] - 1
                         - torch.arange(ny, device=dev)[None, :], ny)
    ar = torch.arange(b, device=dev)[:, None, None]
    return (src.e[ar, ix[:, :, None], iy[:, None, :]],
            torch.gather(src.ins_x, 1, ix), torch.gather(src.ins_y, 1, iy))


def fwd_exact_plain(src, lxb, lyb, params):
    """Plain version of pairhmm_fwd_exact (ops/pairhmm.py::fwd_exact_wave).
    Returns (fm (B, Lx, Ly): fm[:, i-1, j-1] = F_M(i, j), fend (B, 5))."""
    e, ins_x, ins_y = src if isinstance(src, Lattice) else _lattice(src)
    start, tv = _start_tv(params)
    m, fend = ph.fwd_exact_wave(e, ins_x, ins_y, lxb, lyb, start, tv)
    return m[:, 1:, 1:], fend


def bwd_exact_plain(src, lxb, lyb, params):
    """Plain version of pairhmm_bwd_exact (ops/pairhmm.py::bwd_exact_wave).
    Returns (rbm (B, Lx, Ly): RB_M(u, v) for u < Lx, v < Ly, far (B, 5):
    the states at RB(lx, ly))."""
    e_rev, ins_xr, ins_yr = _reversed(src, lxb, lyb)
    start, tv = _start_tv(params)
    m, _corner, far = ph.bwd_exact_wave(e_rev, ins_xr, ins_yr, start, tv,
                                        lxb, lyb)
    return m[:, :-1, :-1], far


# ---------------------------------------------------------------------------
# the kernels' schedule on the CPU
# ---------------------------------------------------------------------------

_SCORES = ("tSM", "tSI", "tSJ", "tMM", "tMI", "tMJ", "tII", "tIM", "tJJ",
           "tJM")


class _Block:
    """A block of the band schedule: ticket t runs round t // B of pair
    t % B; its warps' hand-over rings (with the column each slot holds,
    the kernel's slot tag) and their counts of columns read and used."""

    def __init__(self, t, b_count, warps, nh, lx, ly):
        self.t, self.r, self.b = t, t // b_count, t % b_count
        self.lx, self.ly = lx, ly
        self.ring = torch.zeros((warps, nh, EXACT_RING))
        self.ring_pos = torch.full((warps, EXACT_RING), -1, dtype=torch.long)
        self.taken = [0] * warps


class _Schedule:
    """The shared state of one exact_band_plain run: the lattice (the
    backward's reversed), the outputs, the link rows with the column
    each slot holds."""

    # a ring's producer puts column c once its consumer has used column
    # c - ROOM (the kernel's RING: the slot it overwrites)
    ROOM = EXACT_RING

    def __init__(self, e, ins_x, ins_y, lxb, lyb, params, bwd, warps):
        self.e, self.ins_x, self.ins_y = e.float(), ins_x.float(), \
            ins_y.float()
        self.b_count, self.n_rows, self.width = e.shape
        self.warps, self.rounds = exact_geometry(self.n_rows, warps)
        self.bwd, self.nh = bwd, 3 if bwd else 5
        self.lxs = [min(int(v), self.n_rows) for v in lxb]
        self.lys = [min(int(v), self.width) for v in lyb]
        tickets = self.b_count * self.rounds
        self.lat = torch.zeros((self.b_count, self.n_rows, self.width))
        self.ends = torch.zeros((self.b_count, 5))
        self.links = torch.zeros((tickets, self.nh, self.width + 1))
        self.link_pos = torch.full((tickets, self.width + 1), -1,
                                   dtype=torch.long)
        self.rows = (params if params.dim() == 2
                     else params.expand(self.b_count, 16)).float()

    def link_holds(self, src_t, c0, n):
        """Do ticket src_t's link slots hold columns c0 .. c0 + n - 1?"""
        return torch.equal(self.link_pos[src_t, c0:c0 + n],
                           torch.arange(c0, c0 + n))

    def read_link(self, src_t, c0, n):
        """(nh, EXACT_HC) columns c0 .. c0 + n - 1 of ticket src_t's row."""
        out = torch.zeros((self.nh, EXACT_HC))
        out[:, :n] = self.links[src_t, :, c0:c0 + n]
        return out

    def warp(self, blk: _Block, w: int):
        """Warp w of blk as a generator: yields True after each run of
        EXACT_HC steps, False while a wait holds it."""
        hc, ring_n, mc, cwm = EXACT_HC, EXACT_RING, EXACT_MC, EXACT_CWM
        bwd, nh, b, lx, ly, t = (self.bwd, self.nh, blk.b, blk.lx, blk.ly,
                                 blk.t)
        nb = max(1, -(-lx // 32))
        band = blk.r * self.warps + w
        if band >= nb:
            return
        has_out = band + 1 < nb
        row0_in, ring_in = band == 0, w > 0
        link_in = w == 0 and blk.r > 0
        ring_out = has_out and w < self.warps - 1
        link_out = has_out and w == self.warps - 1
        sc = {k: self.rows[b, n] for n, k in enumerate(_SCORES)}
        lanes = torch.arange(32)
        lz = torch.tensor(LOG_ZERO, dtype=torch.float32)
        row0 = band * 32
        i = row0 + lanes + 1
        live = i <= lx
        xrow = torch.where(live, i - 1, 0)
        insx = torch.where(live, self.ins_x[b, xrow], 0.0)
        end_lane = lx - 1 - row0
        end_step = (ly + end_lane if 0 <= end_lane < 32
                    else ly if lx == 0 else -1)
        tile = torch.zeros((32, mc))
        tile_pos = torch.full((32, mc), -1, dtype=torch.long)
        if bwd:
            nrows = min(32, min(lx, self.n_rows - 1) - row0)
            ncols, out_row0, d_col = min(ly + 1, self.width), row0 + 1, 0
            cur = [lz.expand(32)] * 3
            dm = torch.zeros(32)
            liy = ljy = lz.expand(32)
            r0 = [sc["tSI"], sc["tSJ"]]
        else:
            nrows, ncols, out_row0, d_col = min(32, lx - row0), ly, row0, 1
            dg = lf = [lz.expand(32)] * 5
            r0 = [lz, lz]
        hcol = torch.zeros((nh, hc))
        flushed = 0

        def flush(c0):
            for rr in range(max(nrows, 0)):
                for col in range(c0, min(c0 + cwm, ncols)):
                    if int(tile_pos[rr, col % mc]) != col:
                        raise RuntimeError(
                            f"ticket {t} warp {w}: M tile slot of row {rr} "
                            f"column {col} overwritten before its write")
                    self.lat[b, out_row0 + rr, col] = tile[rr, col % mc]

        for s0 in range(0, ly + 32, hc):
            # lane 0's row above for columns s0 .. s0 + n - 1: taken once
            # every slot holds its column (the kernel's tags)
            n = max(0, min(hc, ly + 1 - s0))
            if ring_in:
                blk.taken[w - 1] = min(s0, ly + 1)
                want = torch.arange(s0, s0 + n)
                while not torch.equal(blk.ring_pos[w - 1, want % ring_n],
                                      want):
                    yield False
                hcol = torch.zeros((nh, hc))
                hcol[:, :n] = blk.ring[w - 1][:, want % ring_n]
            elif link_in:
                while not self.link_holds(t - self.b_count, s0, n):
                    yield False
                hcol = self.read_link(t - self.b_count, s0, n)
            if ring_out:
                last = min(s0 + hc - 32, ly)
                while (last >= self.ROOM
                       and blk.taken[w] < last + 1 - self.ROOM):
                    yield False
            for kk in range(hc):
                s = s0 + kk
                j = s - lanes
                yc = torch.clamp(j - 1, 0, max(ly - 1, 0))
                em, iny = self.e[b, xrow, yc], self.ins_y[b, yc]
                if row0_in and bwd:
                    # row 0: M, IY, JY chained along the row (lane 0's)
                    nyi, nyj = r0[0] + iny[0], r0[1] + iny[0]
                    m = ph.log_add(sc["tMI"] + nyi, sc["tMJ"] + nyj)
                    if s > 0:
                        r0 = [sc["tII"] + nyi, sc["tJJ"] + nyj]
                    hin = ([sc["tSM"], sc["tSI"], sc["tSJ"]] if s == 0
                           else [m, lz, lz])
                    if s <= ly and s < self.width:
                        self.lat[b, 0, s] = hin[0]
                    if lx == 0 and s == ly:
                        self.ends[b] = torch.stack(
                            [hin[0], hin[1], r0[0], hin[2], r0[1]])
                elif row0_in:
                    # row 0: IY, JY chained along the row, the rest zero
                    r0 = ([lz, lz] if s == 0 else
                          [sc["tSI"] + iny[0], sc["tSJ"] + iny[0]] if s == 1
                          else [(r0[0] + sc["tII"]) + iny[0],
                                (r0[1] + sc["tJJ"]) + iny[0]])
                    hin = [lz, lz, r0[0], lz, r0[1]]
                else:
                    hin = [hcol[k, kk] for k in range(nh)]
                prev = cur if bwd else lf
                up = [torch.cat([hin[k].reshape(1), prev[k][:-1]])
                      for k in range(nh)]
                c0 = j == 0
                if bwd:
                    nix, njx = up[1] + insx, up[2] + insx
                    nm = dm + em
                    nyi, nyj = liy + iny, ljy + iny
                    l1 = ph.log_add(
                        torch.where(c0, sc["tMI"] + nix, sc["tII"] + nix),
                        torch.where(c0, sc["tMJ"] + njx, sc["tIM"] + nm))
                    jx = ph.log_add(sc["tJJ"] + njx, sc["tJM"] + nm)
                    iy = ph.log_add(sc["tII"] + nyi, sc["tIM"] + nm)
                    jy = ph.log_add(sc["tJJ"] + nyj, sc["tJM"] + nm)
                    mf = ph.log_add5(sc["tMM"] + nm, sc["tMI"] + nix,
                                     sc["tMJ"] + njx, sc["tMI"] + nyi,
                                     sc["tMJ"] + nyj)
                    cur = [torch.where(c0, l1, mf),
                           torch.where(c0, sc["tII"] + nix, l1),
                           torch.where(c0, sc["tJJ"] + njx, jx)]
                    dm = up[0]
                    liy = torch.where(c0, lz, iy)
                    ljy = torch.where(c0, lz, jy)
                    five = [cur[0], cur[1], liy, cur[2], ljy]
                    hand = cur
                else:
                    mf = ph.log_add5(dg[0] + sc["tMM"], dg[1] + sc["tIM"],
                                     dg[3] + sc["tJM"], dg[2] + sc["tIM"],
                                     dg[4] + sc["tJM"])
                    cm = torch.where((i == 1) & (j == 1), sc["tSM"], mf) + em
                    g = ph.log_add(torch.stack([up[1] + sc["tII"],
                                                up[3] + sc["tJJ"],
                                                lf[2] + sc["tII"],
                                                lf[4] + sc["tJJ"]]),
                                   torch.stack([up[0] + sc["tMI"],
                                                up[0] + sc["tMJ"],
                                                lf[0] + sc["tMI"],
                                                lf[0] + sc["tMJ"]]))
                    ix0 = torch.where(i == 1, sc["tSI"] + insx,
                                      (up[1] + sc["tII"]) + insx)
                    jx0 = torch.where(i == 1, sc["tSJ"] + insx,
                                      (up[3] + sc["tJJ"]) + insx)
                    five = [torch.where(c0, lz, cm),
                            torch.where(c0, ix0, g[0] + insx),
                            torch.where(c0, lz, g[2] + iny),
                            torch.where(c0, jx0, g[1] + insx),
                            torch.where(c0, lz, g[3] + iny)]
                    dg, lf = up, five
                    hand = five
                # the M tile (every lane, every step: columns outside the
                # pair too), lane 31 to the band below, the end states
                col = j - d_col
                tile[lanes, col % mc] = five[0]
                tile_pos[lanes, col % mc] = col
                col31 = s - 31
                if 0 <= col31 <= ly:
                    put = torch.stack([hand[k][31] for k in range(nh)])
                    if ring_out:
                        old = int(blk.ring_pos[w, col31 % ring_n])
                        if old >= blk.taken[w]:
                            raise RuntimeError(
                                f"ticket {t} warp {w}: ring column {old} "
                                "overwritten before it was read")
                        blk.ring[w, :, col31 % ring_n] = put
                        blk.ring_pos[w, col31 % ring_n] = col31
                    if link_out:
                        self.links[t, :, col31] = put
                        self.link_pos[t, col31] = col31
                if s == end_step:
                    if lx == 0 and not bwd:
                        self.ends[b] = torch.stack([lz, lz, r0[0], lz, r0[1]])
                    elif lx > 0:
                        self.ends[b] = torch.stack([f[end_lane] for f in five])
            s_end = s0 + hc - 1
            while flushed < ncols and s_end >= flushed + cwm + 30 + d_col:
                flush(flushed)
                flushed += cwm
            yield True
        for c0 in range(flushed, ncols, cwm):
            flush(c0)


def exact_band_plain(src, lxb, lyb, params, bwd: bool = False,
                     warps: int | None = None, resident: int | None = None,
                     seed: int = 0):
    """The exact kernels' schedule on the CPU (csrc/pairhmm_exact.cu),
    returning what `pairhmm_fwd_exact` (bwd=False) or `pairhmm_bwd_exact`
    returns inside each pair. Blocks take tickets in order (at most
    `resident` at once, all if None); ticket t runs round t // B of pair
    t % B with `warps` bands (exact_geometry), one warp a band of 32
    rows, whose lanes (torch vectors of 32) compute column s - lane at
    band step s in the kernel's expressions (ops/logspace's LOG_ADD,
    whose double Horner steps give the kernel's FMA bits), lane t's row
    above from lane t-1's cell of the step before. Each warp runs
    EXACT_HC steps at a time, in an order a seeded generator picks among
    the warps whose waits allow: lane 0 takes the band above's columns
    from warp w-1's ring once each slot holds its column (the kernel's
    slot tags; freeing them a run later), warp 0 of a later round from
    the link row of ticket t - B likewise, band 0 from row 0's chain;
    lane 31 puts its states into its ring (after waiting for room) or
    the link; every lane puts its M cell into the warp's tile, written
    out EXACT_CWM columns at a time. A ring slot overwritten before its
    column was used, or a tile slot before its write-out, raises; so does
    a sweep in which no warp moves and no block can start (a
    deadlock)."""
    if bwd:
        e, ins_x, ins_y = _reversed(src, lxb, lyb)
    else:
        e, ins_x, ins_y = src if isinstance(src, Lattice) else _lattice(src)
    sch = _Schedule(e, ins_x, ins_y, lxb, lyb, params, bwd, warps)
    rng = np.random.default_rng(seed)
    tickets = sch.b_count * sch.rounds
    cap = resident or tickets
    running: list = []  # (block, generator) of the resident blocks
    nxt = 0
    while nxt < tickets or running:
        while nxt < tickets and len({id(b) for b, _ in running}) < cap:
            b = nxt % sch.b_count
            blk = _Block(nxt, sch.b_count, sch.warps, sch.nh, sch.lxs[b],
                         sch.lys[b])
            running += [(blk, sch.warp(blk, w)) for w in range(sch.warps)]
            nxt += 1
        moved, done = False, []
        for k in rng.permutation(len(running)):
            try:
                moved |= next(running[k][1])
            except StopIteration:
                done.append(k)
                moved = True
        running = [r for k, r in enumerate(running) if k not in set(done)]
        if not moved:
            raise RuntimeError("exact band schedule: deadlock")
    return sch.lat, sch.ends


# ---------------------------------------------------------------------------
# kernel build + launch
# ---------------------------------------------------------------------------

_lib_cache: dict = {}


def kernel_specs():
    from ..utils.build import cuda_spec, package_path
    return [cuda_spec("pairhmm_exact",
                      deps=(package_path("csrc", "pairhmm_common.cuh"),
                            package_path("csrc", "mea_wave.cuh")))]


def _lib():
    if "lib" not in _lib_cache:
        from ..utils.build import ensure_built
        spec = kernel_specs()[0]
        lib = ctypes.CDLL(ensure_built([spec])[spec.name])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in LAUNCHES:
            fn = getattr(lib, name)
            fn.restype = ci
            fn.argtypes = ([ci] + [vp] * 4 + [ci] * 2 + [vp] * 6 + [ci] * 5
                           + [ctypes.c_longlong] + [vp] * 6)
        lib.pairhmm_error_string.restype = ctypes.c_char_p
        lib.pairhmm_error_string.argtypes = [ci]
        _lib_cache["lib"] = lib
    return _lib_cache["lib"]


def _check(src, lxb, lyb, params):
    """(B, Lx, Ly) of a launch; raises on what the kernels do not take."""
    dev = lxb.device
    ints = (("lxb", lxb), ("lyb", lyb))
    floats = [("params", params)]
    if isinstance(src, Letters):
        ints += (("xb", src.xb), ("yb", src.yb))
        floats += [("match", src.match), ("insert", src.insert)]
        b, lx = src.xb.shape
        ly = src.yb.shape[1]
        kk = src.insert.shape[-1]
        lead = (b,) if src.match.dim() == 3 else ()
        ok = (src.yb.shape[0] == b and src.match.shape == lead + (kk, kk)
              and src.insert.shape == lead + (kk,))
    else:
        floats += [("e", src.e), ("ins_x", src.ins_x), ("ins_y", src.ins_y)]
        b, lx, ly = src.e.shape
        ok = src.ins_x.shape == (b, lx) and src.ins_y.shape == (b, ly)
    for name, t in ints:
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {dev}")
    for name, t in floats:
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32 on {dev}")
    if (not ok or lxb.shape != (b,) or lyb.shape != (b,)
            or params.shape not in ((16,), (b, 16)) or lx < 1 or ly < 1):
        raise ValueError("shapes disagree")
    return b, lx, ly


def _launch(name, src, lxb, lyb, params):
    b, lx, ly = _check(src, lxb, lyb, params)
    dev = lxb.device
    warps, rounds = exact_geometry(lx)
    lat = torch.empty((b, lx, ly), dtype=torch.float32, device=dev)
    ends = torch.empty((b, 5), dtype=torch.float32, device=dev)
    # the ticket; a block hands its last row's states (5 forward, 3
    # backward) on in 64-bit slots, empty (zero), a row a ticket
    sync = torch.zeros(1, dtype=torch.int32, device=dev)
    states = 5 if name == "pairhmm_fwd_exact" else 3
    links = torch.zeros(b * rounds * states * (ly + 1), dtype=torch.int64,
                        device=dev)
    null = ctypes.c_void_p(0)
    if isinstance(src, Letters):
        source = (0, _ptr(src.xb), _ptr(src.yb), _ptr(src.match),
                  _ptr(src.insert), src.insert.shape[-1],
                  int(src.match.dim() == 3), null, null, null)
    else:
        source = (1, null, null, null, null, 0, 0, _ptr(src.e),
                  _ptr(src.ins_x), _ptr(src.ins_y))
    lib = _lib()
    rc = getattr(lib, name)(*source, _ptr(lxb), _ptr(lyb), _ptr(params),
                            int(params.dim() == 2), b, lx, ly, warps,
                            MEA_WAIT_CYCLES, _ptr(sync),
                            _ptr(wavefront.fault_flag(dev)), _ptr(links),
                            _ptr(lat), _ptr(ends), _stream(lxb))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.pairhmm_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return lat, ends


def pairhmm_fwd_exact(src, lxb, lyb, params):
    """The reference-order forward: (fm (B, Lx, Ly), fm[:, i-1, j-1] =
    F_M(i, j), written inside each pair's (lx, ly) only; fend (B, 5)).
    Blocks of exact_geometry's bands. A hand-over that waited past
    MEA_WAIT_CYCLES sets the fault flag: the caller runs
    `wavefront.check_waits`, as exact_posteriors does. CPU tensors run
    `fwd_exact_plain`."""
    if not _on_card(lxb):
        return fwd_exact_plain(src, lxb, lyb, params)
    return _launch("pairhmm_fwd_exact", src, lxb, lyb, params)


def pairhmm_bwd_exact(src, lxb, lyb, params):
    """The reference-order backward: (rbm (B, Lx, Ly) = RB_M(u, v),
    written for u <= lx, v <= ly only; far (B, 5), the states at RB(lx,
    ly)). As pairhmm_fwd_exact otherwise; CPU tensors run
    `bwd_exact_plain`."""
    if not _on_card(lxb):
        return bwd_exact_plain(src, lxb, lyb, params)
    return _launch("pairhmm_bwd_exact", src, lxb, lyb, params)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def exact_posteriors(src, lxb, lyb, params, with_mea: bool = True):
    """Posteriors (B, Lx, Ly) f32 (zero outside each pair's (lx, ly)) and
    EA (B,) f32 (zeros if with_mea=False) in the reference order: the
    two kernels, the total fold, the posterior combine written over the
    forward lattice (pairs at a time, COMBINE_CELLS), kernel 4. The
    JAX scan backend's `batch_posteriors_emissions` with EXACT_ASSOC."""
    lxb = lxb.to(torch.int32).contiguous()
    lyb = lyb.to(torch.int32).contiguous()
    fm, fend = pairhmm_fwd_exact(src, lxb, lyb, params)
    rbm, _far = pairhmm_bwd_exact(src, lxb, lyb, params)
    b, lx, ly = fm.shape
    total = ph.total_prob(fend, start_scores(params, b))
    step = max(1, COMBINE_CELLS // (lx * ly))
    for lo in range(0, b, step):
        hi = min(b, lo + step)
        fm[lo:hi] = ph.posterior_combine(fm[lo:hi], rbm[lo:hi],
                                         total[lo:hi], lxb[lo:hi],
                                         lyb[lo:hi])
    del rbm
    on_card = _on_card(fm)
    if not with_mea:
        mea = torch.zeros(b, dtype=torch.float32, device=fm.device)
    elif on_card:
        from .pairhmm_emis_cuda import mea_scores
        mea = mea_scores(fm, lxb, lyb)
    else:
        mea = ph._mea_score(fm)
    if on_card:
        # the exact kernels' and kernel 4's hand-overs: raises on a stuck one
        wavefront.check_waits(fm.device)
    if not with_mea:
        return fm, mea
    return fm, mea / torch.minimum(lxb, lyb).float()


def batch_posteriors_exact(xb, yb, lxb, lyb, pack, with_mea: bool = True):
    """exact_posteriors of letter pairs with one score pack."""
    match, insert, params = tables(pack, xb.device)
    ROUTES["letters"] += 1
    return exact_posteriors(
        Letters(xb.to(torch.int32).contiguous(),
                yb.to(torch.int32).contiguous(), match, insert),
        lxb, lyb, params, with_mea)


def batch_posteriors_exact_multi(xb, yb, lxb, lyb, match_b, insert_b,
                                 start_b, tv_b, with_mea: bool = True):
    """exact_posteriors of letter pairs with per-pair score tables
    (pairhmm.batch_posteriors_multi's arguments)."""
    ROUTES["tables"] += 1
    return exact_posteriors(
        Letters(xb.to(torch.int32).contiguous(),
                yb.to(torch.int32).contiguous(), match_b.contiguous(),
                insert_b.contiguous()),
        lxb, lyb, params_rows(start_b, tv_b), with_mea)


def batch_posteriors_emissions_exact(e, ins_x, ins_y, lxb, lyb, pack):
    """exact_posteriors from an emission lattice (Muscle-3D), transitions
    from `pack`."""
    ROUTES["lattice"] += 1
    return exact_posteriors(
        Lattice(e.contiguous(), ins_x.contiguous(), ins_y.contiguous()),
        lxb, lyb, params_vec(pack, e.device))
