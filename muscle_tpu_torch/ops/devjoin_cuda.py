"""The device joins' kernels: three hand-written CUDA kernels.

* `densify_reduce` (csrc/densify_reduce.cu) replaces
  muscle_tpu.pipeline.devjoin._dr_kernel (kernel 7, grid variant): for
  every row-owner s of a pair-index grid, the K-sparse rows of the
  pairs (s, t) summed over the col-owners t in order, each slot's
  position mapped to t's column. It reads the store through the grid,
  so JAX's gathered (W, n_c, L, k2) slot panels never exist.
* `densify_reduce_list` (csrc/densify_reduce_list.cu) replaces the
  same _dr_kernel in its list variant (kernel 7L, per_pair_imap=True),
  PProg's sampled-pair joins: for every row-owner s, the K-sparse rows
  of its run of sampled pairs summed in entry order, each slot's
  position mapped to that pair's own col-owner's column.

  Both are one body (csrc/densify_reduce.cuh) templated on where an
  owner's entries come from; `_geometry` picks its warps a block and
  its shared-memory tile. The kernels take the store's contract: the
  valid slots of a row come first (ops/sparse.sparsify's order).
* `mea_dirs` (csrc/mea_dirs.cu) replaces devjoin._mea_dirs, the MEA
  direction DP (an XLA scan in the JAX package) with its 2-bit packing:
  a skewed wavefront over the rows, one row a lane, bands of 32 rows a
  warp handing their last row down through shared memory
  (`mea_warps` picks the warps; `mea_dirs_wave_plain` runs the kernel's
  schedule on the CPU).

Beside each is its plain torch version (`densify_reduce_plain`, a loop
over t; `densify_reduce_list_plain`, a loop over the entry rank within
the owners' runs; `mea_dirs_plain`, a loop over rows with
torch.cummax). Each F cell takes at most one value per t (per entry),
added in t (entry) order, and max is exact,
so kernels and plain versions agree bit for bit. A CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises. `LAUNCHES`
counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

LAUNCHES = {"densify_reduce": 0, "densify_reduce_list": 0, "mea_dirs": 0}

# densify-reduce blocks (csrc/densify_reduce.cuh): 2 tile rows a warp,
# 1-8 warps; their entries staged in shared memory (ep, et: one int a
# thread; wcount: one a warp). A block takes at most a quarter of an
# SM's 228 KB (the 1 KB the card keeps per block included), so that four
# are resident.
_DR_ROWS_PER_WARP = 2
_DR_MAX_WARPS = 8
_DR_STAGE = (2 * 32 * _DR_MAX_WARPS + _DR_MAX_WARPS) * 4
_DR_TILE_AIM = 228 * 1024 // 4 - _DR_STAGE - 1024
# mea_dirs (csrc/mea_dirs.cu and mea_wave.cuh, whose constants these
# repeat; kernel 4, csrc/mea_scores.cu, shares the header): chunks of
# CHUNK columns staged SLOTS to a warp's ring (slot 0 kept twice), AHEAD
# in flight; inside a round of bands, the band above's row handed over
# through a ring of RING (value, position) slots, waited on and counted
# every HAND columns; from a round's last warp to warp 0 of the next, a
# row in device memory published every LINK_HAND columns; one warp a
# band of 32 rows, at most MAX_WARPS (13.4 KB of shared memory a warp)
MEA_CHUNK, MEA_SLOTS, MEA_AHEAD, MEA_HAND, MEA_RING = 16, 5, 2, 16, 128
MEA_LINK_HAND = 128
MEA_MAX_WARPS = 16
# a wait on a neighbour warp past this many SM cycles (~10 s) is a
# deadlock: the kernel sets the device's fault flag and runs on
MEA_WAIT_CYCLES = 20_000_000_000

_fns: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def mea_deps() -> tuple[str, ...]:
    """The header mea_dirs shares with kernel 4 (csrc/mea_wave.cuh)."""
    from ..utils.build import package_path
    return (package_path("csrc", "mea_wave.cuh"),)


def kernel_specs():
    """Build specs of the three libraries; kernels 7 and 7L are keyed on
    their shared header too, mea_dirs on the one it shares with kernel 4."""
    from ..utils.build import cuda_spec, package_path
    dep = (package_path("csrc", "densify_reduce.cuh"),)
    return [cuda_spec(k, deps=dep if k.startswith("densify_reduce")
                      else mea_deps())
            for k in LAUNCHES]


class Geometry(NamedTuple):
    """A densify-reduce launch: `warps` warps a block, a tile of `tr`
    rows (2 a warp) by `tc` columns, `smem` bytes of dynamic shared
    memory a block."""
    warps: int
    tr: int
    tc: int
    smem: int


def _geometry(cc: int) -> Geometry:
    """As many warps (1-8) as keep the (2 * warps, cc) f32 tile within
    _DR_TILE_AIM; the whole cc where one warp's rows fit, else column
    tiles of a multiple of 4 columns (16-byte stores). Slots go 16 to a
    step whatever k2 is, and rows beyond L are masked, so neither plays
    a part."""
    warps = max(1, min(_DR_MAX_WARPS,
                       _DR_TILE_AIM // (4 * _DR_ROWS_PER_WARP * cc)))
    tr = _DR_ROWS_PER_WARP * warps
    room = _DR_TILE_AIM // 4 - 8
    tc = cc if tr * cc <= room else room // tr // 4 * 4
    return Geometry(warps, tr, tc, (tr * tc + 8) * 4)


def _kernel(name: str):
    if name not in _fns:
        from ..utils.build import load_kernel
        vp, ci = ctypes.c_void_p, ctypes.c_int
        argtypes = {"densify_reduce": [vp, vp] + [ci] * 4 + [vp] + [ci] * 2
                    + [vp] + [ci] * 4 + [vp, vp],
                    "densify_reduce_list": [vp, vp] + [ci] * 4 + [vp, ci]
                    + [vp] * 3 + [ci] * 5 + [vp, vp],
                    "mea_dirs": [vp] + [ci] * 3 + [ctypes.c_longlong]
                    + [vp] * 5}[name]
        spec = next(s for s in kernel_specs() if s.name == name)
        _fns[name] = load_kernel(spec, argtypes)
    return _fns[name]


def _launch(name: str, *args) -> None:
    fn, err = _kernel(name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# densify-reduce
# ---------------------------------------------------------------------------

def densify_reduce_plain(vals, cols, k2: int, pid, bank, dump: int, cc: int):
    """(P1, L, K) store, (n_r, n_c) pair grid, (n_c, L) pos->col maps of
    the col-owners -> F (n_r, L, cc) f32: F[s, l, bank[t, p]] summed
    over t in order of vals[pid[s, t], l, k] at p = cols[pid[s, t], l, k].
    Dump pairs, empty slots and columns outside [0, cc) add nothing."""
    n_r, n_c = pid.shape
    l = vals.shape[1]
    f = torch.zeros((n_r, l, cc + 1), dtype=torch.float32, device=vals.device)
    for t in range(n_c):
        p = pid[:, t].long()
        v = vals[p, :, :k2]
        pos = cols[p, :, :k2]
        col = bank[t].long()[pos.clamp(0, l - 1).long()]
        ok = ((pos >= 0) & (pos < l) & (col >= 0) & (col < cc)
              & (p != dump)[:, None, None])
        f += torch.zeros_like(f).scatter_(2, torch.where(ok, col, cc),
                                          torch.where(ok, v, 0.0))
    return f[..., :cc].contiguous()


def densify_reduce(vals, cols, k2: int, pid, bank, dump: int, cc: int):
    """Kernel 7 on a CUDA store; the plain version on a CPU one."""
    if vals.device.type == "cpu":
        return densify_reduce_plain(vals, cols, k2, pid, bank, dump, cc)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    dev = vals.device
    if (vals.dtype != torch.float32 or cols.dtype != torch.int32
            or vals.dim() != 3 or cols.shape != vals.shape
            or not vals.is_contiguous() or not cols.is_contiguous()
            or cols.device != dev):
        raise ValueError(f"vals f32 / cols int32: contiguous (P1, L, K) "
                         f"on {dev}")
    p1, l, k = vals.shape
    n_r, n_c = pid.shape
    for name, t, shape in (("pid", pid, (n_r, n_c)), ("bank", bank, (n_c, l))):
        if (t.dtype != torch.int32 or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous int32 {shape} on {dev}")
    if not 0 < k2 <= k or cc < 1:
        raise ValueError(f"k2={k2} (K={k}), cc={cc}")
    out = torch.empty((n_r, l, cc), dtype=torch.float32, device=dev)
    if n_r == 0 or n_c == 0:
        return out.zero_()
    g = _geometry(cc)
    _launch("densify_reduce", vals.data_ptr(), cols.data_ptr(), p1, l, k, k2,
            pid.data_ptr(), n_r, n_c, bank.data_ptr(), dump, cc, g.tr, g.tc,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out


# ---------------------------------------------------------------------------
# densify-reduce, sampled-pair list variant
# ---------------------------------------------------------------------------

def densify_reduce_list_plain(vals, cols, k2: int, row_ptr, pid, co, bank,
                              dump: int, cc: int):
    """(P1, L, K) store, owner runs row_ptr (n_s + 1), per-entry store
    rows pid and col-owners co, (n2, L) pos->col maps of the col-owners
    -> F (n_s, L, cc) f32: F[s, l, bank[co[e], p]] summed over owner s's
    entries e in order of vals[pid[e], l, k] at p = cols[pid[e], l, k].
    Dump or out-of-range entries, empty slots and columns outside
    [0, cc) add nothing. The q-th entries of all owners go in one step."""
    n_s = row_ptr.shape[0] - 1
    p1, l = vals.shape[:2]
    dev = vals.device
    f = torch.zeros((n_s, l, cc + 1), dtype=torch.float32, device=dev)
    start = row_ptr[:-1].long()
    count = row_ptr[1:].long() - start
    for q in range(int(count.max()) if n_s else 0):
        s = torch.nonzero(count > q).flatten()
        e = start[s] + q
        p = pid[e].long()
        t = co[e].long()
        okp = (p != dump) & (p >= 0) & (p < p1) & (t >= 0) & (t < bank.shape[0])
        p = torch.where(okp, p, 0)
        t = torch.where(okp, t, 0)
        v = vals[p, :, :k2]
        pos = cols[p, :, :k2]
        col = bank.long()[t[:, None, None], pos.clamp(0, l - 1).long()]
        ok = ((pos >= 0) & (pos < l) & (col >= 0) & (col < cc)
              & okp[:, None, None])
        f[s] += torch.zeros((len(s), l, cc + 1), device=dev).scatter_(
            2, torch.where(ok, col, cc), torch.where(ok, v, 0.0))
    return f[..., :cc].contiguous()


def densify_reduce_list(vals, cols, k2: int, row_ptr, pid, co, bank,
                        dump: int, cc: int):
    """Kernel 7L on a CUDA store; the plain version on a CPU one."""
    if vals.device.type == "cpu":
        return densify_reduce_list_plain(vals, cols, k2, row_ptr, pid, co,
                                         bank, dump, cc)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    dev = vals.device
    if (vals.dtype != torch.float32 or cols.dtype != torch.int32
            or vals.dim() != 3 or cols.shape != vals.shape
            or not vals.is_contiguous() or not cols.is_contiguous()
            or cols.device != dev):
        raise ValueError(f"vals f32 / cols int32: contiguous (P1, L, K) "
                         f"on {dev}")
    p1, l, k = vals.shape
    n_s = row_ptr.shape[0] - 1
    n_e = pid.shape[0]
    for name, t, shape in (("row_ptr", row_ptr, (n_s + 1,)),
                           ("pid", pid, (n_e,)), ("co", co, (n_e,)),
                           ("bank", bank, (bank.shape[0], l))):
        if (t.dtype != torch.int32 or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous int32 {shape} on {dev}")
    if not 0 < k2 <= k or cc < 1 or n_s < 0:
        raise ValueError(f"k2={k2} (K={k}), cc={cc}, n_s={n_s}")
    out = torch.empty((n_s, l, cc), dtype=torch.float32, device=dev)
    if n_s == 0:
        return out
    g = _geometry(cc)
    _launch("densify_reduce_list", vals.data_ptr(), cols.data_ptr(), p1, l,
            k, k2, row_ptr.data_ptr(), n_s, pid.data_ptr(), co.data_ptr(),
            bank.data_ptr(), bank.shape[0], dump, cc, g.tr, g.tc,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out


# ---------------------------------------------------------------------------
# MEA direction DP
# ---------------------------------------------------------------------------

def _pack(dirs: torch.Tensor) -> torch.Tensor:
    """(cc1, 16w) 2-bit codes -> (cc1, w) int32, column j in bits
    2(j % 16) of word j // 16 (two's complement, as JAX's int32 sum)."""
    cc1 = dirs.shape[0]
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=dirs.device)
    p = (dirs.long().view(cc1, -1, 16) << shifts).sum(-1)
    return torch.where(p >= 2 ** 31, p - 2 ** 32, p).to(torch.int32)


def mea_dirs_plain(post: torch.Tensor):
    """(cc1, cc2) f32 posterior -> (packed (cc1, ceil(cc2/16)) int32
    directions, scores (cc1,) f32: new[cc2] of every row)."""
    cc1, cc2 = post.shape
    w = -(-cc2 // 16)
    dev = post.device
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    old = torch.zeros(cc2 + 1, dtype=torch.float32, device=dev)
    dirs = torch.zeros((cc1, 16 * w), dtype=torch.int32, device=dev)
    scores = torch.empty(cc1, dtype=torch.float32, device=dev)
    for i in range(cc1):
        b = old[:-1] + post[i]
        x = old[1:]
        new = torch.cummax(torch.cat([zero, torch.maximum(b, x)]), 0).values
        y = new[:-1]
        dirs[i, :cc2] = torch.where((b >= x) & (b >= y), 0,
                                    torch.where(x >= y, 1, 2))
        scores[i] = new[cc2]
        old = new
    return _pack(dirs), scores


def mea_warps(cc1: int) -> int:
    """Warps of a mea_dirs launch, as its C entry derives them: one a
    band of 32 rows, at most MEA_MAX_WARPS (more bands go round-robin)."""
    return max(1, min(-(-cc1 // 32), MEA_MAX_WARPS))


class _MeaWarp:
    """One warp of the kernel's schedule: its band, round and step, its
    stage ring (32 rows and the link row, slot 0 also past the last, and
    the link positions it holds) and its lanes' registers (one row a
    lane)."""

    def __init__(self, w: int):
        self.w, self.band, self.r = w, w, 0
        cols = MEA_CHUNK * (MEA_SLOTS + 1)
        self.stage = np.zeros((33, cols), np.float32)
        self.stage_pos = np.full(cols, -1, np.int64)
        self.start_band()

    def start_band(self):
        self.s = 0
        self.next_chunk = 0
        # columns -31 .. -1 (the last two slots) read as zeros
        ring_cols = MEA_CHUNK * MEA_SLOTS
        self.stage[:32, ring_cols - 2 * MEA_CHUNK:ring_cols] = 0.0
        self.cur = np.zeros(32, np.float32)
        self.oldj = np.zeros(32, np.float32)
        self.bits = np.zeros(32, np.int64)
        lanes = np.arange(32)
        self.jm = np.where(lanes == 0, 0, ring_cols - lanes)


def mea_dirs_wave_plain(post: torch.Tensor):
    """The kernel's schedule on the CPU (csrc/mea_dirs.cu), numpy: warps
    of 32 lanes taking bands round-robin, lane t of band k computing row
    32k + t's column s - t at band step s from lane t-1's values of the
    step before, on every step (zeros before its row starts and after it
    ends, so its last value is the score); lane 0 from the band above,
    the warp taking HAND columns at a time through warp w-1's ring
    inside a round (waiting while a slot holds another position) or the
    link row from the round before (each read checks that it has the
    position it wants: never read before written, never overwritten
    before read); the posterior through the stage ring's slots; the
    codes shifted into a word a lane, stored at its 16th column and,
    the last partial word, after the band. Every warp takes
    one step a tick when its waits allow (the ring's slots and
    back-pressure, the link's count at each chunk's staging); a tick
    where none can is a deadlock and raises. Returns (packed, scores) as
    mea_dirs_plain."""
    p = post.detach().cpu().numpy().astype(np.float32, copy=False)
    cc1, cc2 = p.shape
    nb = -(-cc1 // 32)
    nw = mea_warps(cc1)
    words = -(-cc2 // 16)
    ring_cols = MEA_CHUNK * MEA_SLOTS
    steps = cc2 + 31
    windows = -(-steps // MEA_CHUNK)
    packed = np.zeros((cc1, words), np.int64)
    scores = np.zeros(cc1, np.float32)
    ring = np.zeros((nw, MEA_RING), np.float32)
    ring_pos = np.full((nw, MEA_RING), -1, np.int64)
    taken = np.zeros(nw, np.int64)
    cc2r = -(-cc2 // MEA_CHUNK) * MEA_CHUNK
    link = np.zeros(cc2r, np.float32)
    link_pos = np.full(cc2r, -1, np.int64)
    link_count = [0]
    lanes = np.arange(32)
    kst = (lanes + MEA_CHUNK - 1) % MEA_CHUNK

    def stage_chunk(wp: _MeaWarp, c: int, link_in: bool, base: int) -> bool:
        """Chunk c into its slot (slot 0 also past the last), zeros past
        cc1 and cc2; False (nothing staged) while the link row's count is
        short of it."""
        col0 = c * MEA_CHUNK
        if (link_in and col0 < cc2
                and link_count[0] < base + min(col0 + MEA_CHUNK, cc2)):
            return False
        blk = np.zeros((32, MEA_CHUNK), np.float32)
        part = p[wp.band * 32:wp.band * 32 + 32, col0:col0 + MEA_CHUNK]
        blk[:part.shape[0], :part.shape[1]] = part
        slot = (c % MEA_SLOTS) * MEA_CHUNK
        for at in ((slot, ring_cols) if slot == 0 else (slot,)):
            wp.stage[:32, at:at + MEA_CHUNK] = blk
            if link_in and col0 < cc2:
                wp.stage[32, at:at + MEA_CHUNK] = link[col0:col0 + MEA_CHUNK]
                wp.stage_pos[at:at + MEA_CHUNK] = link_pos[col0:col0
                                                           + MEA_CHUNK]
        return True

    def step(wp: _MeaWarp) -> bool:
        """Band step s of warp wp; False when a wait holds it."""
        w, s, r = wp.w, wp.s, wp.r
        has_out = wp.band + 1 < nb
        ring_in, link_in = wp.band > 0 and w > 0, wp.band > 0 and w == 0
        ring_out, link_out = has_out and w < nw - 1, has_out and w == nw - 1
        in_base = (r if w > 0 else r - 1) * cc2
        out_base = r * cc2
        s0, k = s - s % MEA_CHUNK, s % MEA_CHUNK
        while wp.next_chunk <= s0 // MEA_CHUNK + MEA_AHEAD:
            if not stage_chunk(wp, wp.next_chunk, link_in, in_base):
                return False
            wp.next_chunk += 1
        kin = cc2 - 1 - s0
        jm0 = wp.jm[0]      # lane 0's column s0 in the stage ring
        n = max(0, min(MEA_HAND, kin - k + 1))
        if k % MEA_HAND == 0:
            # the band above's next n columns, all slots written, or wait
            want = in_base + s + np.arange(n)
            wp.hcol = np.zeros(MEA_HAND, np.float32)
            if ring_in and n:
                slot = want % MEA_RING
                if (ring_pos[w - 1, slot] != want).any():
                    return False
                wp.hcol[:n] = ring[w - 1, slot]
                taken[w - 1] = want[-1] + 1
            if link_in and n:
                at = jm0 + k + np.arange(n)
                if (wp.stage_pos[at] != want).any():
                    raise RuntimeError(f"mea_dirs schedule: band {wp.band} "
                                       f"wants link positions {want}, its "
                                       f"slots hold {wp.stage_pos[at]}")
                wp.hcol[:n] = wp.stage[32, at]
        j31 = s - 31
        pos = out_base + j31
        last31 = min(s + MEA_HAND - 1 - 31, cc2 - 1)
        if (ring_out and k % MEA_HAND == 0 and last31 >= 0
                and taken[w] < out_base + last31 + 1 - MEA_RING):
            return False            # lane 31 waits on the ring's room
        hin = wp.hcol[k % MEA_HAND]
        x = np.roll(wp.cur, 1)
        x[0] = hin
        b = wp.oldj + wp.stage[lanes, wp.jm + k]
        nw_ = np.maximum(wp.cur, np.maximum(b, x))
        d = np.where(b == nw_, 0, np.where(x == nw_, 1, 2))
        j = s - lanes
        wp.bits = np.where(j <= cc2 - 1, (wp.bits >> 2) | (d << 30), wp.bits)
        jw = s0 + kst - lanes
        rows = wp.band * 32 + lanes
        store = (k == kst) & (jw >= 0) & (jw < cc2) & (rows < cc1)
        packed[rows[store], jw[store] >> 4] = wp.bits[store]
        wp.cur = nw_.astype(np.float32)
        wp.oldj = x
        if 0 <= j31 < cc2:
            if ring_out:
                ring[w, pos % MEA_RING] = nw_[31]
                ring_pos[w, pos % MEA_RING] = pos
            if link_out:
                link[j31], link_pos[j31] = nw_[31], pos
        linked = min(max(s0 + MEA_CHUNK - 31, 0), cc2)
        if (link_out and k == MEA_CHUNK - 1 and linked > 0
                and ((s0 // MEA_CHUNK) % (MEA_LINK_HAND // MEA_CHUNK)
                     == MEA_LINK_HAND // MEA_CHUNK - 1
                     or (linked == cc2 and s0 - 31 < cc2))):
            link_count[0] = out_base + linked
        wp.s += 1
        if k == MEA_CHUNK - 1:
            wp.jm = (wp.jm + MEA_CHUNK) % ring_cols
        if wp.s == windows * MEA_CHUNK:
            real = rows < cc1
            scores[rows[real]] = wp.cur[real]
            if cc2 % 16:
                packed[rows[real], words - 1] = (
                    wp.bits[real] >> (2 * (16 - cc2 % 16)))
            wp.band += nw
            wp.r += 1
            wp.start_band()
        return True

    warps = [_MeaWarp(w) for w in range(nw)]
    while any(wp.band < nb for wp in warps):
        if not any([step(wp) for wp in warps if wp.band < nb]):
            raise RuntimeError("mea_dirs schedule: deadlock")
    return (_pack_words(packed),
            torch.from_numpy(scores).to(post.device))


def _pack_words(words: np.ndarray) -> torch.Tensor:
    """Unsigned 32-bit words as int32 (two's complement)."""
    return torch.from_numpy(
        np.where(words >= 2 ** 31, words - 2 ** 32, words).astype(np.int32))


def mea_dirs(post: torch.Tensor):
    """The MEA direction kernel on a CUDA posterior; the plain version
    on a CPU one. A hand-over that waited past MEA_WAIT_CYCLES flags the
    device (ops/wavefront.check_waits raises on it)."""
    if post.device.type == "cpu":
        return mea_dirs_plain(post)
    if post.device.type != "cuda":
        raise ValueError(f"unsupported device {post.device}")
    if (post.dtype != torch.float32 or post.dim() != 2
            or not post.is_contiguous()):
        raise ValueError("post: contiguous (cc1, cc2) float32")
    cc1, cc2 = post.shape
    if cc1 < 1 or cc2 < 1:
        raise ValueError(f"mea_dirs: {cc1} x {cc2} posterior out of range")
    from .wavefront import fault_flag
    w = -(-cc2 // 16)
    vec = cc2 % 4 == 0 and post.data_ptr() % 16 == 0
    packed = torch.empty((cc1, w), dtype=torch.int32, device=post.device)
    scores = torch.empty(cc1, dtype=torch.float32, device=post.device)
    # the link row (whole columns chunks) and its count
    link = torch.empty(-(-cc2 // MEA_CHUNK) * MEA_CHUNK + 4,
                       dtype=torch.float32, device=post.device)
    _launch("mea_dirs", post.data_ptr(), cc1, cc2, int(vec),
            MEA_WAIT_CYCLES, fault_flag(post.device).data_ptr(),
            link.data_ptr(), packed.data_ptr(), scores.data_ptr(),
            torch.cuda.current_stream(post.device).cuda_stream)
    return packed, scores
