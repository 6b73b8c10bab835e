"""Device-side profile-pair alignment: refinement joins and PProg joins.

Torch port of muscle_tpu.pipeline.devjoin. The
reference's RefineIter (src/refineflat.cpp:4-31) re-aligns two random
halves of the MSA 100 times; each iteration's BuildPost
(src/buildpostflat.cpp:18-106) walks every (row in half 1, row in
half 2) sparse pair posterior. Here the (post-consistency) sparse store
stays on the device and each join is:

  1. the column posterior from a dual pair-index grid: for each row s
     of one half, the K-sparse rows of every pair (s, t) with columns
     mapped through t's pos->col map, summed over t (kernel 7,
     ops/devjoin_cuda.densify_reduce), then contracted with the one-hot
     of s's pos->col map (a plain f32 product, TF32 off):
         out = sum_s onehot(rmap_s)^T @ (sum_t densify(P_st, cmap_t));
     pairs stored the other way round run the same primitive with the
     roles swapped and are added as out2^T; pairs of the wrong
     orientation point at the store's all-zero dump row;
  2. the MEA direction DP (CalcAlnFlat semantics, Best3 tie order
     B >= X >= Y) over the summed posterior (ops/devjoin_cuda.mea_dirs),
     giving 2-bit direction codes packed 16 to an int32 and the row-end
     scores.

PProg's profile-profile joins (Super4/5) run the same two steps on a
LIST of sampled pairs instead of a grid (`align_sampled_device`): kernel
7L (ops/devjoin_cuda.densify_reduce_list) sums each sampled msa1 row's
pairs, each mapped through its own msa2 row's pos->col map.

Only the packed directions and one score leave the device; the
O(cc1 + cc2) traceback walk stays on the host. The grids are sized to
the real n1 x n2 rows and cc1, cc2 columns: the DP is a prefix
recurrence, so no padding is needed to keep its kept part.

Numerics: f32 summation order differs from the host CSR walk, so low
bits of the column posterior can differ; the tests hold the resulting
alignments (not the intermediate floats) to the host path's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import wavefront
from ..ops.consistency import _tf32_off
from ..ops.devjoin_cuda import densify_reduce, densify_reduce_list, mea_dirs
from ..sequence import MultiSequence

# bound on the f32 bytes of one wave of F rows plus their one-hot rows
_WAVE_BYTES = 1 << 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_rung(x: int, lo: int = 16) -> int:
    """Power-of-two padding rung of the JAX package's joiners (it pads
    row counts onto few compile shapes). The port sizes its tensors to
    the real counts; the rung survives in the memory guard below, which
    must decide as JAX does."""
    r = lo
    while r < x:
        r *= 2
    return r


def _cc_rung(x: int) -> int:
    """Column-count padding on the bucket ladder (the JAX package's; see
    _pow2_rung)."""
    from .posteriors import BUCKET_LADDER
    for b in BUCKET_LADDER:
        if b >= x:
            return b
    return _round_up(x, 1024)


class DeviceJoiner:
    """Per-family device joiner over a resident sparse store.

    pairs must be the canonical x-major (x < y) MPC pair list over n
    sequences; store row P1 - 1 (the last) must be the all-zero dump
    slot.
    """

    def __init__(self, store_v, store_c, pairs, n: int, max_nnz: int,
                 label_to_index: dict[str, int]):
        self.sv = store_v.contiguous()
        self.sc = store_c.contiguous()
        self.l = store_v.shape[1]
        self.k2 = min(store_v.shape[2], max(8, -(-int(max_nnz) // 8) * 8))
        self.l2i = label_to_index
        self.dump = store_v.shape[0] - 1
        pm = np.full((n, n), self.dump, np.int32)
        for i, (x, y) in enumerate(pairs):
            pm[x, y] = i
        self.pair_mx = pm

    def _maps(self, msa: MultiSequence):
        """(store indices (n,), pos->col bank (n, L) int32)."""
        idx = np.array([self.l2i[s.label] for s in msa], np.int64)
        bank = np.zeros((len(msa), self.l), np.int32)
        for i, s in enumerate(msa):
            p = s.pos_to_col()
            bank[i, :len(p)] = p
        return idx, bank

    def _half(self, pid: np.ndarray, rbank: np.ndarray, cbank: np.ndarray,
              cc_r: int, cc_c: int) -> torch.Tensor:
        """sum over (s, t) of the grid: onehot(rbank[s])^T @ F[s],
        (cc_r, cc_c) f32, in waves of row-owners bounding F's memory."""
        dev = self.sv.device
        cb = torch.as_tensor(cbank, device=dev)
        out = torch.zeros((cc_r, cc_c), dtype=torch.float32, device=dev)
        w = max(1, _WAVE_BYTES // (4 * self.l * (cc_r + cc_c)))
        for lo in range(0, pid.shape[0], w):
            f = densify_reduce(
                self.sv, self.sc, self.k2,
                torch.as_tensor(np.ascontiguousarray(pid[lo:lo + w]),
                                device=dev),
                cb, self.dump, cc_c)
            a = torch.nn.functional.one_hot(
                torch.as_tensor(rbank[lo:lo + w], device=dev).long(),
                cc_r).to(torch.float32)
            with _tf32_off():
                out += a.reshape(-1, cc_r).T @ f.reshape(-1, cc_c)
        return out

    def align(self, msa1: MultiSequence, msa2: MultiSequence
              ) -> tuple[float, str]:
        """(score, path) for aligning msa1 against msa2 — the device
        equivalent of progressive.align_alns' build_post + mea_align."""
        cc1 = msa1.col_count()
        cc2 = msa2.col_count()
        idx1, bank1 = self._maps(msa1)
        idx2, bank2 = self._maps(msa2)
        out = self._half(self.pair_mx[np.ix_(idx1, idx2)], bank1, bank2,
                         cc1, cc2)
        out2 = self._half(self.pair_mx[np.ix_(idx2, idx1)], bank2, bank1,
                          cc2, cc1)
        packed, scores = mea_dirs((out + out2.T).contiguous())
        score = float(scores[cc1 - 1])
        wavefront.check_waits(packed.device)   # raises on a stuck hand-over
        return score, _walk(packed.cpu().numpy(), cc1, cc2)


def _walk(packed: np.ndarray, cc1: int, cc2: int) -> str:
    """Unpack the 2-bit direction codes and trace the path (host;
    O(cc1 + cc2); the traversal of ops/mea.py's traceback)."""
    shifts = 2 * np.arange(16, dtype=np.int32)
    dirs = ((packed[:, :, None] >> shifts[None, None, :]) & 3
            ).reshape(cc1, -1)[:, :cc2]
    path = []
    i, j = cc1, cc2
    while i > 0 or j > 0:
        if i == 0:
            path.append("Y")
            j -= 1
        elif j == 0:
            path.append("X")
            i -= 1
        else:
            d = dirs[i - 1, j - 1]
            if d == 0:
                path.append("B")
                i -= 1
                j -= 1
            elif d == 1:
                path.append("X")
                i -= 1
            else:
                path.append("Y")
                j -= 1
    path.reverse()
    return "".join(path)


# memory guard of the list variant, decided on the JAX package's padded
# F (n1p, L, ccp) f32: beyond it PProg joins on the host instead
_LIST_F_BUDGET = 2 << 30


def align_sampled_device(store_v, store_c, sampled, msa1, msa2,
                         max_nnz: int, row_offset: int = 0):
    """(score, path) for a PProg profile-profile join from a device
    store of SAMPLED row pairs: store row row_offset + k holds the
    posterior of (msa1 row sampled[k][0], msa2 row sampled[k][1]) in
    that orientation (row_offset lets a grouped store serve several
    joins). Only packed 2-bit directions and one score leave the device.

    Returns None when the JAX package's padded accumulator would pass
    _LIST_F_BUDGET: that is its routing to the host CSR join, decided
    here on its padded sizes so that the port routes every join as it
    does. The port's own F is sized to the sampled rows and the real
    columns."""
    cc1 = msa1.col_count()
    cc2 = msa2.col_count()
    l = store_v.shape[1]
    k2 = min(store_v.shape[2], max(8, -(-int(max_nnz) // 8) * 8))
    ccp = _cc_rung(max(cc1, cc2, 16))

    # row-owners: the sampled msa1 rows, compacted; col-owners likewise
    rows1 = sorted({i for i, _ in sampled})
    rows2 = sorted({j for _, j in sampled})
    if _pow2_rung(len(rows1), 128) * l * ccp * 4 > _LIST_F_BUDGET:
        return None
    r1_of = {r: i for i, r in enumerate(rows1)}
    r2_of = {r: i for i, r in enumerate(rows2)}
    ro = np.array([r1_of[i] for i, _ in sampled], np.int64)
    # each owner's entries as one run, in sampled order within the run
    # (JAX's scatter-add order)
    order = np.argsort(ro, kind="stable")
    pid = (row_offset + order).astype(np.int32)
    co = np.array([r2_of[sampled[k][1]] for k in order], np.int32)
    row_ptr = np.zeros(len(rows1) + 1, np.int32)
    np.cumsum(np.bincount(ro, minlength=len(rows1)), out=row_ptr[1:])

    rbank = np.zeros((len(rows1), l), np.int32)
    for i, r in enumerate(rows1):
        p = msa1[r].pos_to_col()
        rbank[i, :len(p)] = p
    cbank = np.zeros((len(rows2), l), np.int32)
    for i, r in enumerate(rows2):
        p = msa2[r].pos_to_col()
        cbank[i, :len(p)] = p

    dev = store_v.device
    sv, sc = store_v.contiguous(), store_c.contiguous()
    dump = sv.shape[0] - 1
    rp = torch.as_tensor(row_ptr, device=dev)
    pid_t = torch.as_tensor(pid, device=dev)
    co_t = torch.as_tensor(co, device=dev)
    cb = torch.as_tensor(cbank, device=dev)
    post = torch.zeros((cc1, cc2), dtype=torch.float32, device=dev)
    w = max(1, _WAVE_BYTES // (4 * l * (cc1 + cc2)))
    for lo in range(0, len(rows1), w):
        hi = min(lo + w, len(rows1))
        f = densify_reduce_list(sv, sc, k2, rp[lo:hi + 1], pid_t, co_t, cb,
                                dump, cc2)
        a = torch.nn.functional.one_hot(
            torch.as_tensor(rbank[lo:hi], device=dev).long(),
            cc1).to(torch.float32)
        with _tf32_off():
            post += a.reshape(-1, cc1).T @ f.reshape(-1, cc2)
    packed, scores = mea_dirs(post)
    score = float(scores[cc1 - 1]) if cc1 else 0.0
    wavefront.check_waits(packed.device)       # raises on a stuck hand-over
    return score, _walk(packed.cpu().numpy(), cc1, cc2)
