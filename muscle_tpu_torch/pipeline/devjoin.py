"""Device-side profile-pair alignment for refinement iterations.

Torch port of muscle_tpu.pipeline.devjoin (the grid joiner). The
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

from ..ops.consistency import _tf32_off
from ..ops.devjoin_cuda import densify_reduce, mea_dirs
from ..sequence import MultiSequence

# bound on the f32 bytes of one wave of F rows plus their one-hot rows
_WAVE_BYTES = 1 << 30


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
