"""UClustPD — greedy centroid clustering by ML protein distance (torch
port of muscle_tpu.pipeline.uclustpd).

reference: src/uclustpd.cpp (UClustPD::Run / Search), src/protdistpair.cpp
(GetProtDistSeqPair = global Viterbi NW alignment -> PHYLIP ML distance,
GetProtDistMFAPair = sampled-pair average between two MFAs).

Per-iteration flow (reference src/uclustpd.cpp:153-250): scan pending
members in order, promoting each that matches none of this iteration's
new seeds (<= seeds_per_iter seeds per iteration — the reference uses
the thread count here, i.e. it is a batching knob, not semantics); then
assign every remaining pending member to its nearest new seed within
max_pd. Members that match nothing stay pending for the next iteration.

Every distance is a global-NW pair alignment: the DP runs on the device
in batches (ops/nw.nw_align_batch, kernel nw_viterbi on the card;
phase 2 batches the whole pending x new-seeds grid at once), the path
walk and the PHYLIP Newton iteration, vectorized over count matrices,
on the host (tree/protdist.py).
"""

from __future__ import annotations

import numpy as np

from ..ops.nw import nw_align_batch, path_match_pairs
from ..sequence import MultiSequence
from ..tree.protdist import (pair_counts_from_match_pairs,
                             prot_dists_from_counts)
from ..utils.device import resolve_device
from ..utils.rng import MwcRng
from .pprog import get_pairs

DEFAULT_MAX_PD_PASS1 = 1.5         # reference: src/super6.h:8
DEFAULT_SEEDS_PER_ITER = 16        # reference: thread count (uclustpd.cpp:193)
TARGET_PAIR_COUNT_CLUSTER_DIST = 8  # reference: src/super6.h:9


class ProtDistCalc:
    """Batched ML protein distances over a fixed sequence set; the NW DP
    runs on `device` (the card unless the CPU is asked for)."""

    def __init__(self, seqs, alpha: str = "amino", batch_size: int = 64,
                 device=None):
        from . import posteriors as post_mod
        if isinstance(seqs, MultiSequence):
            seqs = list(seqs)
        self.seqs = seqs
        self.batch_size = batch_size
        self.device = resolve_device(device)
        lmax = max((len(s) for s in seqs), default=1)
        self.codes, self.lens = post_mod.encode_batch(
            seqs, alpha, pad_to=post_mod.round_up(lmax, 128))

    def dists(self, pairs: list[tuple[int, int]]) -> np.ndarray:
        """(P,) ML distances for (i, j) sequence-index pairs."""
        if not pairs:
            return np.zeros(0)
        aligns = nw_align_batch(self.codes, self.lens, pairs,
                                batch_size=self.batch_size,
                                device=self.device)
        counts = np.stack([
            pair_counts_from_match_pairs(
                self.codes[i], self.codes[j], path_match_pairs(path))
            for (_, path), (i, j) in zip(aligns, pairs)])
        return prot_dists_from_counts(counts)

    def mfa_pair_dist(self, idx1: list[int], idx2: list[int],
                      target_pairs: int, rng: MwcRng) -> float:
        """Average distance over sampled cross pairs
        (reference: GetProtDistMFAPair src/protdistpair.cpp:51-77)."""
        sampled = get_pairs(len(idx1), len(idx2), target_pairs, rng)
        pairs = [(idx1[i], idx2[j]) for (i, j) in sampled]
        d = self.dists(pairs)
        return float(d.mean()) if len(d) else -1.0


class UClustPD:
    def __init__(self, calc: ProtDistCalc,
                 seeds_per_iter: int = DEFAULT_SEEDS_PER_ITER):
        self.calc = calc
        self.seeds_per_iter = max(1, seeds_per_iter)
        self.centroid_seq_indexes: list[int] = []
        self.members: list[list[int]] = []   # per centroid, subset indexes
        self.assign_dist: dict[int, float] = {}

    def _search(self, qi: int, seed_centroids: list[int],
                max_pd: float) -> tuple[int, float]:
        """Nearest centroid among seed_centroids within max_pd
        (reference: UClustPD::Search, d > MaxPD excluded; a -1 distance,
        no overlap or a divergent fit, passes `d <= max_pd` there too)."""
        if not seed_centroids:
            return -1, np.inf
        pairs = [(qi, self.centroid_seq_indexes[c]) for c in seed_centroids]
        d = self.calc.dists(pairs)
        ok = d <= max_pd
        if not ok.any():
            return -1, np.inf
        k = int(np.argmin(np.where(ok, d, np.inf)))
        return seed_centroids[k], float(d[k])

    def run(self, seq_indexes: list[int], max_pd: float) -> list[list[int]]:
        """Greedy clustering; returns per-cluster lists of positions
        into seq_indexes (centroid first, members in assignment order)."""
        n = len(seq_indexes)
        pending = list(range(n))
        while pending:
            # phase 1: promote new seeds, scanning pending in order
            new_seeds: list[int] = []
            done: set[int] = set()
            for si in pending:
                qi = seq_indexes[si]
                c, _ = self._search(qi, new_seeds, max_pd)
                if c == -1:
                    c_new = len(self.centroid_seq_indexes)
                    self.centroid_seq_indexes.append(qi)
                    self.members.append([si])
                    self.assign_dist[si] = 0.0
                    new_seeds.append(c_new)
                    done.add(si)
                if len(new_seeds) >= self.seeds_per_iter:
                    break
            assert new_seeds
            pending = [p for p in pending if p not in done]
            if not pending:
                break

            # phase 2: one batched pending x new-seeds distance grid
            grid_pairs = [(seq_indexes[si], self.centroid_seq_indexes[c])
                          for si in pending for c in new_seeds]
            d = self.calc.dists(grid_pairs).reshape(len(pending),
                                                    len(new_seeds))
            ok = d <= max_pd
            still: list[int] = []
            for r, si in enumerate(pending):
                if ok[r].any():
                    k = int(np.argmin(np.where(ok[r], d[r], np.inf)))
                    c = new_seeds[k]
                    self.members[c].append(si)
                    self.assign_dist[si] = float(d[r, k])
                else:
                    still.append(si)
            # phase 1 took at least one seed out of pending, so the loop
            # ends even when no member joins this iteration's seeds (the
            # JAX package asserts that one does, and stops there)
            pending = still
        return list(self.members)
