"""Greedy length-sorted centroid clustering (UCLUST) with a k-mer
candidate index.

Host copy of muscle_tpu.pipeline.uclust (reference: src/usorter.{h,cpp}
— 3-mer amino / 8-mer nucleo index, top-candidate search with the
TopCount/2-1 threshold —, src/uclust.cpp:26-122 — greedy pass,
MAX_REJECTS=8, descending length order —, src/eacluster.cpp — the
EA-threshold variant used by Super4).

The index proposes a handful of candidate centroids per query; the
expensive accept test (the pair-HMM EA) runs batched through
PairAligner. The waves are kept as the JAX package has them, so every
EA call carries the same pair list as its call there (the pair list
decides the length buckets, and so the numbers).
"""

from __future__ import annotations

import numpy as np

from ..alphabet import alphabet_size, encode
from ..sequence import MultiSequence
from .pairwise import PairAligner

MAX_REJECTS = 8      # reference: src/uclust.h:7


class KmerIndex:
    """reference: USorter. Words over the strict alphabet; any wildcard
    in the window kills the word.

    `rows[word]` holds the index numbers of the sequences containing the
    word, each once, as an int array: a search is then one bincount over
    the query's words. Every occurrence of a word in the query adds one
    to each indexed sequence that contains it, as the JAX package counts
    (its `counts[row] += 1` adds once per distinct index)."""

    def __init__(self, alpha: str):
        self.alpha = alpha
        k = alphabet_size(alpha)
        self.word_len = 3 if k == 20 else 8
        self.base = k
        self.dict_size = k ** self.word_len
        self.rows: dict[int, np.ndarray] = {}
        self.index_seq_indexes: list[int] = []

    def _words(self, codes: np.ndarray) -> np.ndarray:
        L = len(codes)
        w = self.word_len
        if L < w:
            return np.zeros(0, dtype=np.int64)
        windows = np.lib.stride_tricks.sliding_window_view(codes, w)
        valid = (windows < self.base).all(axis=1)
        powers = self.base ** np.arange(w - 1, -1, -1, dtype=np.int64)
        words = windows.astype(np.int64) @ powers
        return words[valid]

    def add(self, codes: np.ndarray, seq_index: int) -> None:
        if len(codes) < self.word_len:
            return
        idx = len(self.index_seq_indexes)
        for word in np.unique(self._words(codes)).tolist():
            row = self.rows.get(word)
            self.rows[word] = (np.array([idx]) if row is None
                               else np.append(row, idx))
        self.index_seq_indexes.append(seq_index)

    def search(self, codes: np.ndarray) -> list[tuple[int, int]]:
        """Top candidate (seq_index, shared_word_count) list, sorted by
        count descending, cut at TopCount/2 - 1 as in USorter::SearchSeq."""
        n = len(self.index_seq_indexes)
        if n == 0 or len(codes) < self.word_len:
            return []
        hits = [r for r in map(self.rows.get, self._words(codes).tolist())
                if r is not None]
        counts = (np.bincount(np.concatenate(hits), minlength=n) if hits
                  else np.zeros(n, dtype=np.int64))
        order = np.argsort(-counts, kind="stable")
        top = int(counts[order[0]])
        if top <= 1:
            # reference quirk: MinU = Top/2 - 1 in unsigned arithmetic
            # underflows for Top < 2, so nothing qualifies
            return []
        min_u = max(top // 2 - 1, 1)
        out = []
        for i in order:
            c = int(counts[i])
            if c < min_u:
                break
            out.append((self.index_seq_indexes[i], c))
        return out


class UClust:
    """Greedy clustering storing member->centroid paths
    (reference: src/uclust.cpp).

    Queries are processed in *waves*: a wave's candidate sets are
    speculated from the current index, all (query, candidate) EA
    verifications run as one batch, then queries finalize in order on
    the host. A query whose re-searched candidate list (it may now
    include centroids created earlier in the same wave) contains
    unverified candidates is deferred to the head of the next wave — so
    every accept decision is made against exactly the index state the
    reference's serial loop would see (first candidate in index order
    with EA >= minEA). Member->centroid paths are computed afterwards in
    batched sparse-posterior passes.
    """

    def __init__(self, aligner: PairAligner, alpha: str,
                 wave_size: int = 256):
        self.aligner = aligner
        self.alpha = alpha
        self.wave_size = wave_size

    def run(self, seqs: MultiSequence, min_ea: float):
        n = len(seqs)
        index = KmerIndex(self.alpha)
        codes = [encode(s.bytes_view(), self.alpha) for s in seqs]
        lengths = np.array([len(s) for s in seqs])
        # descending length, ties by input order (reference:
        # GetLengthOrder yields descending; stable on ties)
        order = [int(i) for i in np.argsort(-lengths, kind="stable")]

        centroid_indexes: list[int] = []
        seq_to_centroid = np.full(n, -1, dtype=np.int64)
        seq_to_path: list[str] = [""] * n
        ea_cache: dict[tuple[int, int], float] = {}

        from ..utils import logging as mlog
        queue = order
        while queue:
            wave, queue = queue[:self.wave_size], queue[self.wave_size:]
            mlog.log("UCLUST wave: %d queued (of %d), %d centroids",
                     len(queue) + len(wave), n, len(centroid_indexes))
            # speculate candidates from the current index; verify every
            # unknown (query, candidate) EA in one batch
            spec = {si: [c for c, _ in index.search(codes[si])][:MAX_REJECTS]
                    for si in wave}
            need = [(si, c) for si in wave for c in spec[si]
                    if (si, c) not in ea_cache]
            if need:
                for (si, c), ea in zip(need, self.aligner.ea(need)):
                    ea_cache[(si, c)] = float(ea)

            added_in_wave = False
            deferred: list[int] = []
            for si in wave:
                if added_in_wave:
                    # index changed during this wave: re-search; any
                    # unverified candidate defers the query
                    cands = [c for c, _ in
                             index.search(codes[si])][:MAX_REJECTS]
                else:
                    cands = spec[si]
                if any((si, c) not in ea_cache for c in cands):
                    deferred.append(si)
                    continue
                rep = -1
                for c in cands:
                    if ea_cache[(si, c)] >= min_ea:
                        rep = c
                        break
                if rep < 0:
                    centroid_indexes.append(si)
                    index.add(codes[si], si)
                    seq_to_centroid[si] = si
                    added_in_wave = True
                else:
                    seq_to_centroid[si] = rep
            queue = deferred + queue

        # member->centroid paths, a wave of pairs per call
        members = [si for si in range(n)
                   if seq_to_centroid[si] >= 0 and seq_to_centroid[si] != si]
        for lo in range(0, len(members), self.wave_size):
            chunk = members[lo:lo + self.wave_size]
            mpairs = [(si, int(seq_to_centroid[si])) for si in chunk]
            for si, (_, path) in zip(chunk,
                                     self.aligner.align_pairs(mpairs)):
                seq_to_path[si] = path
        self.centroid_indexes = centroid_indexes
        self.seq_to_centroid = seq_to_centroid
        self.seq_to_path = seq_to_path
        return centroid_indexes, seq_to_centroid, seq_to_path


class EACluster:
    """Best-centroid EA clustering (reference: src/eacluster.cpp).

    Unlike UClust this keeps *clusters of sequences* (no member paths)
    and picks the best-scoring centroid above the threshold; candidates
    are verified as one batch.
    """

    def __init__(self, aligner: PairAligner, alpha: str,
                 wave_size: int = 256):
        self.aligner = aligner
        self.alpha = alpha
        self.wave_size = wave_size

    def run(self, seq_indexes: list[int], all_seqs: MultiSequence,
            min_ea: float) -> list[list[int]]:
        index = KmerIndex(self.alpha)
        codes = {i: encode(all_seqs[i].bytes_view(), self.alpha)
                 for i in seq_indexes}
        clusters: list[list[int]] = []
        centroid_of: dict[int, int] = {}   # seq index -> cluster index
        ea_cache: dict[tuple[int, int], float] = {}

        queue = list(seq_indexes)
        while queue:
            wave, queue = queue[:self.wave_size], queue[self.wave_size:]
            spec = {si: [c for c, _ in index.search(codes[si])]
                    for si in wave}
            need = [(si, c) for si in wave for c in spec[si]
                    if (si, c) not in ea_cache]
            if need:
                for (si, c), ea in zip(need, self.aligner.ea(need)):
                    ea_cache[(si, c)] = float(ea)

            added_in_wave = False
            deferred: list[int] = []
            for si in wave:
                cands = ([c for c, _ in index.search(codes[si])]
                         if added_in_wave else spec[si])
                if any((si, c) not in ea_cache for c in cands):
                    deferred.append(si)
                    continue
                best_ci = -1
                best_ea = min_ea
                for c in cands:
                    if ea_cache[(si, c)] > best_ea:
                        best_ea = ea_cache[(si, c)]
                        best_ci = centroid_of[c]
                if best_ci < 0:
                    centroid_of[si] = len(clusters)
                    clusters.append([si])
                    index.add(codes[si], si)
                    added_in_wave = True
                else:
                    clusters[best_ci].append(si)
            queue = deferred + queue
        return clusters
