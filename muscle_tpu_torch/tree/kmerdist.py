"""K-mer distance matrices for fast guide trees.

Host copy of muscle_tpu.tree.kmerdist (numpy only).

reference: src/kmerdist66.cpp (6-mers over a 6-letter amino grouping,
dict 6^6) and src/kmerdist33.cpp (3-mers over the 20-letter alphabet,
dict 20^3). Distance = min(3*(Cii-Cij)/Cii, 3*(Cjj-Cij)/Cjj) where C is
the common-kmer count (src/kmerdist66.cpp:76-79). Used by the classic
muscle3 path and available for quick tree estimation at scale.

Note the reference's k-mer window loop runs `i + 5 < L` for BOTH
variants (src/kmerdist33.cpp:17 reuses the 6-mer bound for 3-mers);
we reproduce that.
"""

from __future__ import annotations

import numpy as np

from ..sequence import MultiSequence

# 6-letter grouping (reference: src/alpha6.cpp:35; non-letters -> 0)
_GROUPS = {"A": 0, "G": 0, "P": 0, "S": 0, "T": 0,
           "I": 1, "L": 1, "M": 1, "V": 1,
           "D": 2, "E": 2, "N": 2, "Q": 2,
           "H": 3, "K": 3, "R": 3,
           "F": 4, "W": 4, "Y": 4,
           "C": 5}
CHAR_TO_GROUP = np.zeros(256, dtype=np.int64)
for _c, _g in _GROUPS.items():
    CHAR_TO_GROUP[ord(_c)] = _g
    CHAR_TO_GROUP[ord(_c.lower())] = _g

_CHAR_TO_AA = np.full(256, 20, dtype=np.int64)
for _i, _c in enumerate("ACDEFGHIKLMNPQRSTVWY"):
    _CHAR_TO_AA[ord(_c)] = _i
    _CHAR_TO_AA[ord(_c.lower())] = _i


def _count_kmers(codes: np.ndarray, k: int, powers: np.ndarray,
                 dict_size: int) -> np.ndarray:
    """uint8-saturating k-mer counts (reference uses byte counters).

    Words that encode >= dict_size are skipped — the reference's only
    wildcard filter (src/kmerdist33.cpp:20-21), which means wildcards in
    low-power positions alias into valid words; reproduced as-is.
    """
    L = len(codes)
    if L < 6:   # reference window bound: i + 5 < L (both variants)
        return np.zeros(dict_size, dtype=np.int64)
    n_windows = L - 5
    win = np.lib.stride_tricks.sliding_window_view(codes, k)[:n_windows]
    words = win @ powers
    words = words[words < dict_size]
    counts = np.bincount(words, minlength=dict_size)
    return np.minimum(counts, 255)


def _dist_from_counts(counts: list[np.ndarray]) -> np.ndarray:
    n = len(counts)
    self_common = np.array([int(np.minimum(c, c).sum()) for c in counts],
                           dtype=np.float64)
    d = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(i):
            cij = float(np.minimum(counts[i], counts[j]).sum())
            d1 = 3.0 * (self_common[i] - cij) / self_common[i]
            d2 = 3.0 * (self_common[j] - cij) / self_common[j]
            d[i, j] = d[j, i] = min(d1, d2)
    return d


def kmer_dist_66(seqs: MultiSequence) -> np.ndarray:
    # word = u6 + 6*u5 + ... + 6^5*u1 (src/kmerdist66.cpp:4-14)
    powers = 6 ** np.arange(5, -1, -1)
    counts = [_count_kmers(CHAR_TO_GROUP[s.bytes_view()], 6, powers, 6 ** 6)
              for s in seqs]
    return _dist_from_counts(counts)


def kmer_dist_33(seqs: MultiSequence) -> np.ndarray:
    # word = u1 + 20*u2 + 400*u3 (src/kmerdist33.cpp:5-12)
    powers = np.array([1, 20, 400])
    counts = [_count_kmers(_CHAR_TO_AA[s.bytes_view()], 3, powers, 20 ** 3)
              for s in seqs]
    return _dist_from_counts(counts)
