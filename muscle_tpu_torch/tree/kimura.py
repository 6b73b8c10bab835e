"""Kimura protein distance from fractional identity.

Host copy of muscle_tpu.tree.kimura (numpy only).

reference: src/kimuradist.cpp — d = -ln(1 - p - p^2/5) for p < 0.75,
10.0 above 93% difference, and the ClustalW Dayhoff-PAM lookup table in
between (model data, reference src/kimuradist.cpp:25-50). Fractional
identity counts identical letters over columns where not both rows are
gaps (GetFractId src/kimuradist.cpp:74-95).
"""

from __future__ import annotations

import numpy as np

from ..sequence import MultiSequence

# PAM estimates for observed difference 75.0%..93.0% in 0.1% steps
# (ClustalW Dayhoff table; reference: src/kimuradist.cpp:25-50)
_DAYHOFF_PAMS = np.array([
    195, 196, 197, 198, 199, 200, 200, 201, 202, 203, 204, 205, 206, 207,
    208, 209, 209, 210, 211, 212, 213, 214, 215, 216, 217, 218, 219, 220,
    221, 222, 223, 224, 226, 227, 228, 229, 230, 231, 232, 233, 234, 236,
    237, 238, 239, 240, 241, 243, 244, 245, 246, 248, 249, 250, 252, 253,
    254, 255, 257, 258, 260, 261, 262, 264, 265, 267, 268, 270, 271, 273,
    274, 276, 277, 279, 281, 282, 284, 285, 287, 289, 291, 292, 294, 296,
    298, 299, 301, 303, 305, 307, 309, 311, 313, 315, 317, 319, 321, 323,
    325, 328, 330, 332, 335, 337, 339, 342, 344, 347, 349, 352, 354, 357,
    360, 362, 365, 368, 371, 374, 377, 380, 383, 386, 389, 393, 396, 399,
    403, 407, 410, 414, 418, 422, 426, 430, 434, 438, 442, 447, 451, 456,
    461, 466, 471, 476, 482, 487, 493, 498, 504, 511, 517, 524, 531, 538,
    545, 553, 560, 569, 577, 586, 595, 605, 615, 626, 637, 649, 661, 675,
    688, 703, 719, 736, 754, 775, 796, 819, 845, 874, 907, 945, 988,
], dtype=np.float64)


def kimura_dist(fract_id: float) -> float:
    p = 1.0 - fract_id
    if p < 0.75:
        return float(-np.log(1.0 - p - (p * p) / 5.0))
    if p > 0.93:
        return 10.0
    idx = int((p - 0.75) * 1000 + 0.5)
    idx = min(max(idx, 0), len(_DAYHOFF_PAMS) - 1)
    return float(_DAYHOFF_PAMS[idx]) / 100.0


def fract_id(row_i: np.ndarray, row_j: np.ndarray) -> float:
    """Identity over columns where not both rows are gaps."""
    gap_i = (row_i == ord("-")) | (row_i == ord("."))
    gap_j = (row_j == ord("-")) | (row_j == ord("."))
    keep = ~(gap_i & gap_j)
    n = int(keep.sum())
    if n == 0:
        return 0.0
    # case-insensitive compare
    a = row_i[keep] | 0x20
    b = row_j[keep] | 0x20
    return float((a == b).sum()) / n


def kimura_dist_mx(msa: MultiSequence) -> np.ndarray:
    """Pairwise Kimura distances over an aligned MSA
    (reference: GetKimuraDistMx src/kimuradist.cpp:138)."""
    mat = msa.to_matrix()
    n = len(msa)
    d = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(i):
            d[i, j] = d[j, i] = kimura_dist(fract_id(mat[i], mat[j]))
    return d
