"""Maximum-expected-accuracy alignment DP with traceback.

Equivalent of the reference's CalcAlnFlat + TraceBackFlat (reference:
src/calcalnflat.cpp:6-46, src/tracebackflat.cpp:3-38, src/best3.h).

The DP itself is a running max per row (see ops/pairhmm._mea_score for
the device score-only version used for EA distances). The full version
here also produces the alignment path; it runs on host in numpy: the
progressive-join and refinement stages call it once per join on profile
posteriors accumulated on the host (pipeline/progressive.py). Rows are vectorized (np.maximum.accumulate); only the
O(LX+LY) traceback walk is scalar.

Tie-breaking follows Best3's preference order B >= X >= Y exactly so
paths match the reference.
"""

from __future__ import annotations

import numpy as np


def mea_align(post: np.ndarray) -> tuple[float, str]:
    """Align via the posterior matrix; returns (score, path).

    post: (LX, LY) float32. Path chars: 'B' (match), 'X' (gap in Y),
    'Y' (gap in X), traced from (LX, LY) back to (0, 0).

    Uses the native C++ kernel when available (muscle_tpu_torch/native),
    falling back to the vectorized numpy rows below.
    """
    from ..native import mea_align_native
    r = mea_align_native(post)
    if r is not None:
        return r

    LX, LY = post.shape
    post = np.ascontiguousarray(post, dtype=np.float32)

    old = np.zeros(LY + 1, dtype=np.float32)
    # direction rows; row 0 and column 0 are implicit ('Y' / 'X')
    tb = np.empty((LX, LY), dtype=np.uint8)
    B_, X_, Y_ = 0, 1, 2

    for i in range(LX):
        b = old[:-1] + post[i]          # diag candidates, j = 1..LY
        x = old[1:]                      # up candidates
        e = np.maximum(b, x)
        new = np.maximum.accumulate(np.concatenate(([np.float32(0)], e)))
        y = new[:-1]                     # left candidates = final values shifted
        # Best3 order: B if B >= X and B >= Y; else X if X >= Y; else Y
        row = np.where((b >= x) & (b >= y), B_, np.where(x >= y, X_, Y_))
        tb[i] = row
        old = new

    score = float(old[LY])

    # traceback (reference: src/tracebackflat.cpp:3-38)
    path = []
    i, j = LX, LY
    while i > 0 or j > 0:
        if i == 0:
            path.append("Y")
            j -= 1
        elif j == 0:
            path.append("X")
            i -= 1
        else:
            d = tb[i - 1, j - 1]
            if d == B_:
                path.append("B")
                i -= 1
                j -= 1
            elif d == X_:
                path.append("X")
                i -= 1
            else:
                path.append("Y")
                j -= 1
    path.reverse()
    return score, "".join(path)


def mea_score_host(post: np.ndarray) -> float:
    """Score-only variant (reference: src/calcalnscoreflat.cpp:4-32)."""
    LX, LY = post.shape
    old = np.zeros(LY + 1, dtype=np.float32)
    for i in range(LX):
        e = np.maximum(old[:-1] + post[i], old[1:])
        old = np.maximum.accumulate(np.concatenate(([np.float32(0)], e)))
    return float(old[LY])
