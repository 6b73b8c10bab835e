"""UPGMA5 clustering with the reference's exact tie-breaking.

O(N^2) agglomerative clustering with nearest-neighbor caching
(reference: src/upgma5.cpp:87-345). Linkage "biased" =
0.1*avg + 0.9*min (src/upgma5.cpp:241-243) is the MPC default.
Includes the reference's "nasty special case" NN-repair and its
first-minimum-wins scan order so guide trees match the reference
run-for-run.

This is host combinatorics: O(N^2) scalar work, negligible next to the
O(N^2 L^2) device DP. Inner loops are numpy-vectorized.
"""

from __future__ import annotations

import numpy as np

from .tree import Tree

LINKAGE_MIN = "min"
LINKAGE_MAX = "max"
LINKAGE_AVG = "avg"
LINKAGE_BIASED = "biased"


def fix_ea_distmx(distmx: np.ndarray) -> np.ndarray:
    """Similarity (EA in [0,1]) -> distance 1-EA, zero diagonal
    (reference: src/upgma5.cpp:504-519 FixEADistMx)."""
    d = np.asarray(distmx, dtype=np.float32).copy()
    d = 1.0 - d
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float32)


def read_distmx_reseek(path: str) -> tuple[list[str], np.ndarray]:
    """Reseek distmx format (reference: UPGMA5::ReadDistMx2,
    src/upgma5.cpp:~430): header `distmx\\tN`, N label lines, then
    `i\\tj\\tdist` pairs; missing pairs default to 0."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    hdr = lines[0].split("\t")
    assert hdr[0] == "distmx"
    n = int(hdr[1])
    labels = []
    for k in range(n):
        flds = lines[1 + k].split("\t")
        assert int(flds[0]) == k
        labels.append(flds[1])
    d = np.zeros((n, n), dtype=np.float32)
    for ln in lines[1 + n:]:
        flds = ln.split("\t")
        i, j = int(flds[0]), int(flds[1])
        if i == j:
            continue
        d[i, j] = d[j, i] = np.float32(float(flds[2]))
    return labels, d


def scale_dist_mx(d: np.ndarray, input_is_similarity: bool = True
                  ) -> np.ndarray:
    """Rescale to [0, 10] (reference: UPGMA5::ScaleDistMx,
    src/upgma5.cpp:521): similarity s -> 10*(max-s)/(max-min)."""
    d = np.asarray(d, dtype=np.float32).copy()
    n = d.shape[0]
    iu = np.triu_indices(n, 1)
    lo, hi = float(d[iu].min()), float(d[iu].max())
    scale = 10.0
    if hi == lo:
        out = np.zeros_like(d)
    elif input_is_similarity:
        out = scale * (hi - d) / (hi - lo)
    else:
        out = scale * (d - lo) / (hi - lo)
    np.fill_diagonal(out, 0.0)
    return out.astype(np.float32)


def upgma5(labels: list[str], distmx: np.ndarray,
           linkage: str = LINKAGE_BIASED) -> Tree:
    n = len(labels)
    if n == 1:
        raise ValueError("need >= 2 leaves")
    d = np.array(distmx, dtype=np.float32)
    assert d.shape == (n, n)
    # negative distances clamp to 0 (src/upgma5.cpp:141-146)
    d = np.maximum(d, 0.0)

    INF = np.float32(np.inf)
    # dist[i, j] over live rows; use full symmetric matrix for numpy ease
    dist = d.copy()
    np.fill_diagonal(dist, INF)

    node_index = np.arange(n, dtype=np.int64)   # row -> node id, -1 = dead
    alive = np.ones(n, dtype=bool)

    # initial nearest neighbors: scan order i=1..N-1, j<i with strict <
    min_dist = np.full(n, INF, dtype=np.float32)
    nearest = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        row = d[i, :i]
        j = int(np.argmin(row))        # first min wins (strict <)
        if row[j] < min_dist[i]:
            min_dist[i] = row[j]
            nearest[i] = j
        # update columns: d < MinDist[j] scanned in i ascending
        upd = row < min_dist[:i]
        min_dist[:i][upd] = row[upd]
        nearest[:i][upd] = i

    lefts = np.zeros(n - 1, dtype=np.int64)
    rights = np.zeros(n - 1, dtype=np.int64)
    left_len = np.zeros(n - 1, dtype=np.float32)
    right_len = np.zeros(n - 1, dtype=np.float32)
    height = np.zeros(n - 1, dtype=np.float32)

    for it in range(n - 1):
        # find global nearest pair: first row with strictly smallest MinDist
        md = np.where(alive, min_dist, INF)
        lmin = int(np.argmin(md))
        rmin = int(nearest[lmin])
        dlr = dist[lmin, rmin]

        # distances to the new node (overwrites row lmin)
        others = alive.copy()
        others[lmin] = False
        others[rmin] = False
        dl = dist[lmin, others]
        dr = dist[rmin, others]
        if linkage == LINKAGE_AVG:
            dnew = (dl + dr) / 2
        elif linkage == LINKAGE_MIN:
            dnew = np.minimum(dl, dr)
        elif linkage == LINKAGE_MAX:
            dnew = np.maximum(dl, dr)
        elif linkage == LINKAGE_BIASED:
            dnew = np.float32(0.1) * ((dl + dr) / 2) + np.float32(0.9) * np.minimum(dl, dr)
        else:
            raise ValueError(linkage)
        dnew = dnew.astype(np.float32)

        # nasty special case: rows whose NN was rmin now point at lmin
        # (src/upgma5.cpp:249-261)
        repair = others & (nearest == rmin)
        nearest[repair] = lmin

        dist[lmin, others] = dnew
        dist[others, lmin] = dnew

        # new node bookkeeping
        ul = int(node_index[lmin])
        ur = int(node_index[rmin])
        hnew = dlr / 2
        hl = 0.0 if ul < n else height[ul - n]
        hr = 0.0 if ur < n else height[ur - n]
        lefts[it] = ul
        rights[it] = ur
        left_len[it] = hnew - hl
        right_len[it] = hnew - hr
        height[it] = hnew

        node_index[lmin] = n + it
        alive[rmin] = False
        node_index[rmin] = -1
        dist[rmin, :] = INF
        dist[:, rmin] = INF

        # NN of the new row: first min among live others (scan ascending)
        if others.any():
            cand = np.where(others, dist[lmin], INF)
            j = int(np.argmin(cand))
            nearest[lmin] = j
            min_dist[lmin] = cand[j]
        else:
            min_dist[lmin] = INF

        # rows whose cached NN is lmin keep it; cached min_dist for rows
        # pointing at lmin may now be stale-high only if dnew < old — the
        # reference does NOT update those caches either (distances only
        # shrink via min linkage cases; matches reference behavior since
        # we replicate its exact cache policy: no update)
        min_dist[rmin] = INF

    return Tree.from_joins(labels, lefts, rights, left_len, right_len)
