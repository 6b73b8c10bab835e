"""Progressive profile alignment and iterative refinement.

Host-side join loop over the guide-tree join order. Each join builds
the column-space posterior for the two profiles from the (consistency-
transformed) pair posteriors and runs the MEA DP
(reference: MPCFlat::AlignAlns src/alnalnsflat.cpp:7-52,
MPCFlat::BuildPost src/buildpostflat.cpp:18-106,
MPCFlat::ProgressiveAlign src/progalnflat.cpp:41-100,
MPCFlat::RefineIter src/refineflat.cpp:4-31).

The N-1 joins are inherently serial (each consumes the previous result)
so they run on host; the accumulation over sequence pairs inside
build_post is numpy-vectorized scatter-adds.
"""

from __future__ import annotations

import numpy as np

from ..ops.mea import mea_align
from ..sequence import MultiSequence
from ..utils.rng import GlibcRand


class PairPosteriors:
    """Pair posterior store: (x, y) with x < y -> CSR sparse rows.

    Entries are (vals (nnz,) f32, cols (nnz,) int32, rowptr (Lx+1,)
    int64, ly) — the host mirror of the device fixed-K store, compacted
    to its true nnz (pipeline/posteriors.store_to_csr; the reference
    stores CSR too, src/mysparsemx.h:6-98). Dense (Lx, Ly) matrices and fixed-K rows
    are accepted by `set`/`set_sparse` and converted, so small callers
    keep working unchanged.
    """

    def __init__(self):
        self._d: dict[tuple[int, int], tuple] = {}

    def set(self, x: int, y: int, post: np.ndarray) -> None:
        """Store a dense (Lx, Ly) posterior (CSR-compacted; rows keep
        descending-probability order like the device sparsify)."""
        assert x < y
        lx, ly = post.shape
        order = np.argsort(-post, axis=1, kind="stable")
        taken = np.take_along_axis(post, order, axis=1)
        m = taken > 0
        rowptr = np.zeros(lx + 1, np.int64)
        np.cumsum(m.sum(axis=1), out=rowptr[1:])
        self._d[(x, y)] = (taken[m].astype(np.float32),
                           order[m].astype(np.int32), rowptr, ly)

    def set_sparse(self, x: int, y: int, vals: np.ndarray,
                   cols: np.ndarray, ly: int) -> None:
        """Store fixed-K rows (valid slots packed first, -1 = empty)."""
        assert x < y
        m = cols >= 0
        lx = vals.shape[0]
        rowptr = np.zeros(lx + 1, np.int64)
        np.cumsum(m.sum(axis=1), out=rowptr[1:])
        self._d[(x, y)] = (np.ascontiguousarray(vals[m], np.float32),
                           np.ascontiguousarray(cols[m], np.int32),
                           rowptr, ly)

    def set_csr(self, x: int, y: int, vals: np.ndarray, cols: np.ndarray,
                rowptr: np.ndarray, ly: int) -> None:
        assert x < y
        self._d[(x, y)] = (vals, cols, rowptr, ly)

    def get_csr(self, x: int, y: int):
        """(vals, cols, rowptr, ly, transposed) — transposed=True means
        the stored orientation is (y, x): entry (row i, col c) maps to
        output position (c, i)."""
        if x < y:
            v, c, r, ly = self._d[(x, y)]
            return v, c, r, ly, False
        v, c, r, ly = self._d[(y, x)]
        return v, c, r, ly, True

    def get(self, x: int, y: int) -> np.ndarray:
        """Dense posterior oriented (Lx rows, Ly cols) for any x != y."""
        v, c, r, ly, transposed = self.get_csr(x, y)
        lx = len(r) - 1
        d = np.zeros((lx, ly), np.float32)
        rows = np.repeat(np.arange(lx), np.diff(r))
        d[rows, c] = v
        return d.T if transposed else d


def _accumulate_csr_np(out, vals, cols, rowptr, p1, p2, transposed):
    """Numpy fallback for the native CSR accumulation."""
    lx = len(rowptr) - 1
    rows = np.repeat(np.arange(lx), np.diff(rowptr))
    if not transposed:
        np.add.at(out, (p1[rows], p2[cols]), vals)
    else:
        np.add.at(out, (p1[cols], p2[rows]), vals)


def build_post(msa1: MultiSequence, msa2: MultiSequence,
               label_to_index: dict[str, int],
               posts: PairPosteriors) -> np.ndarray:
    """Column-space posterior matrix for aligning msa1 to msa2.

    Post[c1, c2] = sum over rows s in msa1, t in msa2 of
    P(s_pos <-> t_pos) scattered through each row's pos->col map
    (reference: src/buildpostflat.cpp:18-106 — the reference also walks
    sparse posteriors here; weights are 1.0 as in src/mpcflat.cpp:316-326).
    """
    from ..native import build_post_accumulate_csr_native
    cc1 = msa1.col_count() if len(msa1[0]) else 0
    cc2 = msa2.col_count()
    out = np.zeros((cc1, cc2), dtype=np.float32)
    ptc2 = [s.pos_to_col() for s in msa2]
    idx2 = [label_to_index[s.label] for s in msa2]
    for s1 in msa1:
        i1 = label_to_index[s1.label]
        p1 = s1.pos_to_col()
        for s2, i2, p2 in zip(msa2, idx2, ptc2):
            vals, cols, rowptr, ly, transposed = posts.get_csr(i1, i2)
            if not build_post_accumulate_csr_native(
                    out, vals, cols, rowptr, p1, p2, transposed):
                _accumulate_csr_np(out, vals, cols, rowptr, p1, p2,
                                   transposed)
    return out


def join_by_path(msa1: MultiSequence, msa2: MultiSequence,
                 path: str) -> MultiSequence:
    out = MultiSequence()
    for s in msa1:
        out.add(s.add_gaps_path(path, "X"))
    for s in msa2:
        out.add(s.add_gaps_path(path, "Y"))
    return out


def align_alns(msa1: MultiSequence, msa2: MultiSequence,
               label_to_index: dict[str, int],
               posts: PairPosteriors) -> tuple[MultiSequence, float]:
    post = build_post(msa1, msa2, label_to_index, posts)
    score, path = mea_align(post)
    return join_by_path(msa1, msa2, path), score


def progressive_align(seqs: MultiSequence, idx1: list[int], idx2: list[int],
                      label_to_index: dict[str, int],
                      posts: PairPosteriors) -> MultiSequence:
    n = len(seqs)
    prog: list[MultiSequence | None] = [MultiSequence([s]) for s in seqs]
    for k in range(len(idx1)):
        m1 = prog[idx1[k]]
        m2 = prog[idx2[k]]
        joined, _ = align_alns(m1, m2, label_to_index, posts)
        prog.append(joined)
        prog[idx1[k]] = None
        prog[idx2[k]] = None
    assert len(prog) == 2 * n - 1
    return prog[-1]


def refine(msa: MultiSequence, iters: int,
           label_to_index: dict[str, int], posts: PairPosteriors,
           rng: GlibcRand | None = None, joiner=None) -> MultiSequence:
    """Random-bipartition refinement (reference: src/refineflat.cpp).

    The reference splits with libc rand()%2 (never seeded — glibc seed
    1); GlibcRand reproduces that stream. With `joiner` (a
    devjoin.DeviceJoiner over the family's resident sparse store) each
    join's column posterior and MEA direction DP run on the device and
    only the packed directions come back.
    """
    n = len(msa)
    if n < 3:
        return msa
    rng = rng or GlibcRand(1)
    for _ in range(iters):
        g1 = []
        g2 = []
        for i in range(n):
            (g1 if rng.rand() % 2 == 0 else g2).append(i)
        if not g1 or not g2:
            continue
        m1 = msa.project(g1)
        m2 = msa.project(g2)
        if joiner is not None:
            msa = join_by_path(m1, m2, joiner.align(m1, m2)[1])
        else:
            msa, _ = align_alns(m1, m2, label_to_index, posts)
    return msa
