"""MSA editing/statistics utilities.

Host copy of muscle_tpu.msatools (numpy only).

reference equivalents: src/stripgappycols.cpp, src/stripgappyrows.cpp,
src/relabel.cpp, src/trimtoref.cpp, src/make_a2m.cpp,
src/cmd_squeeze_inserts.cpp, src/core_blocks.cpp.
Host numpy column/row transforms over the aligned matrix.
"""

from __future__ import annotations

import numpy as np

from .sequence import MultiSequence, Sequence

_GAP = ord("-")
_DOT = ord(".")


def _gap_mask(mat: np.ndarray) -> np.ndarray:
    return (mat == _GAP) | (mat == _DOT)


def strip_gappy_cols(msa: MultiSequence, max_gap_fract: float = 0.5
                     ) -> MultiSequence:
    """Drop columns with gap fraction > max_gap_fract
    (reference: -strip_gappy_cols)."""
    mat = msa.to_matrix()
    keep = _gap_mask(mat).mean(axis=0) <= max_gap_fract
    return MultiSequence([Sequence(s.label, mat[i][keep])
                          for i, s in enumerate(msa)])


def strip_gappy_rows(msa: MultiSequence, max_gap_fract: float = 0.5
                     ) -> MultiSequence:
    """Drop rows with gap fraction > max_gap_fract
    (reference: -strip_gappy_rows)."""
    mat = msa.to_matrix()
    keep = _gap_mask(mat).mean(axis=1) <= max_gap_fract
    return MultiSequence([s for i, s in enumerate(msa) if keep[i]])


def relabel(msa: MultiSequence, mapping: dict[str, str],
            require_all: bool = False) -> MultiSequence:
    """Rename rows via old->new label map (reference: -relabel)."""
    out = MultiSequence()
    for s in msa:
        new = mapping.get(s.label)
        if new is None:
            if require_all:
                raise KeyError(f"label not in map: {s.label!r}")
            new = s.label
        out.add(Sequence(new, s.bytes_view()))
    return out


def trim_to_ref(test: MultiSequence, ref: MultiSequence) -> MultiSequence:
    """Keep only test rows whose labels appear in ref, then drop all-gap
    columns (reference: TrimToRef src/trimtoref.cpp:41)."""
    ref_labels = {s.label for s in ref}
    idx = [i for i, s in enumerate(test) if s.label in ref_labels]
    if not idx:
        raise ValueError("no test labels found in ref")
    return test.project(idx)


def make_a2m(msa: MultiSequence, max_gap_fract: float = 0.5
             ) -> MultiSequence:
    """A2M format: match columns (gap fract <= threshold) upper-case with
    '-' gaps; insert columns lower-case with gaps removed per row
    (reference: -make_a2m src/make_a2m.cpp)."""
    mat = msa.to_matrix()
    is_match = _gap_mask(mat).mean(axis=0) <= max_gap_fract
    out = MultiSequence()
    for i, s in enumerate(msa):
        row = []
        for c in range(mat.shape[1]):
            ch = chr(mat[i, c])
            if is_match[c]:
                row.append(ch.upper() if ch not in "-." else "-")
            else:
                if ch not in "-.":
                    row.append(ch.lower())
        out.add(Sequence(s.label, "".join(row)))
    return out


def squeeze_inserts(msa: MultiSequence, max_gap_fract: float = 0.5
                    ) -> MultiSequence:
    """Left-compact the letters inside runs of gappy (insert) columns so
    inserts pack together, dropping columns that become all-gap
    (reference: -squeeze_inserts)."""
    mat = msa.to_matrix().copy()
    n, cols = mat.shape
    gappy = _gap_mask(mat).mean(axis=0) > max_gap_fract
    c = 0
    while c < cols:
        if not gappy[c]:
            c += 1
            continue
        d = c
        while d < cols and gappy[d]:
            d += 1
        # pack letters of each row to the left of the [c, d) run
        for i in range(n):
            seg = mat[i, c:d]
            letters = seg[~_gap_mask(seg)]
            seg[:] = _GAP
            seg[:len(letters)] = letters
        c = d
    keep = ~np.all(_gap_mask(mat), axis=0)
    return MultiSequence([Sequence(s.label, mat[i][keep])
                          for i, s in enumerate(msa)])


def core_blocks(msa: MultiSequence, min_cols: int = 8, min_seqs: int = 8
                ) -> list[tuple[int, int, int, int]]:
    """Greedy maximal ungapped rectangles (lo_col, n_cols, lo_seq,
    n_seqs) (reference: -core_blocks src/core_blocks.cpp). Simplified
    greedy: repeatedly take the widest run of columns ungapped in the
    most rows, mask, repeat."""
    mat = msa.to_matrix()
    ungapped = ~_gap_mask(mat)
    n, cols = ungapped.shape
    avail = ungapped.copy()
    blocks = []
    while True:
        best = None
        # for each column window start, grow while enough rows stay ungapped
        col_counts = avail.sum(axis=0)
        order = np.argsort(-col_counts)
        for c0 in order[:32]:
            rows = avail[:, c0].copy()
            if rows.sum() < min_seqs:
                continue
            c1 = c0
            while c1 + 1 < cols:
                nrows = rows & avail[:, c1 + 1]
                if nrows.sum() < min_seqs:
                    break
                rows = nrows
                c1 += 1
            w = c1 - c0 + 1
            if w >= min_cols:
                area = w * int(rows.sum())
                if best is None or area > best[0]:
                    best = (area, int(c0), w, rows.copy())
        if best is None:
            break
        _, c0, w, rows = best
        ridx = np.flatnonzero(rows)
        blocks.append((c0, w, int(ridx[0]), len(ridx)))
        avail[np.ix_(ridx, range(c0, c0 + w))] = False
    return blocks
