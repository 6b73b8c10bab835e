"""Transitive alignment: extend member sequences into a centroid MSA.

Host copy of muscle_tpu.pipeline.transaln (reference:
src/transaln.cpp:1-750). Each fresh (member) sequence has a pairwise
X/Y/B path to the *ungapped* form of one MSA row; inserts relative to
the MSA are pooled per MSA column (max over members) and the MSA is
padded with all-gap columns to make room.

Path alphabets (reference comment block src/transaln.cpp:4-33):
  TPath1 {F,G,g,I}: fresh letters vs MSA columns + raw inserts
  TPath2 {F,G,g,I,i}: TPath1 padded to the expanded column count
  MPath  {M,i}: original MSA columns vs expanded columns
"""

from __future__ import annotations

import numpy as np

from ..sequence import MultiSequence, Sequence


def _msa_path(row: Sequence) -> str:
    return "".join("G" if c == "-" else "M" for c in row.text())


def make_tpath1(pw_path: str, msa_path: str) -> str:
    """reference: TransAln::MakeTPath1 (src/transaln.cpp:216-280).
    pw_path aligns fresh (X) to the ungapped MSA row (Y)."""
    out = []
    col = 0
    ncols = len(msa_path)
    for c in pw_path:
        if c in "BY":
            while msa_path[col] == "G":
                out.append("g")
                col += 1
        if c == "B":
            out.append("F")
            col += 1
        elif c == "X":
            out.append("I")
        elif c == "Y":
            out.append("G")
            col += 1
        else:
            raise ValueError(c)
    while col < ncols:
        assert msa_path[col] == "G"
        out.append("g")
        col += 1
    return "".join(out)


def _col_to_inserts(tpath1: str, ncols: int) -> np.ndarray:
    ins = np.zeros(ncols + 1, dtype=np.int64)
    col = 0
    for c in tpath1:
        if c == "I":
            ins[col] += 1
        else:
            col += 1
    assert col == ncols
    return ins


def make_tpath2(tpath1: str, col_inserts: np.ndarray,
                max_inserts: np.ndarray) -> str:
    """reference: TransAln::MakeTPath2 (src/transaln.cpp:417-474)."""
    out = []
    col = 0
    for c in tpath1:
        out.append(c)
        if c != "I":
            for _ in range(int(max_inserts[col] - col_inserts[col])):
                out.append("i")
            col += 1
    for _ in range(int(max_inserts[-1] - col_inserts[-1])):
        out.append("i")
    return "".join(out)


def make_mpath(max_inserts: np.ndarray, ncols: int) -> str:
    out = []
    for col in range(ncols + 1):
        out.append("i" * int(max_inserts[col]))
        if col < ncols:
            out.append("M")
    return "".join(out)


def make_extended_msa(msa: MultiSequence, fresh_seqs: list[Sequence],
                      fresh_to_msa_index: list[int],
                      pw_paths: list[str]) -> MultiSequence:
    """reference: TransAln::Init + MakeExtendedMSA."""
    ncols = msa.col_count()
    msa_paths = [_msa_path(s) for s in msa]

    tpaths1 = [make_tpath1(pw_paths[k], msa_paths[fresh_to_msa_index[k]])
               for k in range(len(fresh_seqs))]
    col_ins = [_col_to_inserts(t, ncols) for t in tpaths1]
    max_ins = (np.max(np.stack(col_ins), axis=0) if col_ins
               else np.zeros(ncols + 1, dtype=np.int64))

    mpath = make_mpath(max_ins, ncols)
    ext_cols = len(mpath)

    out = MultiSequence()
    # MSA rows through MPath
    for s in msa:
        data = s.bytes_view()
        row = np.full(ext_cols, ord("-"), dtype=np.uint8)
        mcol = 0
        for k, c in enumerate(mpath):
            if c == "M":
                row[k] = data[mcol]
                mcol += 1
        out.add(Sequence(s.label, row))
    # fresh rows through TPath2
    for k, f in enumerate(fresh_seqs):
        t2 = make_tpath2(tpaths1[k], col_ins[k], max_ins)
        assert len(t2) == ext_cols, (len(t2), ext_cols)
        data = f.bytes_view()
        row = np.full(ext_cols, ord("-"), dtype=np.uint8)
        pos = 0
        for c_i, c in enumerate(t2):
            if c in "FI":
                row[c_i] = data[pos]
                pos += 1
        assert pos == len(data)
        out.add(Sequence(f.label, row))
    return out
