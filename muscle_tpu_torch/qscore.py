"""PREFAB Q score and BAliBASE TC score (the accuracy oracle).

Host copy of muscle_tpu.qscore (numpy only).

O(NL) column-annotation algorithm (reference: src/qscore.cpp:10-260):
each reference-alignment position is annotated with the test-alignment
column holding the same letter; identical annotations within a reference
column are correctly aligned pairs. Only upper-case reference columns
count (BAliBASE core blocks); test letters must also be upper-case to
score.

Q  = correct letter pairs / reference aligned letter pairs
TC = fully-correct reference columns / reference aligned columns
"""

from __future__ import annotations

from .sequence import MultiSequence


def qscore(test: MultiSequence, ref: MultiSequence,
           by_sequence: bool = False) -> tuple[float, float]:
    ref_rows = [s.text() for s in ref]
    test_rows = [s.text() for s in test]
    ref_cols = len(ref_rows[0])
    n_ref = len(ref_rows)

    # map ref seq -> test seq (by label, or by ungapped sequence)
    if by_sequence:
        def ungap(t): return t.replace("-", "").replace(".", "").upper()
        ref_useq_to_index = {ungap(r): i for i, r in enumerate(ref_rows)}
        ref_to_test = [None] * n_ref
        for ti, t in enumerate(test_rows):
            i = ref_useq_to_index.get(ungap(t))
            if i is not None:
                ref_to_test[i] = ti
    else:
        name_to_ref = {s.label: i for i, s in enumerate(ref)}
        ref_to_test = [None] * n_ref
        for ti, s in enumerate(test):
            i = name_to_ref.get(s.label)
            if i is not None:
                ref_to_test[i] = ti
    found = sum(1 for v in ref_to_test if v is not None)
    if found < 2:
        raise ValueError(f"only {found} ref seqs found in test MSA")

    def isgap(c): return c in "-."

    test_col_index = [0] * len(test_rows)   # per test seq: cursor (1-based col)
    correct_pairs = 0
    ref_pairs = 0
    ref_aligned_cols = 0
    correct_cols = 0

    for rc in range(ref_cols):
        col_counts: dict[int, int] = {}
        nongapped = 0
        first_col = None
        ref_col_aligned = False
        all_correct = True
        all_aligned = True
        for ri in range(n_ref):
            ti = ref_to_test[ri]
            if ti is None:
                continue
            c_ref = ref_rows[ri][rc]
            if isgap(c_ref):
                continue
            # advance test cursor to the next letter
            col = test_col_index[ti]
            trow = test_rows[ti]
            while isgap(trow[col]):
                col += 1
            c_test = trow[col]
            col += 1  # one-based column of the letter
            if c_ref.isalpha() and c_ref.isupper():
                ref_col_aligned = True
                nongapped += 1
                if c_test.isupper():
                    col_counts[col] = col_counts.get(col, 0) + 1
                    if first_col is None:
                        first_col = col
                    elif first_col != col:
                        all_correct = False
                else:
                    all_aligned = False
            test_col_index[ti] = col

        if ref_col_aligned and nongapped > 1:
            ref_aligned_cols += 1
            if all_correct and all_aligned:
                correct_cols += 1

        for cnt in col_counts.values():
            correct_pairs += cnt * (cnt - 1) // 2
        ref_pairs += nongapped * (nongapped - 1) // 2

    q = correct_pairs / ref_pairs if ref_pairs else 0.0
    tc = correct_cols / ref_aligned_cols if ref_aligned_cols else 0.0
    return q, tc


def ref_letter_counts(test: MultiSequence, ref: MultiSequence):
    """Per-reference-letter correctness indicator: 1 where the letter's
    test column is the strict-majority test column of its reference
    column (reference: QScorer::UpdateRefLetterCounts
    src/qscorer.cpp:386-439 — BestTestCol requires count >
    TestLetterCount/2, src/qscorer.cpp:290-291). Sum these over an
    ensemble's replicates for per-letter confidence (-letterconf)."""
    import numpy as np

    ref_rows = [s.text() for s in ref]
    test_rows = [s.text() for s in test]
    ref_cols = len(ref_rows[0])
    n_ref = len(ref_rows)

    name_to_ref = {s.label: i for i, s in enumerate(ref)}
    ref_to_test = [None] * n_ref
    for ti, s in enumerate(test):
        i = name_to_ref.get(s.label)
        if i is not None:
            ref_to_test[i] = ti

    def isgap(c):
        return c in "-."

    out = np.zeros((n_ref, ref_cols), dtype=np.int64)
    cursor = [0] * len(test_rows)
    for rc in range(ref_cols):
        letters: list[tuple[int, int]] = []   # (ref seq, test col)
        for ri in range(n_ref):
            ti = ref_to_test[ri]
            if ti is None:
                continue
            c_ref = ref_rows[ri][rc]
            if isgap(c_ref):
                continue
            col = cursor[ti]
            trow = test_rows[ti]
            while isgap(trow[col]):
                col += 1
            cursor[ti] = col + 1
            # cmd_letterconf loads the ref without PreserveCase (all
            # upper), so case does not filter here
            if c_ref.isalpha():
                letters.append((ri, col))
        if not letters:
            continue
        counts: dict[int, int] = {}
        for _, col in letters:
            counts[col] = counts.get(col, 0) + 1
        best_col, best_n = max(counts.items(), key=lambda kv: kv[1])
        if best_n <= len(letters) // 2:
            continue   # no strict majority -> no letter counts
        for ri, col in letters:
            if col == best_col:
                out[ri, rc] = 1
    return out
