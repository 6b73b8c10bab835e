"""Sequence and MultiSequence data model + FASTA/EFA I/O.

Equivalent capability to the reference data layer (reference:
src/sequence.{h,cpp}, src/multisequence.{h,cpp}, src/fasta.cpp), but
numpy-backed: a Sequence stores its residues as an immutable np.uint8
array so host<->device encoding is a single table gather and gap ops are
vectorized.
"""

from __future__ import annotations

import io as _io
import numpy as np

_GAP = ord("-")
_DOT = ord(".")

FASTA_ROWLEN = 80  # reference: src/myutils.cpp:2580


class Sequence:
    __slots__ = ("label", "_data")

    def __init__(self, label: str, data):
        self.label = label
        if isinstance(data, (bytes, bytearray, str)):
            if isinstance(data, str):
                data = data.encode()
            data = np.frombuffer(bytes(data), dtype=np.uint8)
        self._data = np.asarray(data, dtype=np.uint8)

    # -- basics ----------------------------------------------------------
    def __len__(self) -> int:
        return int(self._data.size)

    def __str__(self) -> str:
        return self._data.tobytes().decode()

    def __repr__(self) -> str:
        return f"Sequence({self.label!r}, len={len(self)})"

    def bytes_view(self) -> np.ndarray:
        return self._data

    def text(self) -> str:
        return self._data.tobytes().decode()

    # -- gap operations --------------------------------------------------
    def is_gap_mask(self) -> np.ndarray:
        return (self._data == _GAP) | (self._data == _DOT)

    def ungapped_length(self) -> int:
        return int((~self.is_gap_mask()).sum())

    def copy_delete_gaps(self) -> "Sequence":
        return Sequence(self.label, self._data[~self.is_gap_mask()])

    def pos_to_col(self) -> np.ndarray:
        """0-based column index of every residue (non-gap) position.

        reference: src/sequence.cpp:144 (GetPosToCol) — note the
        reference treats only '-' as gap there; we match that.
        """
        return np.flatnonzero(self._data != _GAP).astype(np.uint32)

    def col_to_pos(self) -> np.ndarray:
        """Per column: residue index or -1 for gap columns
        (reference: src/sequence.cpp:165 GetColToPos)."""
        nongap = self._data != _GAP
        out = np.cumsum(nongap).astype(np.int64) - 1
        out[~nongap] = -1
        return out

    def add_gaps_path(self, path: str, which: str) -> "Sequence":
        """Expand this (possibly gapped) row along an X/Y/B path.

        `which` is 'X' or 'Y'. For each path char: 'B' or `which`
        consumes one char of this row, otherwise a '-' is emitted
        (reference: src/sequence.cpp:115 AddGapsPath).
        """
        p = np.frombuffer(path.encode(), dtype=np.uint8)
        consume = (p == ord("B")) | (p == ord("M")) | (p == ord(which))
        out = np.full(p.size, _GAP, dtype=np.uint8)
        n = int(consume.sum())
        out[consume] = self._data[:n]
        return Sequence(self.label, out)


class MultiSequence:
    """Ordered collection of Sequences (reference: src/multisequence.h)."""

    def __init__(self, seqs: list[Sequence] | None = None):
        self.seqs: list[Sequence] = list(seqs) if seqs else []

    # -- container -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.seqs)

    def __getitem__(self, i: int) -> Sequence:
        return self.seqs[i]

    def __iter__(self):
        return iter(self.seqs)

    def add(self, seq: Sequence) -> None:
        self.seqs.append(seq)

    def labels(self) -> list[str]:
        return [s.label for s in self.seqs]

    def lengths(self) -> np.ndarray:
        return np.array([len(s) for s in self.seqs], dtype=np.int64)

    # -- alignment-shaped ------------------------------------------------
    def is_aligned(self) -> bool:
        if not self.seqs:
            return False
        L = len(self.seqs[0])
        return all(len(s) == L for s in self.seqs)

    def col_count(self) -> int:
        if not self.is_aligned():
            raise ValueError("MultiSequence is not aligned")
        return len(self.seqs[0])

    def to_matrix(self) -> np.ndarray:
        """Aligned rows as an (N, L) uint8 matrix."""
        return np.stack([s.bytes_view() for s in self.seqs])

    def project(self, indexes) -> "MultiSequence":
        """Sub-MSA of the given row indexes with all-gap columns removed
        (reference: MultiSequence::Project, src/project.cpp:16-69;
        only '-' counts as gap there)."""
        idx = sorted(int(i) for i in indexes)
        m = np.stack([self.seqs[i].bytes_view() for i in idx])
        keep = ~np.all(m == _GAP, axis=0)
        return MultiSequence(
            [Sequence(self.seqs[i].label, m[k][keep]) for k, i in enumerate(idx)])

    # -- I/O -------------------------------------------------------------
    @classmethod
    def from_fasta(cls, path_or_text, strip_gaps: bool = False) -> "MultiSequence":
        if "\n" in str(path_or_text) or str(path_or_text).startswith(">"):
            text = str(path_or_text)
        else:
            with open(path_or_text) as f:
                text = f.read()
        return cls.from_fasta_text(text, strip_gaps=strip_gaps)

    @classmethod
    def from_fasta_text(cls, text: str, strip_gaps: bool = False) -> "MultiSequence":
        ms = cls()
        label = None
        chunks: list[str] = []

        def flush():
            if label is None:
                return
            s = "".join(chunks)
            if strip_gaps:
                s = s.replace("-", "").replace(".", "")
            ms.add(Sequence(label, s))

        for line in text.splitlines():
            if line.startswith(">"):
                flush()
                label = line[1:].strip()
                chunks = []
            elif line.startswith("<"):
                raise ValueError("EFA input — use Ensemble.from_efa")
            else:
                chunks.append(line.strip())
        flush()
        return ms

    def write_fasta(self, path_or_file) -> None:
        if hasattr(path_or_file, "write"):
            self._write(path_or_file)
        else:
            with open(path_or_file, "w") as f:
                self._write(f)

    def _write(self, f) -> None:
        for s in self.seqs:
            f.write(f">{s.label}\n")
            t = s.text()
            for i in range(0, len(t), FASTA_ROWLEN):
                f.write(t[i:i + FASTA_ROWLEN] + "\n")

    def to_fasta_text(self) -> str:
        buf = _io.StringIO()
        self._write(buf)
        return buf.getvalue()
