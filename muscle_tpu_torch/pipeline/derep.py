"""Exact-duplicate dereplication (reference: src/derep.cpp:28-120).

Case-insensitive exact sequence matching; the first occurrence is the
representative, duplicates are re-inserted after alignment
(reference: src/mpcflat.cpp InsertDupes).
"""

from __future__ import annotations

from ..sequence import MultiSequence


class Derep:
    def __init__(self):
        self.rep_indexes: list[int] = []
        self.rep_to_members: dict[int, list[int]] = {}

    def run(self, seqs: MultiSequence) -> None:
        seen: dict[bytes, int] = {}
        self.rep_indexes = []
        self.rep_to_members = {}
        for i, s in enumerate(seqs):
            key = s.bytes_view().tobytes().upper()
            rep = seen.get(key)
            if rep is None:
                seen[key] = i
                self.rep_indexes.append(i)
                self.rep_to_members[i] = [i]
            else:
                self.rep_to_members[rep].append(i)

    def unique_seqs(self, seqs: MultiSequence) -> MultiSequence:
        return MultiSequence([seqs[i] for i in self.rep_indexes])

    def rep_label_to_dupe_labels(self, seqs: MultiSequence) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {}
        for rep in self.rep_indexes:
            members = self.rep_to_members[rep]
            if len(members) <= 1:
                continue
            rep_label = seqs[rep].label
            out[rep_label] = [seqs[m].label for m in members
                              if seqs[m].label != rep_label]
        return out
