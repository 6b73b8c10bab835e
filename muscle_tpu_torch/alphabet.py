"""Alphabet tables and sequence encoding.

Behavioral contract follows the reference alphabet layer
(reference: src/alpha.cpp, src/alpha2.cpp, src/hmmparams.h:12-13):
amino alphabet is "ACDEFGHIKLMNPQRSTVWY" (20 letters), nucleotide is
"ACGT" (4 letters, with U treated as T per src/hmmparams.cpp FixUT).
Any other residue character is a wildcard whose pair-HMM emission is the
uniform 1/K (insert) / 1/K^2 (match) distribution
(reference: src/hmmparams.cpp ToPairHMM, wildcard loops).

On device we do not index score tables by raw byte (the reference uses
256x256 byte-indexed tables, src/pairhmm.h:26-29); instead sequences are
encoded once on host into small integer codes 0..K (K = wildcard code) so
the emission tables are dense (K+1)x(K+1) f32 arrays that fit in
VMEM/SMEM and gather efficiently.
"""

from __future__ import annotations

import numpy as np

AMINO_ALPHA = "ACDEFGHIKLMNPQRSTVWY"
NT_ALPHA = "ACGT"

GAP_CHARS = frozenset("-.")

ALPHA_AMINO = "amino"
ALPHA_NUCLEO = "nucleo"


def _make_char_to_code(alpha: str, extra: dict[str, int] | None = None) -> np.ndarray:
    """Map byte -> code in [0, K]; K (= len(alpha)) is the wildcard code."""
    k = len(alpha)
    table = np.full(256, k, dtype=np.uint8)
    for i, c in enumerate(alpha):
        table[ord(c.upper())] = i
        table[ord(c.lower())] = i
    if extra:
        for c, code in extra.items():
            table[ord(c.upper())] = code
            table[ord(c.lower())] = code
    return table

# U == T for nucleotide scoring (reference: src/hmmparams.cpp PairHMM::FixUT)
CHAR_TO_CODE_AMINO = _make_char_to_code(AMINO_ALPHA)
CHAR_TO_CODE_NUCLEO = _make_char_to_code(NT_ALPHA, extra={"U": NT_ALPHA.index("T")})

# Nucleotide membership test used by GuessIsNucleo: strict ACGT+U
_IS_NUCLEO_CHAR = np.zeros(256, dtype=bool)
for _c in "ACGTUacgtu":
    _IS_NUCLEO_CHAR[ord(_c)] = True


def alphabet_size(alpha: str) -> int:
    return 20 if alpha == ALPHA_AMINO else 4


def char_to_code_table(alpha: str) -> np.ndarray:
    return CHAR_TO_CODE_AMINO if alpha == ALPHA_AMINO else CHAR_TO_CODE_NUCLEO


def encode(seq_bytes: np.ndarray, alpha: str) -> np.ndarray:
    """Encode raw byte sequence (np.uint8) to codes 0..K (K = wildcard)."""
    return char_to_code_table(alpha)[seq_bytes]


def guess_is_nucleo(seqs, rng) -> bool:
    """Sample 100 random (seq, pos) letters; nucleo if > 75 are ACGTU.

    Mirrors MultiSequence::GuessIsNucleo (reference:
    src/multisequence.cpp:179-204) including its use of the global RNG
    (randu32()%SeqCount then randu32()%L) so that downstream RNG state
    matches the reference's when alphabet guessing runs first.
    """
    n = len(seqs)
    count = 0
    for _ in range(100):
        s = seqs[rng.randu32() % n]
        data = s.bytes_view()
        pos = rng.randu32() % len(data)
        if _IS_NUCLEO_CHAR[data[pos]]:
            count += 1
    return count > 75
