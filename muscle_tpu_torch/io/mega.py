"""Mega multi-feature structure-profile format (Muscle-3D input).

Host copy of muscle_tpu.io.mega. reference: src/mega.{h,cpp} — header
`mega <nfeatures> <nprofiles> <gapopen> <gapext>`; per feature:
name/alphabet-size/weight, letter freqs, lower-triangle joint-prob
matrix, lower-triangle log-odds matrix; then per chain a label +
per-position feature letter strings. Feature 0 is the amino-acid
sequence (wildcards coerced to letter 0, reference:
src/mega.cpp:247-249); other features are 16-letter structure alphabets
produced by reseek.

The device path consumes `log_prob_mx` / `log_probs` / `weights`
(ops/emissions.py builds batched emission lattices from them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..alphabet import AMINO_ALPHA

VERY_SMALL_FREQ = 1e-6   # reference: src/mega.cpp:8

_CHAR_TO_AA = np.full(256, 0, dtype=np.uint8)
for _i, _c in enumerate(AMINO_ALPHA):
    _CHAR_TO_AA[ord(_c)] = _i
    _CHAR_TO_AA[ord(_c.lower())] = _i


@dataclass
class MegaProfileSet:
    feature_names: list[str]
    alpha_sizes: list[int]
    weights: np.ndarray            # (F,) f32
    log_probs: list[np.ndarray]    # per feature (K_f,) f32
    log_prob_mx: list[np.ndarray]  # per feature (K_f, K_f) f32
    log_odds_mx: list[np.ndarray]  # per feature (K_f, K_f) f32
    labels: list[str]
    profiles: list[np.ndarray]     # per chain (L, F) uint8 feature letters
    seqs: list[str]                # AA sequences (feature 0 letters)
    gap_open: float = 0.0
    gap_ext: float = 0.0

    @property
    def feature_count(self) -> int:
        return len(self.feature_names)

    def label_to_index(self) -> dict[str, int]:
        return {lb: i for i, lb in enumerate(self.labels)}

    # -- scoring (reference: src/mega.cpp:273-361) ------------------------
    def ins_score(self, profile: np.ndarray, pos: int) -> float:
        s = 0.0
        for f in range(self.feature_count):
            s += float(self.log_probs[f][profile[pos, f]]) * float(self.weights[f])
        return s

    def match_score(self, px: np.ndarray, i: int, py: np.ndarray, j: int
                    ) -> float:
        s = 0.0
        for f in range(self.feature_count):
            s += float(self.log_prob_mx[f][px[i, f], py[j, f]]) \
                * float(self.weights[f])
        return s


def _fields(lines, nr, expected=None):
    while True:
        ln = lines[nr[0]]
        nr[0] += 1
        ln = ln.strip()
        if ln:
            break
    flds = ln.split("\t")
    if len(flds) == 1:
        flds = ln.split()
    if expected is not None and len(flds) != expected:
        raise ValueError(f"mega: expected {expected} fields, got {flds!r}")
    return flds


def parse_mega(path_or_text: str) -> MegaProfileSet:
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    lines = text.splitlines()
    nr = [0]

    hdr = _fields(lines, nr, 5)
    if hdr[0] != "mega":
        raise ValueError("not a mega file")
    fcount = int(hdr[1])
    pcount = int(hdr[2])
    gap_open = float(hdr[3])
    gap_ext = float(hdr[4])

    names, sizes, weights = [], [], []
    log_probs, log_prob_mx, log_odds_mx = [], [], []
    for f in range(fcount):
        flds = _fields(lines, nr, 4)
        assert int(flds[0]) == f
        names.append(flds[1])
        k = int(flds[2])
        sizes.append(k)
        weights.append(float(flds[3]))

        flds = _fields(lines, nr, k + 1)
        assert flds[0] == "freqs"
        probs = np.maximum(np.array([float(x) for x in flds[1:]],
                                    dtype=np.float32), VERY_SMALL_FREQ)
        log_probs.append(np.log(probs).astype(np.float32))

        mx = np.zeros((k, k), dtype=np.float32)
        for l1 in range(k):
            flds = _fields(lines, nr, l1 + 2)
            assert int(flds[0]) == l1
            for l2 in range(l1 + 1):
                p = max(float(flds[l2 + 1]), VERY_SMALL_FREQ)
                mx[l1, l2] = mx[l2, l1] = np.float32(np.log(np.float32(p)))
        log_prob_mx.append(mx)

        flds = _fields(lines, nr, 1)
        assert flds[0] == "logoddsmx"
        lo = np.zeros((k, k), dtype=np.float32)
        for l1 in range(k):
            flds = _fields(lines, nr, l1 + 3)
            assert int(flds[0]) == l1
            for l2 in range(l1 + 1):
                lo[l1, l2] = lo[l2, l1] = float(flds[l2 + 2])
        log_odds_mx.append(lo)

    labels, profiles, seqs = [], [], []
    for p in range(pcount):
        flds = _fields(lines, nr, 4)
        assert flds[0] == "chain" and int(flds[1]) == p
        labels.append(flds[2])
        L = int(flds[3])
        prof = np.zeros((L, fcount), dtype=np.uint8)
        chars = []
        for pos in range(L):
            flds = _fields(lines, nr, 3)
            syms = flds[2]
            assert len(syms) == fcount
            for f in range(fcount):
                if f == 0:
                    prof[pos, f] = _CHAR_TO_AA[ord(syms[0])]
                else:
                    letter = ord(syms[f]) - ord("A")
                    assert 0 <= letter < 16
                    prof[pos, f] = letter
            chars.append(syms[0])
        profiles.append(prof)
        seqs.append("".join(chars))

    return MegaProfileSet(names, sizes, np.array(weights, np.float32),
                          log_probs, log_prob_mx, log_odds_mx,
                          labels, profiles, seqs, gap_open, gap_ext)


def write_mega(ms: MegaProfileSet, path: str) -> None:
    """Serialize in the reference's text format (inverse of parse_mega;
    reference reader: Mega::FromFile src/mega.cpp:123-271). Stored
    probabilities are exp() of the parsed logs, so a parse->write round
    trip reproduces the numbers the scorer actually uses."""
    out = []
    f_count = ms.feature_count
    out.append("mega\t%d\t%d\t%.6g\t%.6g" %
               (f_count, len(ms.labels), ms.gap_open, ms.gap_ext))
    for f in range(f_count):
        k = ms.alpha_sizes[f]
        out.append("%d\t%s\t%d\t%.6g" %
                   (f, ms.feature_names[f], k, float(ms.weights[f])))
        freqs = np.exp(ms.log_probs[f])
        out.append("freqs\t" + "\t".join("%.6g" % v for v in freqs))
        probs = np.exp(ms.log_prob_mx[f])
        for l1 in range(k):
            out.append("%d\t" % l1 + "\t".join(
                "%.6g" % probs[l1, l2] for l2 in range(l1 + 1)))
        out.append("logoddsmx")
        for l1 in range(k):
            ch = AMINO_ALPHA[l1] if f == 0 else chr(ord("A") + l1)
            out.append("%d\t%s\t" % (l1, ch) + "\t".join(
                "%.6g" % ms.log_odds_mx[f][l1, l2]
                for l2 in range(l1 + 1)))
    for p, (label, prof) in enumerate(zip(ms.labels, ms.profiles)):
        out.append("chain\t%d\t%s\t%d" % (p, label, prof.shape[0]))
        for pos in range(prof.shape[0]):
            syms = []
            for f in range(f_count):
                if f == 0:
                    syms.append(AMINO_ALPHA[prof[pos, 0]])
                else:
                    syms.append(chr(ord("A") + prof[pos, f]))
            out.append("%d\t%d\t%s" % (p, pos, "".join(syms)))
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
