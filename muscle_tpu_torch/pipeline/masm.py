"""MASM — Multiple Alignment Structure Model (reseek integration).

Host copy of muscle_tpu.pipeline.masm (numpy only).

reference: src/masm.{h,cpp}, src/masmcol.{h,cpp}, src/masm_train.cpp,
src/swmasm.cpp. A MASM is a per-column multi-feature frequency/score
model built from an MSA whose rows exist in a mega profile set; columns
carry gap open/ext/close frequencies and per-feature expected log-odds
scores (feature weights are already folded into the mega log-odds
matrices). A MASM can be aligned against a mega profile with local
(SW) alignment; serialization matches the reference's text format.
"""

from __future__ import annotations

import numpy as np

from ..io.mega import MegaProfileSet
from ..sequence import MultiSequence

GAP = 255


class MASM:
    def __init__(self):
        self.label = ""
        self.seq_count = 0
        self.col_count = 0
        self.feature_names: list[str] = []
        self.alpha_sizes: list[int] = []
        self.gap_open = 0.0
        self.gap_ext = 0.0
        # per column
        self.freqs: list[list[np.ndarray]] = []    # [col][feature] (K_f,)
        self.scores: list[list[np.ndarray]] = []   # [col][feature] (K_f,)
        self.col_gap_open: np.ndarray | None = None
        self.col_gap_close: np.ndarray | None = None

    # -- training (reference: MASM::FromMSA src/masm.cpp:100-148) --------
    @classmethod
    def from_msa(cls, aln: MultiSequence, mega: MegaProfileSet,
                 label: str, gap_open: float | None = None,
                 gap_ext: float | None = None) -> "MASM":
        m = cls()
        m.label = label
        m.gap_open = mega.gap_open if gap_open is None else gap_open
        m.gap_ext = mega.gap_ext if gap_ext is None else gap_ext
        assert m.gap_open >= 0 and m.gap_ext >= 0
        m.seq_count = len(aln)
        m.col_count = aln.col_count()
        m.feature_names = list(mega.feature_names)
        m.alpha_sizes = list(mega.alpha_sizes)
        f_count = mega.feature_count

        # per-row feature letters in MSA column space (gap = 255)
        seq_to_prof = {s: i for i, s in enumerate(mega.seqs)}
        mat = aln.to_matrix()
        gaps = (mat == ord("-")) | (mat == ord("."))
        feature_aln = np.full((f_count, m.seq_count, m.col_count), GAP,
                              dtype=np.uint8)
        for si, s in enumerate(aln):
            ungapped = s.text().replace("-", "").replace(".", "")
            pi = seq_to_prof.get(ungapped)
            if pi is None:
                raise KeyError(
                    f"MSA row {s.label!r} not found in mega profiles")
            prof = mega.profiles[pi]        # (L, F)
            cols = np.flatnonzero(~gaps[si])
            for f in range(f_count):
                feature_aln[f, si, cols] = prof[:, f]

        # gap state counts per column (reference: MASM::GetCounts)
        gap_prev = np.zeros_like(gaps)
        gap_prev[:, 1:] = gaps[:, :-1]
        gap_next = np.zeros_like(gaps)
        gap_next[:, :-1] = gaps[:, 1:]
        letter_n = (~gaps).sum(0)
        ext_n = (gaps & gap_prev).sum(0)
        open_n = (gaps & ~gap_prev & gap_next).sum(0)
        close_n = (gaps & ~gap_prev & ~gap_next).sum(0)
        n = float(m.seq_count)
        open_freq = open_n / n
        close_freq = close_n / n
        m.col_gap_open = ((1 - open_freq) * m.gap_open / 2).astype(np.float32)
        m.col_gap_close = ((1 - close_freq) * m.gap_open / 2
                           ).astype(np.float32)

        # per-column per-feature freqs + expected log-odds scores
        # (reference: MASM::GetFreqs + MASMCol::SetScoreVec — freqs are
        # over ALL rows, so occupancy is folded in)
        for c in range(m.col_count):
            col_freqs = []
            col_scores = []
            for f in range(f_count):
                k = m.alpha_sizes[f]
                letters = feature_aln[f, :, c]
                counts = np.bincount(letters[letters != GAP], minlength=k)
                freqs = (counts / n).astype(np.float32)
                col_freqs.append(freqs)
                # feature weights are already folded into the mega
                # log-odds matrices (reference: src/masmcol.cpp:42)
                col_scores.append(
                    (mega.log_odds_mx[f] @ freqs).astype(np.float32))
            m.freqs.append(col_freqs)
            m.scores.append(col_scores)
        return m

    # -- scoring (reference: ScorePP src/masm.cpp:5-19) -------------------
    def smx_vs_profile(self, prof: np.ndarray) -> np.ndarray:
        """(col_count, L) score lattice vs a mega profile (L, F)."""
        lb = prof.shape[0]
        out = np.zeros((self.col_count, lb), dtype=np.float32)
        for f in range(len(self.feature_names)):
            sc = np.stack([self.scores[c][f] for c in range(self.col_count)])
            out += sc[:, prof[:, f]]
        return out

    def sw_vs_profile(self, prof: np.ndarray) -> tuple[float, str, int, int]:
        """Local alignment vs a mega profile using the column gap scores.
        Returns (score, path, lo_m, lo_q). reference: SWFast_MASM
        (src/swmasm.cpp)."""
        s = self.smx_vs_profile(prof)
        la, lb = s.shape
        open_a = -np.asarray(self.col_gap_open, dtype=np.float64)
        ext = -float(self.gap_ext)
        H = np.zeros((la + 1, lb + 1))
        E = np.full((la + 1, lb + 1), -np.inf)
        F = np.full((la + 1, lb + 1), -np.inf)
        tb = np.zeros((la + 1, lb + 1), dtype=np.uint8)
        best, bi, bj = 0.0, 0, 0
        for i in range(1, la + 1):
            og = open_a[i - 1]
            for j in range(1, lb + 1):
                E[i, j] = max(E[i, j - 1] + ext, H[i, j - 1] + og + ext)
                F[i, j] = max(F[i - 1, j] + ext, H[i - 1, j] + og + ext)
                d = H[i - 1, j - 1] + s[i - 1, j - 1]
                h = max(0.0, d, E[i, j], F[i, j])
                H[i, j] = h
                tb[i, j] = (0 if h == d else (1 if h == F[i, j] else
                                              (2 if h == E[i, j] else 3)))
                if h > best:
                    best, bi, bj = h, i, j
        # traceback
        path = []
        i, j = bi, bj
        while i > 0 and j > 0 and H[i, j] > 0:
            t = tb[i, j]
            if t == 3:
                break
            if t == 0:
                path.append("B")
                i -= 1
                j -= 1
            elif t == 1:
                path.append("X")
                i -= 1
            else:
                path.append("Y")
                j -= 1
        path.reverse()
        return float(best), "".join(path), i, j

    # -- serialization (reference: MASM::ToFile src/masm.cpp:159-172) ----
    def to_text(self) -> str:
        out = [f"MASM\t{self.seq_count}\t{self.col_count}\t"
               f"{len(self.feature_names)}\t{self.gap_open:.4g}\t"
               f"{self.gap_ext:.4g}\t{self.label}"]
        for i, (name, k) in enumerate(zip(self.feature_names,
                                          self.alpha_sizes)):
            out.append(f"feature\t{i}\t{name}\t{k}")
        for c in range(self.col_count):
            out.append(f"col\t{c}")
            for f in range(len(self.feature_names)):
                out.append(f"colfeature\t{f}")
                out.append("freqs\t" + "\t".join(
                    f"{v:.3g}" for v in self.freqs[c][f]))
                out.append("scores\t" + "\t".join(
                    f"{v:.3g}" for v in self.scores[c][f]))
        return "\n".join(out) + "\n"

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_text())

    @classmethod
    def from_text(cls, text: str) -> "MASM":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        m = cls()
        hdr = lines[0].split("\t")
        assert hdr[0] == "MASM"
        m.seq_count = int(hdr[1])
        m.col_count = int(hdr[2])
        fcount = int(hdr[3])
        m.gap_open = float(hdr[4])
        m.gap_ext = float(hdr[5])
        m.label = hdr[6] if len(hdr) > 6 else ""
        pos = 1
        for f in range(fcount):
            flds = lines[pos].split("\t")
            assert flds[0] == "feature" and int(flds[1]) == f
            m.feature_names.append(flds[2])
            m.alpha_sizes.append(int(flds[3]))
            pos += 1
        for c in range(m.col_count):
            assert lines[pos].split("\t")[0] == "col"
            pos += 1
            col_freqs, col_scores = [], []
            for f in range(fcount):
                assert lines[pos].split("\t")[0] == "colfeature"
                pos += 1
                col_freqs.append(np.array(
                    [float(v) for v in lines[pos].split("\t")[1:]],
                    dtype=np.float32))
                pos += 1
                col_scores.append(np.array(
                    [float(v) for v in lines[pos].split("\t")[1:]],
                    dtype=np.float32))
                pos += 1
            m.freqs.append(col_freqs)
            m.scores.append(col_scores)
        # gap scores are not serialized by the reference; recompute a
        # uniform default from the header gap_open
        m.col_gap_open = np.full(m.col_count, m.gap_open / 2, np.float32)
        m.col_gap_close = np.full(m.col_count, m.gap_open / 2, np.float32)
        return m

    @classmethod
    def from_file(cls, path: str) -> "MASM":
        with open(path) as f:
            return cls.from_text(f.read())
