"""Pair-HMM parameter model: load, normalize, perturb, lower to scores.

Capability-equivalent to the reference HMMParams (reference:
src/hmmparams.{h,cpp}, src/perturbhmm.cpp, src/setprobconsparams.cpp).
The 5-state model (M, IX, IY short-gap, JX, JY long-gap; reference
src/pairhmm.h:11-19) is parameterized by 10 transition probabilities
(src/hmmtrans.h) and a symmetric KxK joint emission matrix.

`to_scores()` lowers probabilities into the dense log-space tables the
pair-HMM kernels consume (a ScorePack of small f32 arrays), the equivalent of
HMMParams::ToPairHMM (src/hmmparams.cpp:298-361): insert scores are the
log marginals of the joint emission matrix, wildcards emit uniformly.

All arithmetic is float32 to track the reference numerics.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..alphabet import AMINO_ALPHA, NT_ALPHA
from ..utils.rng import MwcRng
from .defaults import DEFAULT_AMINO, DEFAULT_NUCLEO

# Transition parameter order (reference: src/hmmtrans.h)
TRANS_NAMES = (
    "START_M", "START_IS", "START_IL",
    "M_M", "M_IS", "M_IL",
    "IS_IS", "IS_M",
    "IL_IL", "IL_M",
)
_T = {name: i for i, name in enumerate(TRANS_NAMES)}

DEFAULT_PERTURB_VAR = 0.25  # reference: src/hmmparams.h:16

f32 = np.float32


@dataclass
class ScorePack:
    """Dense log-space score tables for the device kernels.

    Emission tables are (K+1)x(K+1)/(K+1,) with code K = wildcard, so a
    sequence encoded by alphabet.encode() indexes them directly.
    """
    alpha_size: int
    # start scores for states [M, IX, IY, JX, JY]
    start: np.ndarray          # (5,) f32
    tMM: float
    tMI: float                 # M -> short gap (IX or IY)
    tMJ: float                 # M -> long gap (JX or JY)
    tII: float                 # short gap extend
    tIM: float                 # short gap -> M
    tJJ: float                 # long gap extend
    tJM: float                 # long gap -> M
    match: np.ndarray          # (K+1, K+1) f32 log joint emission
    insert: np.ndarray         # (K+1,) f32 log marginal emission


class HMMParams:
    def __init__(self, alpha: str, trans: np.ndarray, emits: np.ndarray,
                 var: float = DEFAULT_PERTURB_VAR):
        self.alpha = alpha                       # "ACDE..." letter string
        self.trans = np.asarray(trans, dtype=f32).copy()
        self.emits = np.asarray(emits, dtype=f32).copy()
        self.var = var

    @property
    def alpha_size(self) -> int:
        return len(self.alpha)

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_defaults(cls, nucleo: bool = False) -> "HMMParams":
        text = DEFAULT_NUCLEO if nucleo else DEFAULT_AMINO
        return cls.from_text(text)

    @classmethod
    def from_file(cls, path: str) -> "HMMParams":
        with open(path) as f:
            return cls.from_text(f.read())

    @classmethod
    def from_text(cls, text: str) -> "HMMParams":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        hdr = lines[0].split("\t")
        if len(hdr) != 2 or hdr[0] != "HMM":
            raise ValueError("invalid HMM file header")
        if hdr[1] == "aa":
            alpha = AMINO_ALPHA
        elif hdr[1] == "nt":
            alpha = NT_ALPHA
        else:
            raise ValueError(f"invalid HMM alphabet {hdr[1]!r}")
        k = len(alpha)

        pos = 1
        trans = np.zeros(len(TRANS_NAMES), dtype=f32)
        for i, name in enumerate(TRANS_NAMES):
            key, val = lines[pos].split("\t")
            if key != f"T.{name}":
                raise ValueError(f"expected T.{name}, got {key}")
            trans[i] = f32(float(val))
            pos += 1

        emits = np.zeros((k, k), dtype=f32)
        for i in range(k):
            for j in range(i + 1):
                key, val = lines[pos].split("\t")
                want = f"E.{alpha[i]}{alpha[j]}"
                if key != want:
                    raise ValueError(f"expected {want}, got {key}")
                emits[i, j] = emits[j, i] = f32(float(val))
                pos += 1

        hp = cls(alpha, trans, emits)
        hp.normalize()
        return hp

    def to_text(self) -> str:
        """Serialize in -hmmout format (reference: HMMParams::ToFile)."""
        tag = "aa" if self.alpha == AMINO_ALPHA else "nt"
        out = [f"HMM\t{tag}"]
        for i, name in enumerate(TRANS_NAMES):
            out.append(f"T.{name}\t{self.trans[i]:.5g}")
        k = self.alpha_size
        for i in range(k):
            for j in range(i + 1):
                out.append(f"E.{self.alpha[i]}{self.alpha[j]}\t{self.emits[i, j]:.5g}")
        return "\n".join(out) + "\n"

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_text())

    # -- normalization (reference: HMMParams::Normalize) -----------------
    def _normalize_start(self) -> None:
        t = self.trans
        s = f32(t[_T["START_M"]] + f32(2) * t[_T["START_IS"]] + f32(2) * t[_T["START_IL"]])
        for n in ("START_M", "START_IS", "START_IL"):
            t[_T[n]] = f32(t[_T[n]] / s)

    def _normalize_m_row(self) -> None:
        t = self.trans
        s = f32(t[_T["M_M"]] + f32(2) * t[_T["M_IS"]] + f32(2) * t[_T["M_IL"]])
        for n in ("M_M", "M_IS", "M_IL"):
            t[_T[n]] = f32(t[_T[n]] / s)

    def normalize(self) -> None:
        t = self.trans
        self._normalize_start()
        # NormalizeShortGap: M row then IS row (src/hmmparams.cpp)
        self._normalize_m_row()
        s = f32(t[_T["IS_IS"]] + t[_T["IS_M"]])
        t[_T["IS_IS"]] = f32(t[_T["IS_IS"]] / s)
        t[_T["IS_M"]] = f32(t[_T["IS_M"]] / s)
        # NormalizeLongGap: M row again then IL row
        self._normalize_m_row()
        s = f32(t[_T["IL_IL"]] + t[_T["IL_M"]])
        t[_T["IL_IL"]] = f32(t[_T["IL_IL"]] / s)
        t[_T["IL_M"]] = f32(t[_T["IL_M"]] / s)
        # NormalizeEmit: divide by total mass (off-diagonals counted twice)
        k = self.alpha_size
        tri = np.tril(self.emits)
        total = f32(0)
        for i in range(k):
            for j in range(i + 1):
                total = f32(total + tri[i, j])
                if i != j:
                    total = f32(total + tri[i, j])
        self.emits = (self.emits / total).astype(f32)

    # -- perturbation (reference: src/perturbhmm.cpp:15-36) --------------
    def perturb(self, seed: int) -> None:
        """Multiply every parameter by U[1-var, 1+var] then renormalize.

        Consumes the MWC RNG stream exactly as the reference does: one
        randu32 per transition (enum order) then one per lower-triangle
        emission entry, after ResetRand(seed).
        """
        if seed == 0:
            return
        rng = MwcRng(seed)
        var = f32(self.var)
        lo, hi = f32(1.0 - var), f32(1.0 + var)

        def factor():
            pct = rng.randu32() % 100
            fract = f32(pct / f32(100.0))
            return f32(lo + f32((hi - lo) * fract))

        for i in range(len(self.trans)):
            self.trans[i] = f32(self.trans[i] * factor())
        k = self.alpha_size
        for i in range(k):
            for j in range(i + 1):
                p = f32(self.emits[i, j] * factor())
                self.emits[i, j] = self.emits[j, i] = p
        self.normalize()

    # -- lowering to device score tables ---------------------------------
    def to_scores(self) -> ScorePack:
        k = self.alpha_size
        t = {n: self.trans[_T[n]] for n in TRANS_NAMES}
        # the reference takes C `log` (double) of the f32 probability
        # and rounds ONCE to f32 (src/hmmparams.cpp ToPairHMM / log());
        # logging in f32 precision instead lands 1 ulp off on ~10 of
        # the 400 table entries (measured vs a reference-binary table
        # dump — docs/PARITY.md BB11005 analysis)
        log = lambda x: np.log(np.float64(x)).astype(f32)

        # insert scores = log of row marginals (src/hmmparams.cpp:311-327);
        # marginal accumulated sequentially in f32 exactly as the
        # reference's `MarginalProb += P` loop (numpy .sum() is pairwise)
        marg = np.zeros(k, dtype=f32)
        for j in range(k):
            marg += self.emits[:, j].astype(f32)
        wild_ins = log(f32(1.0 / k))
        insert = np.full(k + 1, wild_ins, dtype=f32)
        insert[:k] = log(marg)

        wild_match = log(f32(1.0 / k) * f32(1.0 / k))
        match = np.full((k + 1, k + 1), wild_match, dtype=f32)
        match[:k, :k] = log(self.emits)

        start = np.array(
            [log(t["START_M"]), log(t["START_IS"]), log(t["START_IS"]),
             log(t["START_IL"]), log(t["START_IL"])], dtype=f32)

        return ScorePack(
            alpha_size=k,
            start=start,
            tMM=float(log(t["M_M"])),
            tMI=float(log(t["M_IS"])),
            tMJ=float(log(t["M_IL"])),
            tII=float(log(t["IS_IS"])),
            tIM=float(log(t["IS_M"])),
            tJJ=float(log(t["IL_IL"])),
            tJM=float(log(t["IL_M"])),
            match=match,
            insert=insert,
        )


def score_pack_from_numpy(start, trans7, match, insert) -> ScorePack:
    """ScorePack from plain arrays: start (5,) [M, IX, IY, JX, JY],
    trans7 (7,) [tMM, tMI, tMJ, tII, tIM, tJJ, tJM], match (K+1, K+1),
    insert (K+1,) — e.g. the fields of another implementation's score
    tables, so two implementations can be fed identical (perturbed)
    tables."""
    start = np.asarray(start, dtype=f32).copy()
    trans7 = np.asarray(trans7, dtype=f32)
    match = np.asarray(match, dtype=f32).copy()
    insert = np.asarray(insert, dtype=f32).copy()
    if start.shape != (5,) or trans7.shape != (7,) or insert.ndim != 1 \
            or match.shape != (insert.shape[0],) * 2:
        raise ValueError("score table shapes")
    tMM, tMI, tMJ, tII, tIM, tJJ, tJM = (float(v) for v in trans7)
    return ScorePack(alpha_size=insert.shape[0] - 1, start=start,
                     tMM=tMM, tMI=tMI, tMJ=tMJ, tII=tII, tIM=tIM,
                     tJJ=tJJ, tJM=tJM, match=match, insert=insert)
