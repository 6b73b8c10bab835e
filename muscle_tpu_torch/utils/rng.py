"""Deterministic RNGs reproducing the reference's random streams.

Two independent generators drive reproducibility in the reference:

1. A multiply-with-carry (MWC) generator seeded via a small LCG
   (reference: src/myutils.cpp:2200-2296, ResetRand/randu32). It drives
   HMM parameter perturbation (-perturb seeds), GuessIsNucleo sampling,
   and shuffles. We reproduce it exactly so ensemble replicates
   (-diversified/-stratified) are comparable run-for-run.

2. The C library rand() — used *only* for the random bipartition in
   refinement (reference: src/refineflat.cpp:15 `rand()%2`), never
   seeded, so it is glibc's TYPE_3 additive generator with seed 1. We
   reproduce glibc's random(3) so refinement splits match the reference
   binary bit-for-bit on Linux.

Both are pure-Python host code; they generate O(N) values per run and
are nowhere near hot paths.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


class MwcRng:
    """Marsaglia multiply-with-carry RNG, reference-compatible."""

    _SLCG_A = 214013
    _SLCG_C = 2531011

    def __init__(self, seed: int = 1):
        self.reset(seed)

    def _slcg(self) -> int:
        self._slcg_state = (self._slcg_state * self._SLCG_A + self._SLCG_C) & _M32
        return self._slcg_state

    def reset(self, seed: int) -> None:
        # SLCG_srand: set state, burn 10 (src/myutils.cpp:2212-2217)
        self._slcg_state = seed & _M32
        for _ in range(10):
            self._slcg()
        # fill X[5] then burn 100 increments (src/myutils.cpp:2286-2296)
        self._x = [self._slcg() for _ in range(5)]
        for _ in range(100):
            self._increment()

    def _increment(self) -> None:
        x = self._x
        s = (2111111111 * x[3] + 1492 * x[2] + 1776 * x[1] + 5115 * x[0] + x[4])
        x[3] = x[2]
        x[2] = x[1]
        x[1] = x[0]
        x[4] = (s >> 32) & _M32
        x[0] = s & _M32

    def clone(self) -> "MwcRng":
        """Independent copy at the current stream position (used to
        replay a sampling sequence lazily, e.g. PProg path recompute)."""
        c = MwcRng.__new__(MwcRng)
        c._slcg_state = self._slcg_state
        c._x = list(self._x)
        return c

    def randu32(self) -> int:
        self._increment()
        return self._x[0]

    def shuffle(self, items: list) -> None:
        """Fisher-Yates as in the reference Shuffle (src/myutils.cpp:2611)."""
        for i in range(len(items) - 1, 0, -1):
            j = self.randu32() % (i + 1)
            items[i], items[j] = items[j], items[i]


class MinStdRand:
    """C++ std::minstd_rand (linear_congruential_engine<u32, 48271, 0,
    2147483647>) — drives muscle3 ensemble parameter perturbation
    (reference: M3AlnParams::m_MinStdRand src/m3alnparams.h:33)."""

    _A = 48271
    _M = 2147483647

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, s: int) -> None:
        s %= self._M
        self._x = s if s else 1

    def rand(self) -> int:
        self._x = (self._x * self._A) % self._M
        return self._x


class GlibcRand:
    """glibc random(3) TYPE_3 additive-feedback generator.

    Reproduces rand() on Linux/glibc: r[i] = r[i-3] + r[i-31] mod 2^32,
    output = r[i] >> 31 ... actually >> 1 (31-bit output). Initialization
    per glibc stdlib/random_r.c.
    """

    def __init__(self, seed: int = 1):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed & _M32
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647 via Schrage's method
            # (glibc stdlib/random_r.c: hi = s/127773, lo = s%127773)
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 3] + r[i - 31]) & _M32
        self._r = r
        self._i = 344

    def rand(self) -> int:
        r = self._r
        i = self._i
        v = (r[i - 3] + r[i - 31]) & _M32
        r.append(v)
        self._i = i + 1
        # keep the list from growing unboundedly
        if self._i > 100000:
            self._r = r[-31:]
            self._i = 31
        return v >> 1
