#!/usr/bin/env python3
"""Exhaustive CPU check that the reference-order kernels' LOG_ADD cubic
(csrc/pairhmm_exact.cu: each Horner step one f32 FMA, `__fmaf_rn(r, x,
c)`) gives the bits of the port's plain version (ops/logspace.py::
logexp1: the product and the sum in double, rounded once to f32).

    python tools/exact_fma_proof.py [--workers N] [--chunk-bits B]

Every f32 x in [0, 7.5] (the arguments LOG_ADD can pass in) goes through
the segment that x selects and all three Horner steps. At each step the
plain version's value is round_f32(s), s = r * x + c in double (the
product of two f32 is exact in double; the sum is rounded once). A
single-rounded f32 FMA is round_f32(r * x + c) of the exact sum. The two
can differ only where s is exactly halfway between two f32 and the sum's
rounding error in double (TwoSum, exact) is not zero: the FMA then
rounds toward the error, the plain version ties to even. The script
counts the values, those ties and the mismatches, and exits 1 on any
mismatch. numpy only, chunked over worker processes (48 s with 6
workers).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from multiprocessing import get_context

import numpy as np

# the reference's cubic (src/scoretype.h:100-109), as ops/logspace.py
# holds it: one row a segment, x in [0, 1], (1, 2.5], (2.5, 4.5], (4.5, 7.5]
COEFFS = ((-0.009350833524763, 0.130659527668286, 0.498799810682272,
           0.693203116424741),
          (-0.014532321752540, 0.139942324101744, 0.495635523139337,
           0.692140569840976),
          (-0.004605031767994, 0.063427417320019, 0.695956496475118,
           0.514272634594009),
          (-0.000458661602210, 0.009695946122598, 0.930734667215156,
           0.168037164329057))
# rounded to f32 from double, as the plain version and the kernel round them
SEGS = np.array(COEFFS, dtype=np.float64).astype(np.float32)
LAST_BITS = int(np.float32(7.5).view(np.uint32))  # bits of 7.5; 0.0 is 0


def fma32(r: np.ndarray, x: np.ndarray, c: np.ndarray):
    """(round_f32(r * x + c) of the exact sum, the double step rounded to
    f32, tie): f32 arrays r, x, c; `tie` marks where the double sum s is
    exactly halfway between two f32 and its rounding error is not zero."""
    p = r.astype(np.float64) * x.astype(np.float64)   # exact
    cd = c.astype(np.float64)
    s = p + cd                                        # rounded once
    bv = s - p                                        # TwoSum: p + cd =
    err = (p - (s - bv)) + (cd - bv)                  # s + err, exactly
    plain = s.astype(np.float32)                      # ties to even
    inf = np.float32(np.inf)
    toward = np.nextafter(plain, np.where(s > plain, inf, -inf))
    mid = (plain.astype(np.float64) + toward.astype(np.float64)) * 0.5
    tie = (s != plain) & (s == mid) & (err != 0)
    # at such a tie the exact sum lies on err's side of the midpoint
    hi, lo = np.maximum(plain, toward), np.minimum(plain, toward)
    fma = np.where(tie, np.where(err > 0, hi, lo), plain)
    return fma, plain, tie


def coeffs(x: np.ndarray) -> np.ndarray:
    """(n, 4) f32 coefficients of the segment each x selects."""
    return SEGS[(x > 1.0).astype(np.int64) + (x > 2.5) + (x > 4.5)]


def fma_chain(x: np.ndarray) -> np.ndarray:
    """The kernel's cubic: three single-rounded f32 FMAs."""
    c = coeffs(x)
    r = c[:, 0]
    for k in (1, 2, 3):
        r = fma32(r, x, c[:, k])[0]
    return r


def step_counts(x: np.ndarray):
    """(ties with a nonzero error, mismatches, the x of those ties) over
    the three steps, each step fed the plain version's value of the step
    before."""
    c = coeffs(x)
    r = c[:, 0]
    ties = mism = 0
    at = []
    for k in (1, 2, 3):
        fma, plain, tie = fma32(r, x, c[:, k])
        ties += int(tie.sum())
        mism += int((fma.view(np.uint32) != plain.view(np.uint32)).sum())
        at += [float(v) for v in x[tie]]
        r = plain
    return ties, mism, at


def _chunk(args):
    lo, hi = args
    x = np.arange(lo, hi, dtype=np.uint32).view(np.float32)
    return (hi - lo,) + step_counts(x)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--chunk-bits", type=int, default=22)
    a = ap.parse_args()
    step = 1 << a.chunk_bits
    end = LAST_BITS + 1
    chunks = [(lo, min(lo + step, end)) for lo in range(0, end, step)]
    t0 = time.perf_counter()
    n = ties = mism = 0
    at = []
    with get_context("spawn").Pool(a.workers) as pool:
        for cn, ct, cm, cat in pool.imap_unordered(_chunk, chunks):
            n += cn
            ties += ct
            mism += cm
            at += cat
    print(f"exact_fma_proof: {n} f32 values in [0, 7.5] (bits 0..{LAST_BITS:#x}), "
          f"3 Horner steps each: {ties} ties with a nonzero error, "
          f"{mism} mismatches between the single-rounded f32 FMA and the "
          f"double step rounded to f32 ({time.perf_counter() - t0:.0f} s, "
          f"{a.workers} workers)", flush=True)
    for v in sorted(at)[:8]:
        print(f"  tie with an error at x = {v!r} "
              f"(bits {np.float32(v).view(np.uint32):#010x})", flush=True)
    return 1 if mism or n != end else 0


if __name__ == "__main__":
    sys.exit(main())
