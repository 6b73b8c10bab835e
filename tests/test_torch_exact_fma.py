"""The reference-order kernels' LOG_ADD cubic (csrc/pairhmm_exact.cu:
each Horner step one single-rounded f32 FMA) against the port's plain
version (ops/logspace.py::logexp1: each step in double, rounded once to
f32), on the CPU.

tools/exact_fma_proof.py checks every f32 in [0, 7.5]; here a sample:
every segment's edges and the floats around them, ~2^20 values spread
over [0, 7.5], and the one argument where a double step lands exactly
halfway between two f32 with a nonzero error. The exact FMA is the
tool's: the double product (exact) and the sum's TwoSum error, rounded
toward the error at a tie; it is held to exact rational arithmetic
first.
"""

import os
import re
import sys
from fractions import Fraction

import numpy as np
import torch

from muscle_tpu_torch.ops import logspace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import exact_fma_proof as proof  # noqa: E402

# the argument at which a Horner step's double sum is an f32 tie with a
# nonzero error (tools/exact_fma_proof.py prints it)
TIE_X = np.float32(0.003849256318062544)


def _sample() -> np.ndarray:
    rng = np.random.default_rng(20261018)
    top = int(np.float32(7.5).view(np.uint32))
    spread = rng.integers(0, top + 1, 1 << 19, dtype=np.uint32).view(
        np.float32)
    even = np.linspace(0.0, 7.5, 1 << 19, dtype=np.float32)
    edges = []
    for e in (0.0, 1.0, 2.5, 4.5, 7.5):
        bits = int(np.float32(e).view(np.uint32))
        edges += [b for b in range(bits - 64, bits + 65) if 0 <= b <= top]
    edge = np.asarray(edges, np.uint32).view(np.float32)
    return np.concatenate([spread, even, edge, [TIE_X]]).astype(np.float32)


def _round_f32(q: Fraction) -> np.float32:
    """q rounded to the nearest f32 (ties to even), exactly."""
    near = np.float32(float(q))
    cands = [near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf))]
    dist = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(c.view(np.uint32)) & 1)


def test_fma_emulation_is_exact():
    """The tool's single-rounded FMA = exact rounding of r * x + c, on
    random steps and at the tie (where the double step ties to even and
    the FMA rounds toward the error)."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(0, 7.5, 300).astype(np.float32),
                        [TIE_X]])
    c = proof.coeffs(x)
    r = c[:, 0]
    ties = 0
    for k in (1, 2, 3):
        fma, plain, tie = proof.fma32(r, x, c[:, k])
        ties += int(tie.sum())
        for ri, xi, ci, fi in zip(r, x, c[:, k], fma):
            want = _round_f32(Fraction(float(ri)) * Fraction(float(xi))
                              + Fraction(float(ci)))
            assert want.view(np.uint32) == fi.view(np.uint32)
        r = plain
    assert ties == 1


def test_fma_cubic_equals_plain_logexp1():
    x = _sample()
    want = logspace.logexp1(torch.from_numpy(x)).numpy()
    got = proof.fma_chain(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    ties, mism, at = proof.step_counts(x)
    assert mism == 0 and ties == 1 and at == [float(TIE_X)]


def test_cubic_rows_select_the_plain_segment():
    """The kernel indexes its table of the cubic by k = ceil(2x) (one FMA
    rounded up): the row of every k is the segment (x > 1) + (x > 2.5) +
    (x > 4.5) of the plain version, tested around every multiple of 1/2
    (the only places k changes) and on the sample."""
    src = open(os.path.join(REPO, "muscle_tpu_torch", "csrc",
                            "pairhmm_exact.cu")).read()
    table = re.search(r"kCubic\[4 \* CUBIC_ROWS\] = \{(.*?)\};", src, re.S)
    rows = [int(m) for m in re.findall(r"CUBIC(\d)\b", table.group(1))]
    assert len(rows) == 16
    top = int(np.float32(7.5).view(np.uint32))
    near = []
    for k in range(16):
        bits = int(np.float32(k / 2).view(np.uint32))
        near += [b for b in range(bits - 256, bits + 257) if 0 <= b <= top]
    x = np.concatenate([np.asarray(near, np.uint32).view(np.float32),
                        _sample()])
    k = np.ceil(2.0 * x.astype(np.float64)).astype(np.int64)
    seg = (x > 1.0).astype(np.int64) + (x > 2.5) + (x > 4.5)
    assert k.max() <= 15 and np.array_equal(np.asarray(rows)[k], seg)


def test_coefficients_are_the_plain_versions():
    """The tool's (and the kernel's) f32 coefficients are logspace's."""
    assert np.array_equal(proof.SEGS, np.asarray(logspace._SEGS, np.float32))
    src = open(os.path.join(REPO, "muscle_tpu_torch", "csrc",
                            "pairhmm_exact.cu")).read()
    for seg in proof.COEFFS:
        for c in seg:
            assert f"f32c({c:.15f})" in src or f"f32c({c!r})" in src
