#!/usr/bin/env python3
"""Smoke run of muscle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. print the card (nvidia-smi name and power limit), build the CUDA
   kernels and the native host library from the sources in this
   checkout, timing the build;
2. hold each kernel against its plain torch twin on the card at the
   main path's shape (B = 512 ragged amino pairs, lengths 170-512,
   padded to 512), and time kernel and twin with CUDA events;
3. drive the main path, `muscle_tpu_torch.align(..., device="cuda")`
   with default settings, on every in-repo family (the degapped
   tests/goldens/BB1100*.seq.afa and tests/data/nt/nt*.fa), checking
   each output is an alignment of its input, printing whether it is
   column-identical to its golden and its Q against it, and requiring
   BB11001 to be column-identical;
   (and run the n = 2 and -consiters 0 branch on BB11001);
4. align a synthetic family at the top of the dense branch (n = 32,
   lengths 400-512), print its stage walls and peak device memory
   (tools/torch_profile_align.py splits its device time by kernel);
5. print the kernels' JSON line (launch counts from phases 3-4), then
   the card line and the final {"ok": true, ...} line.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# f32 operations per DP cell of the sequential recurrence (the least
# work for the function; reference src/fwdflat3.cpp, src/bwdflat3.cpp):
# one LOG_ADD = max, min, sub, two sentinel compares, three coefficient
# selects, a 3-mul 3-add cubic and the final add = 14. Forward: M folds
# five terms (5 transition adds, 4 LOG_ADD, 1 emission add = 62), IX,
# JX, IY, JY two terms each (2 adds, 1 LOG_ADD, 1 add = 17): 130.
# Backward: M sums five (transition + state + emission) terms (10 adds,
# 4 LOG_ADD = 66), the four gap states 2 terms each (4 adds, 1 LOG_ADD
# = 18): 138, plus the posterior (add, sub, compare, clamp, exp = 5) and
# the MEA row (add, 2 max = 3): 146.
FWD_OPS_PER_CELL = 130
BWD_POST_OPS_PER_CELL = 146

FAMILIES = ([(f"BB1100{k}", f"tests/goldens/BB1100{k}.seq.afa", True,
              f"tests/goldens/BB1100{k}.seq.afa") for k in (1, 2, 4, 5, 6, 7, 9)]
            + [(f"nt{k}", f"tests/data/nt/nt{k}.fa", False,
                f"tests/goldens/nt{k}.nt.afa") for k in (1, 2, 3)])


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb = n_bytes / PEAK_BYTES_PER_S * 1e3
    to = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_cuda(fn, reps: int = 5) -> float:
    """Median ms of `reps` runs after one warm-up (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def ragged_batch(b, lo, hi, width, seed):
    rng = np.random.default_rng(seed)
    lx = rng.integers(lo, hi + 1, size=b).astype(np.int32)
    ly = rng.integers(lo, hi + 1, size=b).astype(np.int32)
    lx[0] = ly[0] = hi
    xb = np.full((b, width), 20, np.int32)
    yb = np.full((b, width), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
    return xb, yb, lx, ly


def phase_kernels(dev, b=512, width=512) -> list[dict]:
    """Kernel A and kernel B against their twins at B = 512, L = 512."""
    import torch
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc

    xb, yb, lx, ly = ragged_batch(b, width // 3, width, width,
                                  seed=20261016)
    x, y, lxt, lyt = (torch.from_numpy(a).to(dev) for a in (xb, yb, lx, ly))
    match, insert, params = pc.tables(
        HMMParams.from_defaults(nucleo=False).to_scores(), dev)
    kk = insert.shape[0]
    cells = float(np.sum(lx.astype(np.int64) * ly.astype(np.int64)))

    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
    torch.cuda.synchronize()
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, match, insert, params)
    rows = torch.arange(width, device=dev)[None, :, None] < lxt[:, None, None]
    cols = torch.arange(width, device=dev)[None, None, :] < lyt[:, None, None]
    valid = rows & cols
    d_fm = (fm - fm2).abs().where(valid, 0.0)
    tol_fm = 1e-3 + 1e-6 * fm2.abs().where(valid, 0.0)
    err_a = max(float(d_fm.max()), float((fend - fend2).abs().max()))
    ok_a = bool((d_fm <= tol_fm).all()) and bool(
        ((fend - fend2).abs() <= 1e-3 + 1e-6 * fend2.abs()).all())
    print(f"kernel A pairhmm_fwd vs fwd_plain: max |d| log-space "
          f"{err_a:.3e} (tol 1e-3 + 1e-6*|ref|) "
          f"{'ok' if ok_a else 'FAIL'}", flush=True)

    tot = pc._total_prob(fend, params)
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                    tot, fm)
    torch.cuda.synchronize()
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, match, insert, params,
                                    tot, fm)
    nmin = torch.minimum(lxt, lyt).float()
    d = (post - post2).abs()
    # tests/test_pallas_fused.py:62-69: cells at the 0.01 threshold may
    # flip between fp32 associations
    flip = ((post == 0) | (post2 == 0)) & (torch.maximum(post, post2) <= 0.0102)
    d_post = float(d.where(~flip, 0.0).max())
    d_ea = float((mea / nmin - mea2 / nmin).abs().max())
    err_b = max(float(d.max()), d_ea)
    ok_b = d_post < 2e-3 and d_ea < 2e-3
    print(f"kernel B pairhmm_bwd_post vs bwd_post_plain: posterior "
          f"{d_post:.3e} (flips ignored, tol 2e-3), EA {d_ea:.3e} "
          f"(tol 2e-3), max |d| {err_b:.3e}, cells zero in one only "
          f"{int(((post == 0) != (post2 == 0)).sum())} "
          f"{'ok' if ok_b else 'FAIL'}", flush=True)
    del fm2, fend2, post2, mea2, d, flip, d_fm, tol_fm

    ms_a = time_cuda(lambda: pc.pairhmm_fwd(x, y, lxt, lyt, match, insert,
                                            params))
    ms_b = time_cuda(lambda: pc.pairhmm_bwd_post(x, y, lxt, lyt, match,
                                                 insert, params, tot, fm))
    plain_a = time_cuda(lambda: pc.fwd_plain(x, y, lxt, lyt, match, insert,
                                             params), reps=3)
    plain_b = time_cuda(lambda: pc.bwd_post_plain(x, y, lxt, lyt, match,
                                                  insert, params, tot, fm),
                        reps=3)
    # bytes this run's pairs need: the real codes, both lengths and the
    # tables in; kernel A writes the M lattice's real cells (rows past lx
    # and lanes past ly are never read) and the final states, kernel B
    # reads those cells and the totals and writes the dense (B, Lx, Ly)
    # posterior, zeros included, and the MEA scores
    inputs = 4 * (float(lx.sum()) + float(ly.sum()) + 2 * b
                  + kk * kk + kk + 16)
    real_lattice = 4 * cells
    bnd_a = bound_ms(inputs + real_lattice + 4 * 5 * b,
                     cells * FWD_OPS_PER_CELL)
    bnd_b = bound_ms(inputs + 4 * b + real_lattice
                     + 4 * b * width * width + 4 * b,
                     cells * BWD_POST_OPS_PER_CELL)
    print(f"kernel A {ms_a:.3f} ms (twin {plain_a:.1f} ms, bound "
          f"{bnd_a[0]:.3f} ms by {bnd_a[1]}); kernel B {ms_b:.3f} ms (twin "
          f"{plain_b:.1f} ms, bound {bnd_b[0]:.3f} ms by {bnd_b[1]}); "
          f"{b} pairs, {cells:.0f} real cells", flush=True)
    if not (ok_a and ok_b):
        raise SmokeFailure("a kernel disagrees with its twin")
    return [
        {"name": "pairhmm_fwd", "route": "cuda",
         "source": "muscle_tpu_torch/csrc/pairhmm_fwd.cu",
         "replaces": "muscle_tpu/ops/pairhmm_pallas.py:304",
         "launches": 0, "max_abs_err": err_a, "ms": ms_a,
         "plain_ms": plain_a, "bound_ms": bnd_a[0], "bound_by": bnd_a[1],
         "library_ms": None},
        {"name": "pairhmm_bwd_post", "route": "cuda",
         "source": "muscle_tpu_torch/csrc/pairhmm_bwd_post.cu",
         "replaces": "muscle_tpu/ops/pairhmm_pallas.py:565",
         "launches": 0, "max_abs_err": err_b, "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bnd_b[0], "bound_by": bnd_b[1],
         "library_ms": None},
    ]


def check_alignment(inp, msa, name):
    """Same labels, equal row widths, each row degapped = its input."""
    want = {s.label: s.text() for s in inp}
    got = {s.label: s.text() for s in msa}
    if len(msa) != len(inp) or set(got) != set(want):
        raise SmokeFailure(f"{name}: output labels differ from the input")
    if len({len(t) for t in got.values()}) != 1:
        raise SmokeFailure(f"{name}: rows of unequal width")
    for lb, t in got.items():
        if t.replace("-", "") != want[lb]:
            raise SmokeFailure(f"{name}: row {lb} is not its input")


def q_score(test, ref) -> float:
    """Fraction of the reference's aligned residue pairs that the test
    alignment also aligns (BAliBASE Q)."""
    def res_index(msa):
        out = {}
        for s in msa:
            t = np.frombuffer(s.text().encode(), np.uint8)
            res = t != ord("-")
            out[s.label] = np.where(res, np.cumsum(res) - 1, -1)
        return out
    rt, rr = res_index(test), res_index(ref)
    labels = list(rr)
    hit = total = 0
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            def pairs(r):
                m = (r[a] >= 0) & (r[b] >= 0)
                return set(zip(r[a][m].tolist(), r[b][m].tolist()))
            ref_pairs = pairs(rr)
            hit += len(ref_pairs & pairs(rt))
            total += len(ref_pairs)
    return hit / max(total, 1)


def launches_snapshot():
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    return dict(pc.LAUNCHES)


def phase_families(dev) -> dict:
    from muscle_tpu_torch import MultiSequence, align
    results = {}
    for name, inp, strip, golden in FAMILIES:
        seqs = MultiSequence.from_fasta(os.path.join(ROOT, inp),
                                        strip_gaps=strip)
        gold = MultiSequence.from_fasta(os.path.join(ROOT, golden))
        before = launches_snapshot()
        t0 = time.perf_counter()
        msa = align(seqs, device=dev)
        wall = time.perf_counter() - t0
        check_alignment(seqs, msa, name)
        after = launches_snapshot()
        if any(after[k] <= before[k] for k in after):
            raise SmokeFailure(f"{name}: a kernel was not launched")
        same = ({s.label: s.text() for s in msa}
                == {s.label: s.text() for s in gold})
        q = q_score(msa, gold)
        results[name] = {"n": len(seqs), "identical": same, "q": q,
                         "wall_s": wall}
        print(f"family {name}: n={len(seqs)} column-identical={same} "
              f"Q={q:.4f} wall={wall:.2f}s", flush=True)
    if not results["BB11001"]["identical"]:
        raise SmokeFailure("BB11001 is not column-identical to its golden")
    # the bucketed all-pairs store: n = 2, and -consiters 0
    bb = MultiSequence.from_fasta(os.path.join(ROOT, FAMILIES[0][1]),
                                  strip_gaps=True)
    for name, seqs, iters in (("BB11001 first two", MultiSequence(list(bb)[:2]), 2),
                              ("BB11001 consiters 0", bb, 0)):
        before = launches_snapshot()
        msa = align(seqs, consistency_iters=iters, device=dev)
        check_alignment(seqs, msa, name)
        after = launches_snapshot()
        if any(after[k] <= before[k] for k in after):
            raise SmokeFailure(f"{name}: a kernel was not launched")
        print(f"family {name}: valid alignment, width {msa.col_count()}",
              flush=True)
    return results


def synthetic_family(n=32, lo=400, hi=512, seed=32):
    """Mutated copies of one random protein (tests/test_devjoin.py)."""
    from muscle_tpu_torch import MultiSequence, Sequence
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=hi)
    aas = b"ARNDCQEGHILKMFPSTWYV"
    seqs = MultiSequence()
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        mut = base[:ln].copy()
        nmut = int(rng.integers(0, ln // 3))
        pos = rng.integers(0, ln, size=nmut)
        mut[pos] = rng.integers(0, 20, size=nmut)
        seqs.add(Sequence(f"s{i}", bytes(aas[c] for c in mut)))
    return seqs


def phase_realistic(dev) -> dict:
    import torch
    from muscle_tpu_torch import align
    from muscle_tpu_torch.utils import logging as mlog
    seqs = synthetic_family()
    mlog.STAGE_TIMES.clear()
    torch.cuda.reset_peak_memory_stats()
    before = launches_snapshot()
    t0 = time.perf_counter()
    msa = align(seqs, device=dev)
    wall = time.perf_counter() - t0
    check_alignment(seqs, msa, "synthetic n=32")
    after = launches_snapshot()
    if any(after[k] <= before[k] for k in after):
        raise SmokeFailure("n=32 family: a kernel was not launched")
    peak = torch.cuda.max_memory_allocated()
    stages = {k: round(v, 4) for k, v in mlog.STAGE_TIMES.items()}
    print(f"family synthetic n=32 L=400-512: wall={wall:.2f}s "
          f"width={msa.col_count()} peak_device_mem={peak / 2**30:.3f} GiB "
          f"stages={json.dumps(stages)} "
          f"launches={json.dumps({k: after[k] - before[k] for k in after})}",
          flush=True)
    return {"wall_s": wall, "peak_bytes": peak, "stages": stages}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from muscle_tpu_torch import native
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.utils.build import build_all

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = build_all()
    print(f"build: {len(built)} libraries in {time.perf_counter() - t0:.1f}s; "
          f"native host library loaded: {native.loaded()}", flush=True)
    dev = torch.device("cuda")

    kernels = phase_kernels(dev)

    pc.reset_launches()
    phase_families(dev)
    phase_realistic(dev)
    for k in kernels:
        k["launches"] = pc.LAUNCHES[k["name"]]
        if k["launches"] <= 0:
            raise SmokeFailure(f"{k['name']} never launched on the main path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
