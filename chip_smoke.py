#!/usr/bin/env python3
"""Smoke run of muscle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. print the card (nvidia-smi name and power limit), build the CUDA
   kernels and the native host library from the sources in this
   checkout, all at once, timing the build;
2. hold each kernel against its plain torch version on the card at the
   main path's shapes, and time kernel, plain version and (where one
   exists) the one torch call computing the same function with CUDA
   events: pair-HMM forward and backward+posterior at B = 512 ragged
   amino pairs padded to 512; densify (one shared-memory tile a block,
   written once) on one z-tile of the n = 200 Gram panel (blk = 16, L =
   512, K = 24) and on one of long mixed's f32 panel (n = 6, L = 12288,
   one sequence a block), each in f32 and bf16; densify-reduce
   (kernel 7) on a 100 x 100 join grid (L = 512, k2 = 24, cc = 768),
   with its launch geometry, the ptxas registers and spills of kernels
   7/7L, and the time of the one-hot contraction that consumes the same
   half (DeviceJoiner._half's product, TF32 off; timed only); the MEA
   direction DP (a skewed wavefront over the rows) at 768 x 768 on a
   random and a tie-heavy posterior and at the odd shapes
   MEA_ODD_SHAPES, each random and tie-heavy, all required equal, its
   time beside its time before the redesign and its dependency floor
   (mea_floor_ms). Then the long-pair kernels, each required equal to
   its plain version: kernels A/B at Ly = 2176-10240 (2 pairs, Lx 192;
   every segment geometry S = 2..5 and every rung the long families
   launch them at) on both schedules (one block a pair; the wave, each
   pair's row as a skewed wavefront of groups of G segments across SMs,
   at the geometry's G and at G = 1), with the ptxas registers and
   spills of every instance, the Y-striped kernels 5/6 (one launch a pass, every
   stripe as a skewed wavefront of groups of G warps) against their
   whole-pass twins on 8 ragged pairs (Lx 512, By = 2 x 2048) at the
   geometry's G and at G = 1 and 32, each pass bounded in wall time
   (STRIPE_PASS_LIMIT_S) and by the kernels' own watchdog; their ptxas
   registers and spills; the whole striped route on a 9000 x 8950 pair
   (5 stripes) held to kernels A/B at the kernel gate; and their times
   at the long families' shapes (A/B on one 11000 x 9800 pair at 11264 x
   10240 on the wave and on one block, beside the times before the wave
   and its dependency floor; one whole pass of 5 and of 6 on the 19000 x 18900 nt pair, 10
   stripes, at every G, beside the bound and the dependency floor,
   row_floor_ms); then densify-reduce's
   list variant (kernel 7L) on 2,000 pairs sampled from a 128 x 128-row
   join over a random store (L = 384, k2 = 24, cc = 600), required
   equal; then the Muscle-3D kernels (ops/pairhmm_emis_cuda.py), each
   required equal to its plain version: 1E and 2E at mega-128's bucket
   (256 pairs at 384), and on a letter lattice equal to kernels A/B (at
   384, one block a pair, and at 4096, 1E and A on the wave, every real
   cell of fm); 1E, 3 and 4 on mega-long's chunk (8 x 12288², 1E and 3
   on the wave: 1E's first 128 rows of each pair against the plain
   version on those rows, 3's rows u < 128 against the plain version on
   each pair's last 128 rows of x and its rows u >= lx against zero, 4
   (a wavefront of row bands, a round of bands a block) on the whole
   posterior); their ptxas registers and spills and their times at
   those shapes (1E's, 3's and 4's beside their times before the wave
   and their dependency floors); the fused route against the legacy
   route on 8 mega pairs at 2048, at the kernel gate; then the
   ensembles' kernels (phase_ensemble_kernels): 1M and 2M (per-pair
   tables) at B = 512, L = 512 with the packs of 4 perturbation seeds
   mixed lane by lane, each against its plain version and each lane
   against kernels A/B on its pack, 1E/2E with per-pair params on the
   per-pair lattice against 1M/2M, 3K (the letter path's legacy
   backward; one block a pair at 512) against its plain version on the
   real cells and the zero rows u >= lx, all required equal, the
   legacy letter route (1M, 3K, finish_posteriors, 4) against the fused
   one at the kernel gate, and kernel 4 on that route's posteriors
   against its plain version; then 3K on the wave (BWD_CODES_WIDE: 4
   pairs at 4096) held as kernel 3 is (hold_bwd_codes); their ptxas
   lines, times (kernels 4 and 3K steady: steady_ms, beside their times
   one block a pair before, MEA_SCORES_WAS_MS and BWD_CODES_WAS_MS) and
   bounds; then the DP scans of Super6 / Super7 (phase_dp_kernels):
   nw_viterbi and sw_scores against their plain versions at 64 ragged
   amino pairs at pads 384 and 2048 (one column a thread, and several;
   NW's bits equal, final rows and scores max |d| = 0, SW's scores max
   |d| = 0), their ptxas lines, times and bounds (dp_bound);
3. drive the main path, `muscle_tpu_torch.align(..., device="cuda")`
   with default settings, checking each output is an alignment of its
   input and that each kernel its branch runs was launched (counts set
   to 0 just before each call, read just after); the first HELD_GRID
   kernel-7 and mea_dirs launches of each device refine (n = 70, n =
   200, mega-128, synthetic-1000's Super4 clusters) and the mea_dirs
   launch of every PProg device join held, as they happen, to the plain
   versions on their own inputs and timed there (GridKernelCheck,
   MeaDirsCheck), the checks' time and memory kept out of the walls and
   peaks; mea_dirs' launches counted by (cc1, cc2) rung:
   - every in-repo family (the degapped tests/goldens/BB1100*.seq.afa
     and tests/data/nt/nt*.fa), printing whether it is column-identical
     to its golden and its Q against it, requiring BB11001 to be
     column-identical (and the n = 2 and -consiters 0 branch on
     BB11001);
   - synthetic families (mutated copies of one random protein):
     n = 32, lengths 400-512 (top of the dense branch, host refine);
     n = 70, lengths 100-128 (dense consistency + device refine), run
     again with host refine and required to give the same alignment;
     n = 24, lengths 700-1000 (blocked f32 Gram consistency + host
     refine); n = 200, lengths 400-512 (blocked bf16 Gram consistency +
     device refine, full width), printing stage walls, peak device
     memory and launches (tools/torch_profile_align.py splits the
     device time by kernel);
   - the long families at full length through the long-pair router,
     each required to take its routes: "long mixed", six proteins of
     8,700-11,000 residues (7 pairs on kernels A/B, one at Ly = 10240,
     5 transposed, 3 on the striped kernels; pad 12288, blocked f32 Gram
     consistency with one sequence a block, host refine cut to 20
     iterations); "long pair", two ~19 kb nucleotide sequences on the
     striped kernels (10 stripes); each required to make one launch of
     kernel 5 and one of kernel 6 a striped group (STRIPED_GROUPS), the
     launches of kernels A/B by schedule and width and long mixed's
     wall and posteriors stage printed (beside its wall before the
     wave), the
     sha256 of each alignment's FASTA text printed and required to be
     LONG_FAMILY_SHA256, the text before kernels 5/6 ran as one launch
     a pass (tools/torch_long_family_sha.py prints it for another
     commit's package);
   - `muscle_tpu_torch.super5(..., device="cuda")` with default
     settings: on the degapped tests/goldens/rdrp_sub16.super5.afa,
     required column-identical to that golden by label (Q printed); on
     synthetic-1000 (super5_set: 1,000 proteins, 4 families of 150 and
     8 of 50, with duplicates and near-duplicates), required to be a
     valid alignment with identical duplicate rows that removed
     duplicates, extended UCLUST members by TransAln, made more than
     one Super4 cluster and one of 64 or more (kernels 7 and mea_dirs),
     and ran PProg joins on the device (kernel 7L); every kernel-7L
     launch held, as it happens, to its plain version on the same inputs
     (max |d| = 0) and timed there, the checks' time and memory kept
     out of the walls and the peak; stage walls, peak device memory,
     the run's counts and launches printed;
   - `align(seqs, mega=...)` on three synthetic 8-feature `.mega` sets
     built from a seed by tests/mega_synth.py, written and parsed
     through the port (mega_set):
     mega-8 (dense, kernels 1E/2E; required column-identical to the
     port's CPU alignment of the same file), mega-128 (sparse store,
     bf16 Gram, device refine), mega-long (4 chains of 8,300-9,800
     residues, pad 12288: the legacy route, kernels 1E/3/4, refine cut to
     MEGA_LONG_REFINE_ITERS; each launch of 1E, 3 and 4 held, as it
     happens, to the plain versions on its own inputs as in phase 2, the
     checks' time and memory kept out of the wall and the peak; the
     sha256 of its FASTA text required to be MEGA_LONG_SHA256, the text
     before 1E ran on the wave), each
     route counted and required, Q against the construction's true
     alignment printed;
   - the ensembles through `pipeline.ensemble.run_align_command`, the
     function the CLI calls (phase_ensembles): ensemble-48 (a synthetic
     protein family of n = 48, L 300-384, pad 384, under -stratified: 16
     replicates, 4 seeds in one pair stage of 4,512 lanes, Gram
     consistency and host refine per replicate; its none.0 must equal
     align() of the same family), diversified-BB11002 (the degapped
     golden under -diversified: 100 replicates, 100 HMMs in one stream;
     none.0's identity to the golden and Q printed), every launch of
     kernels 1M and 2M held, as it happens, lane by lane to kernels A/B
     on each pack's lanes (MultiKernelCheck; the checks' launches, time
     and memory kept out), every replicate required to be an alignment
     of its input, -maxcc, -disperse and -efastats of each EFA printed;
     legacy-BB11001 (align() under the legacy letter route, fused=False:
     kernels A, 3K and 4; each 3K and 4 launch held to its plain
     version; whether its text equals the fused route's printed);
   - Super6 and Super7 (phase_super67): -protdists through the CLI on
     the degapped BB11001 golden (each distance within 5e-4 of the
     reference binary's, REF_PROTDISTS); through run_align_command,
     Super6 with default settings on super5_set()'s first SUPER6_ROWS
     rows, Super7 on mega-128 (shrub_size 32, the SW tree; Q against the
     truth), on mega-8 at shrub_size 3 (the card's text required equal
     to the port's CPU text) and on the degapped rdrp-16 golden at
     shrub_size RDRP16_SHRUB; each required to be an alignment of its
     input through nw_viterbi / sw_scores and the pair-HMM kernels, the
     first HELD_DP launches of each DP kernel in each run held, as they
     happen, to the plain versions (DpCheck), stage walls, the runs'
     cluster sizes, peak device memory and launches printed;
   - the rest of the CLI and API surface (phase_surface): -eadistmx,
     -uclust and -transaln through the CLI, align(random_chain_tree=
     True) and the greedy PProg.run over rdrp-16's single rows, each
     required equal to the port's CPU text (-uclust's and the greedy
     run's CPU texts from a child process, `chip_smoke.py --cpu-refs
     DIR`, started after the build: they take minutes on the plain
     versions); -testfb on BB11004 (exit 0, its kernel-A and 3K launches
     held to the plain versions, 3K with its corner output); 3K at phase
     2's shape with its corner output off and on, both timed;
     align(sparse_k=16, batch_size=64) on a repeat-rich family of n = 70
     whose store keeps 16 slots a row (kernel 8's first launch and
     kernel 7's held ones equal to the plain versions); each host-only
     command once, its wall printed;
4. one 512 x 480 pair through the checkpoint/recompute scan on the
   card, held to kernels A/B at the kernel gate;
5. print kernels 7L's and 7's times summed over their held main-path
   launches, then the kernels' JSON line (launch counts summed over
   phase 3, kernels A/B's, 1E's, 3's and 3K's also by schedule and
   width, with A/B's wave times and bounds at 11264 x 10240, 1E's time
   and bound at mega-long's chunk, 3K's on the wave at 4 x 4096 and 4's
   at 512 x 512² beside mega-long's chunk; kernel 8's times and bounds
   on the long tile; mea_dirs' by rung, with its held launches' summed
   time; kernel 7L's times and bound at
   synthetic-1000's largest device join; nw_viterbi's and sw_scores'
   times, plain times and bounds at pad 2048 beside 384, and their held
   launches;
   each max |d| over phase 2 and the launches held in phase 3; 3K's
   times at 512 with the corner output off and on),
   then the card line and the final {"ok": true, ...} line.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
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
# the legacy backward alone (kernel 3): 138; the MEA row scan (kernel 4):
# an add, the max with the old cell, the clamp at 0 and the running max
BWD_OPS_PER_CELL = 138
MEA_OPS_PER_CELL = 4

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


def real_cells(t, lx, ly):
    """t (B, Lx, Ly) with its cells outside each pair's (lx, ly) zeroed:
    the forward kernels (A, 1M, 1E) leave rows past lx and the 64-lane
    segments past column ly unwritten, and every reader masks them."""
    import torch
    r = torch.arange(t.shape[1], device=t.device)[None, :, None]
    c = torch.arange(t.shape[2], device=t.device)[None, None, :]
    return t.where((r < lx[:, None, None]) & (c < ly[:, None, None]), 0.0)


def time_cuda(fn, reps: int = 5, per: int = 1) -> float:
    """Median ms of one call over `reps` runs after one warm-up (CUDA
    events around `per` calls: for calls of well under a millisecond,
    per > 1 keeps the host's enqueue out of the device time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / per)
    return statistics.median(times)


def steady_ms(fn) -> float:
    """ms of one call at steady state: 20 calls first, then time_cuda
    with 5 calls between the events (the method of the redesigned
    kernels' times and of their parents' *_WAS_MS)."""
    for _ in range(20):
        fn()
    return time_cuda(fn, per=5)


def timed_once(fn):
    """(fn(), its ms by CUDA events around that one call): the plain
    versions, host-bound loops of seconds, are timed on the call that
    the kernel is held to (no repeat)."""
    import torch
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


# a striped pass (kernels 5, 6) that has not ended after this many
# seconds of wall time is a hang: the kernels' own watchdog ends a wait
# on a left neighbour after ops/pairhmm_striped.WAIT_LIMIT_NS (10 s)
STRIPE_PASS_LIMIT_S = 60.0


def bounded_pass(fn, what, dev):
    """Run one striped pass and wait for it, raising if it has not ended
    within STRIPE_PASS_LIMIT_S or if a wait in its hand-over passed the
    kernels' limit."""
    import torch
    from muscle_tpu_torch.ops import wavefront
    t0 = time.perf_counter()
    out = fn()
    done = torch.cuda.Event()
    done.record()
    while not done.query():
        if time.perf_counter() - t0 > STRIPE_PASS_LIMIT_S:
            raise SmokeFailure(f"{what}: no end after {STRIPE_PASS_LIMIT_S} "
                               "s (a hang in the hand-over)")
        time.sleep(0.001)
    try:
        wavefront.check_waits(dev)
    except RuntimeError as e:
        raise SmokeFailure(f"{what}: {e}") from e
    return out


@functools.cache
def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()
    return float(out[0]) * 1e6


# The dependency floor of kernels 5/6: a DP row (forward) or step
# (backward) is a serial chain, so a pass takes at least Lx times one
# row's critical path at G segments a group. Counted from the code
# (csrc/pairhmm_fwd_stripe.cu, pairhmm_bwd_stripe.cu,
# pairhmm_common.cuh): LOG_ADD is 15 dependent f32 operations (max/min,
# sub, clamp 2, compare, 2 selects, 3 mul + 3 add, add, select), the
# scans' LOG_ADD_p 21 (max/min, sub, min, 8 mul + 8 add, add, select).
# Forward: the five-way fold (4 LOG_ADD + an add = 61), the emission add
# and c's 2 adds (3), six scan rounds (select + add + LOG_ADD_p = 23
# each, 138), the carry chain (G steps of add + LOG_ADD_p = 22), the
# combine (22): 224 + 22 G operations, 8 shuffles, 4 shared-memory round
# trips, 4 barriers. Backward: the M shift add and c's add (2), the
# scans (138), the chain (22 G), the IY/JY combine (22), the shift adds
# and the five-way M fold (2 + 61), the posterior and MEA row (~30): 255
# + 22 G operations, 15 shuffles, 4 shared-memory round trips, 5
# barriers. Latencies assumed for Hopper: 4 cycles a dependent f32
# operation, 24 a shuffle, 30 a shared-memory round trip, 24 a barrier;
# at the card's highest SM clock.
ROW_FLOOR = {False: (224, 8, 4, 4), True: (255, 15, 4, 5)}
# kernel 3's step (csrc/pairhmm_wave.cuh with kLegacy): the backward's
# without the posterior and MEA row (~30 operations, 6 shuffles, a
# shared-memory round trip and a barrier fewer)
LEGACY_FLOOR = (225, 9, 4, 4)


def row_floor_ms(rows, g, clock_hz, backward, counts=None) -> float:
    ops, shfl, smem, bars = counts or ROW_FLOOR[backward]
    cycles = 4 * (ops + 22 * g) + 24 * shfl + 30 * smem + 24 * bars
    return rows * cycles / clock_hz * 1e3


# The dependency floor of mea_dirs (csrc/mea_dirs.cu): lane t of band k
# computes column j at band step j + t; at the start of each run of HAND
# steps the warp takes the band above's next HAND columns, the last of
# which lane 31 there wrote HAND + 30 steps later (so band k starts
# HAND + 31 steps after band k - 1), or, for warp 0 in a later round,
# from the link row, published every LINK_HAND columns and staged before
# its first window (min(LINK_HAND, cc2) + 31 steps after the band
# above); a warp starts its next band when its band before has run its
# windows of steps. A step's chain: a shuffle (24 cycles) and three
# dependent f32 operations (lane 0's select, two max: 4 each), at the
# card's highest SM clock.
MEA_STEP_CYCLES = 24 + 3 * 4


def mea_floor_steps(cc1: int, cc2: int) -> int:
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    nb, w = -(-cc1 // 32), djc.mea_warps(cc1)
    band_steps = -(-(cc2 + 31) // djc.MEA_CHUNK) * djc.MEA_CHUNK
    start = [0]
    for k in range(1, nb):
        lag = (djc.MEA_HAND + 31 if k % w
               else min(djc.MEA_LINK_HAND, cc2) + 31)
        s = start[k - 1] + lag
        if k >= w:
            s = max(s, start[k - w] + band_steps)
        start.append(s)
    return start[-1] + band_steps


def mea_floor_ms(cc1: int, cc2: int, clock_hz: float) -> float:
    return mea_floor_steps(cc1, cc2) * MEA_STEP_CYCLES / clock_hz * 1e3


# The dependency floor of kernel 4 (csrc/mea_scores.cu): as mea_dirs'
# chain, each warp one band: band k starts HAND + 31 steps after band k -
# 1 inside a block; warp 0 of the next round (another block) once the
# link row's count covers the chunks it stages before its first window's
# steps ((AHEAD + 1) CHUNK columns, published every LINK_HAND columns),
# so that many steps of the band above later; the last band then runs
# its ly + 31 steps (whole windows).
def mea_scores_floor_steps(lx: int, ly: int, warps: int) -> int:
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    cw = djc.MEA_CHUNK
    need = min((djc.MEA_AHEAD + 1) * cw, ly)
    s0 = 0
    while True:   # the producer's window that publishes `need` columns
        linked = min(max(s0 + cw - 31, 0), ly)
        if linked >= need and ((s0 // cw) % (pe.MEA_SCORES_LINK_HAND // cw)
                               == pe.MEA_SCORES_LINK_HAND // cw - 1
                               or (linked == ly and s0 - 31 < ly)):
            break
        s0 += cw
    nb = -(-lx // 32)
    lags = sum(djc.MEA_HAND + 31 if k % warps else s0 + cw
               for k in range(1, nb))
    return lags + -(-(ly + 31) // cw) * cw


def mea_scores_floor_ms(lxb, lyb, warps: int, clock_hz: float) -> float:
    """The largest floor over the launch's pairs, at MEA_STEP_CYCLES a
    step and the card's highest SM clock."""
    steps = max(mea_scores_floor_steps(a, b, warps)
                for a, b in zip(lxb.tolist(), lyb.tolist()))
    return steps * MEA_STEP_CYCLES / clock_hz * 1e3


def tie_heavy(shape, seed, dev):
    """A posterior of mostly zeros with values from {0.25, 0.5}, like a
    real summed column posterior: most cells tie (b = x = y), so the tie
    order B, X, Y decides the path."""
    import torch
    rng = np.random.default_rng(seed)
    vals = np.float32([0, 0, 0, 0, 0, 0, 0.25, 0.5])
    return torch.as_tensor(rng.choice(vals, size=shape), device=dev)


# mea_dirs' shapes held in phase 2 beside 768 x 768: one row, a row of
# one word, odd widths, the bands of a 1100-row join wrapping past the
# 16 warps (the link row)
MEA_ODD_SHAPES = ((1, 33), (23, 16), (40, 57), (130, 150), (767, 769),
                  (1100, 300))
# mea_dirs and kernel 3 before their redesign (PERF.md, NVIDIA H100 80GB
# HBM3 at 700 W): 768 x 768, one block a join; mega-long's chunk, one
# block a pair
MEA_WAS_MS, BWD_WAS_MS = 1.043, 596.4
# kernels 4 and 3K before their redesign (one block a pair), at the shapes
# phases 2 times them (mega-long's chunk and B = 512 at 512; 512 pairs at
# 512 and 4 at 4096), steady_ms in the same call as the redesign
# (tools/torch_mea_bwd_probe.py --time --parent, NVIDIA H100 80GB HBM3 at
# 700 W)
MEA_SCORES_WAS_MS = {12288: 16.17, 512: 0.371}
BWD_CODES_WAS_MS = {512: 3.483, 4096: 81.37}


# calls between the events when timing kernels 7/7L and their yardsticks
# (0.04-0.3 ms a call: one call alone would time the host's enqueue)
DR_PER = 20


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
    (fm2, fend2), plain_a = timed_once(
        lambda: pc.fwd_plain(x, y, lxt, lyt, match, insert, params))
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
    (post2, mea2), plain_b = timed_once(
        lambda: pc.bwd_post_plain(x, y, lxt, lyt, match, insert, params, tot,
                                  fm))
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

    # 5 launches between the events: the wrapper's host time (~0.05-0.25
    # ms a call, before its launch) stays out of the kernels' time
    ms_a = time_cuda(lambda: pc.pairhmm_fwd(x, y, lxt, lyt, match, insert,
                                            params), per=5)
    ms_b = time_cuda(lambda: pc.pairhmm_bwd_post(x, y, lxt, lyt, match,
                                                 insert, params, tot, fm),
                     per=5)
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
          f"{bnd_a[0]:.3f} ms by {bnd_a[1]}; was {AB_WAS_MS['A_512']} ms); "
          f"kernel B {ms_b:.3f} ms (twin {plain_b:.1f} ms, bound "
          f"{bnd_b[0]:.3f} ms by {bnd_b[1]}; was {AB_WAS_MS['B_512']} ms); "
          f"{b} pairs, {cells:.0f} real cells, schedule "
          f"{pc.ab_geometry(b, width).schedule}", flush=True)
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


def ptxas_lines(names) -> list[str]:
    """Registers and spills of each kernel instantiation of the libraries
    `names`, from the ptxas report kept in their build logs."""
    import re
    from muscle_tpu_torch.ops import (devjoin_cuda, dp_cuda, pairhmm_cuda,
                                      pairhmm_emis_cuda, pairhmm_striped)
    from muscle_tpu_torch.utils.build import build_log
    specs = (pairhmm_cuda.kernel_specs() + pairhmm_striped.kernel_specs()
             + pairhmm_emis_cuda.kernel_specs() + devjoin_cuda.kernel_specs()
             + dp_cuda.kernel_specs())
    out = []
    for name in names:
        cur, spill = None, ""
        for line in build_log(name, specs).splitlines():
            m = re.search(r"Compiling entry function '\w*(nw_viterbi_kernel|"
                          r"sw_scores_kernel)ILi(\d+)E", line)
            if m:  # csrc/dp_rows.cuh's C columns a thread
                cur = f"{m.group(1)}<C={m.group(2)}>"
                continue
            m = re.search(r"Compiling entry function '_ZN2dr(\d+)(\w+)'",
                          line)
            if m:  # kernels 7/7L: dr::densify_reduce_kernel<Source>
                src = m.group(2)[int(m.group(1)):]
                cur = (m.group(2)[:int(m.group(1))] + "<"
                       + ("GridRows" if "GridRows" in src else "ListRuns")
                       + ">")
                continue
            m = re.search(r"Compiling entry function '\w*mea_dirs_kernel"
                          r"ILb([01])E", line)
            if m:  # in an unnamed namespace: its mangling varies
                cur = f"mea_dirs_kernel<{16 if m.group(1) == '1' else 4}" \
                      "-byte copies>"
                continue
            if re.search(r"Compiling entry function '\w*mea_scores_kernel",
                         line):  # kernel 4, in an unnamed namespace too
                cur = "mea_scores_kernel"
                continue
            m = re.search(r"Compiling entry function '_Z(?:N2ph)?(\d+)(\w+)'",
                          line)
            if m:
                cur = m.group(2)[:int(m.group(1))]
                rest = m.group(2)[int(m.group(1)):]
                t = re.match(r"ILi(\d+)E", rest)
                w = re.findall(r"Lb([01])E", rest)
                if "wave_kernel" in cur and w:  # pairhmm_wave.cuh
                    cur += ("<" + ("lattice read a row ahead"
                                   if "LatticeAhead" in rest else "lattice"
                                   if "LatticeEmission" in rest
                                   else "letters") + ", row 0 "
                            + ("in the launch" if w[0] == "1"
                               else "given")
                            + (", kernel 3's layout" if w[1:2] == ["1"]
                               else "")
                            + (", corner" if w[2:] == ["1"] else "") + ">")
                elif t:
                    src = (", lattice" if "LatticeEmission" in rest else
                           ", letters" if "CodeEmission" in rest else "")
                    # kernel 3K's block body: <S, Src, kCorner>
                    corner = (", corner" if cur == "pairhmm_bwd_kernel"
                              and re.search(r"Lb1E", rest) else "")
                    cur += f"<S={t.group(1)}{src}{corner}>"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                out.append(f"{cur}: {m.group(1)} registers, {spill}")
                cur = None
    return out


def batch_of(lengths_x, lengths_y, width_x, width_y, nletters, seed):
    """Random codes (wildcard-padded) for pairs of the given lengths."""
    rng = np.random.default_rng(seed)
    b = len(lengths_x)
    xb = np.full((b, width_x), nletters, np.int32)
    yb = np.full((b, width_y), nletters, np.int32)
    for i in range(b):
        xb[i, :lengths_x[i]] = rng.integers(0, nletters, lengths_x[i])
        yb[i, :lengths_y[i]] = rng.integers(0, nletters, lengths_y[i])
    return (xb, yb, np.asarray(lengths_x, np.int32),
            np.asarray(lengths_y, np.int32))


# kernels 5/6's check: 8 ragged pairs, Lx 512, By = 2 x 2048, padding
# inside either stripe, at its edge and one lane past it
STRIPE_CHECK_LX = (512, 500, 300, 512, 100, 450, 257, 511)
STRIPE_CHECK_LY = (4096, 4000, 2048, 2049, 1500, 3000, 4095, 100)


# widths of kernels A/B held against their twins beyond phase 2's 512:
# S = 2, S = 3 and S = 4 with 1 and 2 idle segment slots, S = 4 full, and
# the long families' rungs 8704, 9728 (S = 5, 4 and 3 idle slots) and
# 10240 (S = 5 full); phase_long_families fails on any other width
AB_CHECK_WIDTHS = (2176, 4352, 6272, 8192, 8704, 9728, 10240)

# kernels A/B at 11264 x 10240 and their holds at AB_CHECK_WIDTHS
# (phase_long_kernels), for the kernels line
AB_WIDE: dict = {}

# kernels A and B before the wave schedule (PERF.md rows 1-2, the commit
# before it, NVIDIA H100 80GB HBM3 at 700 W): phase 2's 512 shape, and
# one 11000 x 9800 pair at 11264 x 10240 on one block
AB_WAS_MS = {"A_512": 3.679, "B_512": 3.863, "A_10240": 581.9,
             "B_10240": 752.3}
# (the 512 times were one launch between the events, the wrapper's host
# time in; tools/torch_ab_probe.py --rung512 --parent times that commit's
# kernels beside these with 5, as phase 2 now does)


def phase_long_kernels(dev) -> list[dict]:
    """Kernels A and B at the widths of AB_CHECK_WIDTHS, and kernels 5
    and 6 (Y-striped), against their plain versions (max |d| = 0
    required); the striped route against kernels A/B on one 9000-residue
    pair at the kernel gate; their times at the long families' shapes."""
    import torch
    from muscle_tpu_torch.alphabet import ALPHA_AMINO
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_striped as ps
    from muscle_tpu_torch.ops import sparse
    from muscle_tpu_torch.pipeline.posteriors import encode_batch

    for line in ptxas_lines(["pairhmm_fwd", "pairhmm_bwd_post",
                             "pairhmm_fwd_stripe", "pairhmm_bwd_stripe"]):
        print(f"ptxas: {line}", flush=True)
    amino = pc.tables(HMMParams.from_defaults(nucleo=False).to_scores(), dev)
    nt_pack = HMMParams.from_defaults(nucleo=True).to_scores()
    nt = pc.tables(nt_pack, dev)

    def cuda(*arrs):
        return tuple(torch.from_numpy(a).to(dev) for a in arrs)

    # kernels A/B against their twins at every segment geometry above
    # phase 2's (S = 2..5, with and without idle segment slots) and at
    # every rung the long families launch them at, under both schedules
    # (the block a pair, and the wave at the geometry's G and at G = 1):
    # 2 pairs, Lx 192, one pair at the full width, one with padding
    # across two segments; each wave launch bounded in wall time
    d_ab = 0.0
    for width in AB_CHECK_WIDTHS:
        x, y, lxt, lyt = cuda(*batch_of([192, 150], [width, width - 131],
                                        192, width, 20, seed=width))
        nseg = width // 64
        s_ = -(-nseg // 32)
        g_auto = pc.ab_geometry(2, width).g
        for sched, g in (("block", None), ("wave", g_auto), ("wave", 1)):
            def ab(sched=sched, g=g):
                fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, *amino,
                                          schedule=sched, g=g)
                tot = pc._total_prob(fend, amino[2])
                return fm, fend, tot, pc.pairhmm_bwd_post(
                    x, y, lxt, lyt, *amino, tot, fm, schedule=sched, g=g)
            what = f"kernels A/B at Ly = {width}, {sched} G = {g}"
            fm, fend, tot, (post, mea) = bounded_pass(ab, what, dev)
            fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, *amino)
            post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, *amino, tot, fm)
            torch.cuda.synchronize()
            d = max(float((real_cells(fm, lxt, lyt)
                           - real_cells(fm2, lxt, lyt)).abs().max()),
                    float((fend - fend2).abs().max()),
                    float((post - post2).abs().max()),
                    float((mea - mea2).abs().max()))
            d_ab = max(d_ab, d)
            geo = (f"S={s_}, {-(-nseg // s_)} warps, "
                   f"{-(-nseg // s_) * s_ - nseg} idle segment slots"
                   if sched == "block" else
                   f"G={g}, {nseg // g} groups a pair")
            print(f"kernels A/B at Ly={width} {sched} ({geo}; 2 pairs, Lx "
                  f"192) vs twins: max |d| {d:.3e} "
                  f"{'equal' if d == 0 else 'FAIL'}", flush=True)
            if d != 0:
                raise SmokeFailure(f"kernels A/B at Ly = {width} ({sched}, "
                                   f"G = {g}) differ from their twins")
            del fm, fm2, post, post2

    # their time at the long mixed family's in-cap rung (one pair
    # 11000 x 9800, padded 11264 x 10240), on the router's schedule (the
    # wave) and on one block a pair, beside the times before the wave
    # (PERF.md rows 1-2, AB_WAS_MS) and the wave's dependency
    # floor (Lx times one row's critical path at its G)
    x, y, lxt, lyt = cuda(*batch_of([11000], [9800], 11264, 10240, 20,
                                    seed=11))
    geo = pc.ab_geometry(1, 10240)
    wide = {}
    for sched, reps in ((geo.schedule, 5), ("block", 1)):
        fm, fend = bounded_pass(lambda: pc.pairhmm_fwd(
            x, y, lxt, lyt, *amino, schedule=sched), f"kernel A, {sched}",
            dev)
        tot = pc._total_prob(fend, amino[2])
        ms_a = time_cuda(lambda: pc.pairhmm_fwd(x, y, lxt, lyt, *amino,
                                                schedule=sched), reps=reps)
        ms_b = time_cuda(lambda: pc.pairhmm_bwd_post(
            x, y, lxt, lyt, *amino, tot, fm, schedule=sched), reps=reps)
        pc.wavefront.check_waits(dev)
        wide[sched] = (ms_a, ms_b)
        del fm
    cells = 11000.0 * 9800.0
    bnd_a = bound_ms(4 * (11000 + 9800 + cells + 5), cells * FWD_OPS_PER_CELL)
    bnd_b = bound_ms(4 * (11000 + 9800 + cells + 11264 * 10240),
                     cells * BWD_POST_OPS_PER_CELL)
    clock = max_sm_clock_hz()
    ms_a, ms_b = wide[geo.schedule]
    print(f"kernels A/B at 11264 x 10240 (one pair 11000 x 9800), "
          f"{geo.schedule} G = {geo.g} ({geo.groups} groups): A {ms_a:.3f} "
          f"ms (bound {bnd_a[0]:.4f} ms by {bnd_a[1]}, dependency floor "
          f"{row_floor_ms(11000, geo.g, clock, False):.2f} ms; was "
          f"{AB_WAS_MS['A_10240']} ms), B {ms_b:.3f} ms (bound "
          f"{bnd_b[0]:.4f} ms by {bnd_b[1]}, dependency floor "
          f"{row_floor_ms(11000, geo.g, clock, True):.2f} ms; was "
          f"{AB_WAS_MS['B_10240']} ms); one block a pair in this run: A "
          f"{wide['block'][0]:.3f} ms, B {wide['block'][1]:.3f} ms; "
          f"{AB_WAS_MS['A_10240'] / ms_a:.1f}x / "
          f"{AB_WAS_MS['B_10240'] / ms_b:.1f}x the times before", flush=True)
    AB_WIDE.update(ms=(ms_a, ms_b), bound=(bnd_a[0], bnd_b[0]),
                   block_ms=wide["block"], max_abs_err=d_ab, g=geo.g)

    # kernels 5/6 (one launch a pass) vs their whole-pass twins on 8
    # ragged pairs, Lx 512, By = 2 x 2048, at the geometry's G and at G =
    # 1 and 32, every pass bounded in wall time
    w = ps.MAX_W
    args = cuda(*batch_of(STRIPE_CHECK_LX, STRIPE_CHECK_LY, 512, 2 * w, 20,
                          seed=2048)) + amino
    match, insert, params = amino
    iy0, jy0, iy0b, jy0b = ps.row0_closed_forms(args[1], args[3], insert,
                                                params)
    t0 = time.perf_counter()
    fm2, fend2 = ps.fwd_striped_plain(*args, iy0, jy0, w)
    torch.cuda.synchronize()
    plain_f = (time.perf_counter() - t0) * 1e3
    tot = pc._total_prob(fend2, params).contiguous()
    t0 = time.perf_counter()
    post2, mea2 = ps.bwd_striped_plain(*args, tot, iy0b, jy0b, fm2.clone(),
                                       w)
    torch.cuda.synchronize()
    plain_b = (time.perf_counter() - t0) * 1e3
    g_check = ps._geometry(len(STRIPE_CHECK_LX), 2 * w, w).g
    d_st = 0.0
    for g in sorted({g_check, 1, 32}):
        fm, fend = bounded_pass(lambda: ps.pairhmm_fwd_striped(
            *args, iy0, jy0, w, g), f"kernel 5 at G = {g}", dev)
        d5 = max(float((fm - fm2).abs().max()),
                 float((fend - fend2).abs().max()))
        post, mea = bounded_pass(lambda: ps.pairhmm_bwd_striped(
            *args, tot, iy0b, jy0b, fm2.clone(), w, g), f"kernel 6 at G = {g}",
            dev)
        d6 = max(float((post - post2).abs().max()),
                 float((mea - mea2).abs().max()))
        d_st = max(d_st, d5, d6)
        chosen = " (the geometry's)" if g == g_check else ""
        print(f"kernels 5/6 (pairhmm_fwd_stripe, pairhmm_bwd_stripe; one "
              f"launch a pass) vs whole-pass twins (8 pairs, Lx 512, By 2 x "
              f"{w}) at G = {g}{chosen}: max |d| {d5:.3e} / {d6:.3e} "
              f"{'equal' if d5 == d6 == 0 else 'FAIL'}", flush=True)
        del fm, post
    print(f"kernels 5/6's twins there: {plain_f:.1f} / {plain_b:.1f} ms",
          flush=True)
    if d_st != 0:
        raise SmokeFailure("a striped kernel differs from its plain version")
    del fm2, post2

    # the whole striped route (row-0 forms, pass A's chained stripes, the
    # final-state max, pass B, the top-K merge, EA) against kernels A/B +
    # sparsify on one pair of the long families' band: 9000 x 8950
    # residues padded 9216 x 10240, 5 stripes of 2048
    seqs = family_of_lengths((9000, 8950), AMINO_LETTERS, 9)
    codes, lens = encode_batch(seqs, ALPHA_AMINO)
    xb = np.full((1, 9216), 20, np.int32)
    yb = np.full((1, 10240), 20, np.int32)
    xb[0, :lens[0]] = codes[0][:lens[0]]
    yb[0, :lens[1]] = codes[1][:lens[1]]
    pair = cuda(xb, yb, lens[:1], lens[1:])
    pack = HMMParams.from_defaults(nucleo=False).to_scores()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, cols, ea_s, nnz_s = ps.striped_posteriors_sparse(*pair, pack, k=32,
                                                           stripe_w=w)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    post, ea_k = pc.batch_posteriors_cuda(*pair, pack)
    kv, kc, nnz_k = sparse.sparsify(post, 32)
    del post
    got = sparse.densify(vals, cols, 10240)
    want = sparse.densify(kv, kc, 10240)
    d = (got - want).abs()
    flip = ((got == 0) | (want == 0)) & (torch.maximum(got, want) <= 0.0102)
    d_post = float(d.where(~flip, 0.0).max())
    d_ea = float((ea_s - ea_k).abs().max())
    ok = d_post < 2e-3 and d_ea < 2e-3
    print(f"striped route (5 stripes of {w}) vs kernels A/B at 10240 on a "
          f"9000 x 8950 pair: posterior {d_post:.3e} (flips ignored, tol "
          f"2e-3), EA {d_ea:.3e} (tol 2e-3), max nnz {nnz_s} / "
          f"{int(nnz_k)}, striped wall {wall_s:.2f}s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("the striped route disagrees with kernels A/B")
    del got, want, d, flip, vals, cols, kv, kc

    # their time at the long pair's shape: 19000 x 18900 nt, padded
    # 19456 x 20480 (10 stripes), one whole pass each, at every G (the
    # geometry's for B = 1 is the main path's)
    lx1, ly1, px, py = 19000, 18900, 19456, 10 * w
    x, y, lxt, lyt = cuda(*batch_of([lx1], [ly1], px, py, 4, seed=19))
    match, insert, params = nt
    iy0, jy0, iy0b, jy0b = ps.row0_closed_forms(y, lyt, insert, params)
    args = (x, y, lxt, lyt) + nt
    g_main = ps._geometry(1, py, w).g
    cells = float(lx1) * ly1
    # kernel 5: codes, the row-0 forms in; the real M cells and the final
    # states out
    bnd5 = bound_ms(4 * (lx1 + py + 2 * py + cells + 5),
                    cells * FWD_OPS_PER_CELL)
    # kernel 6: codes, row-0 forms, the real M cells in; the dense
    # posterior over the lattice and the MEA out
    bnd6 = bound_ms(4 * (lx1 + py + 2 * py + cells + px * py + 1),
                    cells * BWD_POST_OPS_PER_CELL)
    clock = max_sm_clock_hz()
    times = {}
    for g in (1, 2, 4, 8, 16, 32):
        fm, fend = bounded_pass(lambda: ps.pairhmm_fwd_striped(
            *args, iy0, jy0, w, g), f"kernel 5 at the long pair, G = {g}", dev)
        tot = pc._total_prob(fend, params).contiguous()
        ms5 = time_cuda(lambda: ps.pairhmm_fwd_striped(*args, iy0, jy0, w, g),
                        reps=3)
        # kernel 6 writes its posterior over fm: its repeats run on their
        # own output (the work does not depend on the values)
        ms6 = time_cuda(lambda: ps.pairhmm_bwd_striped(*args, tot, iy0b, jy0b,
                                                       fm, w, g), reps=3)
        ps.wavefront.check_waits(dev)
        times[g] = (ms5, ms6)
        f5 = row_floor_ms(lx1, g, clock, backward=False)
        f6 = row_floor_ms(lx1, g, clock, backward=True)
        chosen = " (the geometry's)" if g == g_main else ""
        print(f"kernels 5/6 at the long pair (Lx {px}, By {py}, 10 stripes, "
              f"{cells:.0f} real cells), one pass each at G = {g}{chosen}, "
              f"{py // (64 * g)} groups: kernel 5 {ms5:.3f} ms (bound "
              f"{bnd5[0]:.4f} ms by {bnd5[1]}, dependency floor {f5:.2f} ms), "
              f"kernel 6 {ms6:.3f} ms (bound {bnd6[0]:.4f} ms by {bnd6[1]}, "
              f"dependency floor {f6:.2f} ms); per-stripe launches before "
              f"(PERF.md row 5/6): 10 x 197.5 = 1975 / 10 x 151.5 = 1515 ms",
              flush=True)
        del fm
        torch.cuda.empty_cache()
    ms5, ms6 = times[g_main]
    return [
        {"name": "pairhmm_fwd_stripe", "route": "cuda",
         "source": "muscle_tpu_torch/csrc/pairhmm_fwd_stripe.cu",
         "replaces": "muscle_tpu/ops/pairhmm_striped.py:96",
         "launches": 0, "max_abs_err": d_st, "ms": ms5, "plain_ms": plain_f,
         "bound_ms": bnd5[0], "bound_by": bnd5[1], "library_ms": None},
        {"name": "pairhmm_bwd_stripe", "route": "cuda",
         "source": "muscle_tpu_torch/csrc/pairhmm_bwd_stripe.cu",
         "replaces": "muscle_tpu/ops/pairhmm_striped.py:312",
         "launches": 0, "max_abs_err": d_st, "ms": ms6, "plain_ms": plain_b,
         "bound_ms": bnd6[0], "bound_by": bnd6[1], "library_ms": None},
    ]


def synthetic_store(dev, p1, l, k, seed):
    """(P1, l, k) sparse store on the card: 1-8 valid slots per row, valid
    slots first, unique columns (start + q * step mod l, step odd, l a
    power of two), values in [0.02, 0.92); the last row is the empty
    dump slot."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi):
        return torch.randint(lo, hi, (p1, l, 1), generator=g, device=dev,
                             dtype=torch.int32)
    q = torch.arange(k, device=dev, dtype=torch.int32)
    cols = (ints(0, l) + q * (2 * ints(0, l // 2) + 1)) % l
    valid = q < ints(1, 9)
    valid[-1] = False
    vals = torch.rand((p1, l, k), generator=g, device=dev) * 0.9 + 0.02
    return (torch.where(valid, vals, 0.0).contiguous(),
            torch.where(valid, cols, -1).to(torch.int32).contiguous())


# kernel 8 before its redesign (PERF.md, NVIDIA H100 80GB HBM3 at 700 W):
# the n = 200 bf16 z-tile, one block a slab
DENSIFY_WAS_MS = 1.428


def densify_case(vals, cols, pids, flags, dump, what) -> dict:
    """Kernel 8 on one z-tile held to its plain version in f32 and bf16
    (equal required) and timed (CUDA events), beside the plain version
    (bf16), one torch.scatter of the same slots and the bound of each
    dtype."""
    import torch
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.ops import densify_cuda as dc
    l = vals.shape[1]
    errs, same, ms, bnd = [], True, {}, {}
    ids = pids.reshape(-1).long()
    real = flags.reshape(-1) != cons.FLAG_EYE
    slots = float((cols[ids][real & (ids != dump)] >= 0).sum())
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        # timed first, after 20 launches: right after the plain version (a
        # host-bound loop) the first ~20 launches ran 10-20 % slower;
        # 5 launches between the events keep the wrapper's host time out
        for _ in range(20):
            dc.densify_panel(vals, cols, pids, flags, dtype)
        ms[name] = time_cuda(lambda: dc.densify_panel(vals, cols, pids, flags,
                                                      dtype), per=5)
        got = dc.densify_panel(vals, cols, pids, flags, dtype)
        want = dc.densify_panel_plain(vals, cols, pids, flags, dtype)
        torch.cuda.synchronize()
        errs.append(float((got.float() - want.float()).abs().max()))
        same = same and torch.equal(got, want)
        del got, want
        torch.cuda.empty_cache()
        # the panel written once, each real slot (value, column) and the
        # tile's maps read once
        size = torch.empty((), dtype=dtype).element_size()
        bnd[name] = bound_ms(size * pids.numel() * l * l + 8 * slots
                             + 8 * pids.numel(), 0)
    plain_ms = time_cuda(lambda: dc.densify_panel_plain(
        vals, cols, pids, flags, torch.bfloat16), reps=3)
    torch.cuda.empty_cache()
    # one torch call for the same expansion: an out-of-place scatter of
    # the tile's slots onto a zero (m, L, L + 1) f32 template, empty slots
    # sent to the spare column (no orientation, no panel layout); it
    # writes its whole output, as the kernel does
    v, c = vals[ids], cols[ids]
    idx = torch.where(c >= 0, c, l).long()
    buf = torch.zeros((ids.numel(), l, l + 1), device=vals.device)
    lib_ms = time_cuda(lambda: torch.scatter(buf, 2, idx, v))
    del buf, idx, v, c
    torch.cuda.empty_cache()
    tiles = {d: dc.tile_shape(l, getattr(torch, t)) for d, t in
             (("f32", "float32"), ("bf16", "bfloat16"))}
    print(f"densify (kernel 8) vs plain on {what}: max |d| f32 "
          f"{errs[0]:.3e}, bf16 {errs[1]:.3e} {'equal' if same else 'FAIL'}; "
          f"bf16 {ms['bf16']:.3f} ms (bound {bnd['bf16'][0]:.3f} ms by "
          f"{bnd['bf16'][1]}), f32 {ms['f32']:.3f} ms (bound "
          f"{bnd['f32'][0]:.3f} ms); plain {plain_ms:.1f} ms, scatter "
          f"{lib_ms:.3f} ms; tiles (R x C) {tiles}; one block a slab "
          f"before: {DENSIFY_WAS_MS} ms bf16 on the n = 200 tile", flush=True)
    if not same:
        raise SmokeFailure(f"densify disagrees with its plain version on "
                           f"{what}")
    return {"err": max(errs), "ms": ms, "bound": bnd, "plain_ms": plain_ms,
            "lib_ms": lib_ms}


def phase_gram_join_kernels(dev) -> list[dict]:
    """Kernel 8 (densify), kernel 7 (densify-reduce) and the MEA
    direction DP against their plain versions at the n = 200 family's
    shapes; each must be equal (max |d| = 0)."""
    import torch
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import wavefront
    from muscle_tpu_torch.ops.consistency import _tf32_off
    from muscle_tpu_torch.pipeline.posteriors import store_rows

    for line in ptxas_lines(["densify_reduce", "densify_reduce_list"]):
        print(f"ptxas: {line}", flush=True)
    n, l, k, blk = 200, 512, 24, 16
    p1 = store_rows(n * (n - 1) // 2)
    dump = p1 - 1
    vals, cols = synthetic_store(dev, p1, l, k, seed=200)
    out = []

    # densify: z-tile 6 of the Gram panel (blocks of 16, rectangles of
    # two blocks: 13 + 1 blocks wide), as consistency_sparse builds it
    nblk = -(-n // blk)
    nbp = (nblk + min(max(1, 16384 // (blk * l)), nblk) - 1) * blk
    pid, flag = cons._block_maps(n, nbp, dump)
    pids = torch.as_tensor(pid[6 * blk:7 * blk], device=dev)
    flags = torch.as_tensor(flag[6 * blk:7 * blk], device=dev)
    tile = densify_case(vals, cols, pids, flags, dump,
                        f"a 16 x {nbp} z-tile of n = {n} at L={l}, K={k}")
    # the long families' f32 panel: long mixed's n = 6 at pad 12288, one
    # sequence a block (z-tile 3: FLAG_TRANS, FLAG_EYE and FLAG_STORE
    # slabs), a store of 16 rows
    n6, l6 = len(LONG_MIXED), 12288
    v6, c6 = synthetic_store(dev, store_rows(n6 * (n6 - 1) // 2), l6, k,
                             seed=6)
    pid6, flag6 = cons._block_maps(n6, n6, v6.shape[0] - 1)
    long_tile = densify_case(
        v6, c6, torch.as_tensor(pid6[3:4], device=dev),
        torch.as_tensor(flag6[3:4], device=dev), v6.shape[0] - 1,
        f"long mixed's 1 x {n6} z-tile at L={l6}, K={k}")
    del v6, c6
    torch.cuda.empty_cache()
    out.append({"name": "densify", "route": "cuda",
                "source": "muscle_tpu_torch/csrc/densify.cu",
                "replaces": "muscle_tpu/ops/sparse.py:152",
                "launches": 0,
                "max_abs_err": max(tile["err"], long_tile["err"]),
                "ms": tile["ms"]["bf16"], "plain_ms": tile["plain_ms"],
                "bound_ms": tile["bound"]["bf16"][0],
                "bound_by": tile["bound"]["bf16"][1],
                "library_ms": tile["lib_ms"], "ms_f32": tile["ms"]["f32"],
                "long_tile_ms": long_tile["ms"],
                "long_tile_bound_ms": {d: b[0] for d, b in
                                       long_tile["bound"].items()},
                "long_tile_library_ms": long_tile["lib_ms"]})

    # densify-reduce: one half of a refine join of the n = 200 family, a
    # random 100 / 100 split; pos->col maps into 768 columns
    rng = np.random.default_rng(7)
    order = rng.permutation(n)
    rows, cols_of = np.sort(order[:100]), np.sort(order[100:])
    pm = np.full((n, n), dump, np.int32)
    for x in range(n):
        for y in range(x + 1, n):
            pm[x, y] = cons.pair_index(x, y, n)
    cc, k2 = 768, k
    pid_g = torch.as_tensor(pm[np.ix_(rows, cols_of)], device=dev)
    bank = torch.as_tensor(np.stack([np.sort(rng.choice(cc, l, replace=False))
                                     for _ in cols_of]).astype(np.int32),
                           device=dev)
    case = grid_kernel_case((vals, cols, k2, pid_g, bank, dump, cc))
    print_grid_case("a 100 x 100 grid of the n = 200 family", case)
    if not case["same"]:
        raise SmokeFailure("densify_reduce disagrees with its plain version")
    out.append({"name": "densify_reduce", "route": "cuda",
                "source": "muscle_tpu_torch/csrc/densify_reduce.cu",
                "replaces": "muscle_tpu/pipeline/devjoin.py:88",
                "launches": 0, "max_abs_err": case["err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound"][0],
                "bound_by": case["bound"][1], "library_ms": case["lib_ms"]})
    # the one-hot contraction that consumes this F, as DeviceJoiner._half
    # runs it (pipeline/devjoin.py: the row-owners' maps uploaded, their
    # one-hot rows, one f32 product with TF32 off, added into the
    # column posterior); timed only: no kernel of the port
    rbank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                      for _ in rows]).astype(np.int32)
    f = djc.densify_reduce(vals, cols, k2, pid_g, bank, dump, cc)
    post = torch.zeros((cc, cc), dtype=torch.float32, device=dev)

    def contract():
        a = torch.nn.functional.one_hot(
            torch.as_tensor(rbank, device=dev).long(), cc).to(torch.float32)
        with _tf32_off():
            post.add_(a.reshape(-1, cc).T @ f.reshape(-1, cc))
    c_ms = time_cuda(contract, per=DR_PER)
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(rbank, device=dev).long(), cc).to(torch.float32)

    def product():
        with _tf32_off():
            torch.mm(onehot.reshape(-1, cc).T, f.reshape(-1, cc))
    p_ms = time_cuda(product, per=DR_PER)
    c_ops = 2.0 * len(rows) * l * cc * cc
    c_bnd = bound_ms(4 * (len(rows) * l * (cc + cc) + cc * cc), c_ops)
    print(f"one-hot contraction of that half (DeviceJoiner._half: "
          f"({len(rows) * l} x {cc})^T @ ({len(rows) * l} x {cc}) f32, TF32 "
          f"off): {c_ms:.3f} ms as _half runs it (maps uploaded, one-hot "
          f"built, product, add), product alone {p_ms:.3f} ms; "
          f"{c_ops / 1e9:.1f} GFLOP ({c_ops / p_ms / 1e9:.1f} TFLOP/s in the "
          f"product), bound {c_bnd[0]:.3f} ms by {c_bnd[1]}; kernel 7 on the "
          f"same half {case['ms']:.3f} ms", flush=True)
    del f, post, onehot, vals, cols
    torch.cuda.empty_cache()

    # MEA direction DP at 768 x 768 (no single torch call computes it):
    # a random posterior (few ties) and a tie-heavy one (the common case
    # of real posteriors), then the odd shapes, each random and
    # tie-heavy; all required equal
    g = torch.Generator(device=dev).manual_seed(768)
    post = torch.rand((cc, cc), generator=g, device=dev) * 100.0
    ties = tie_heavy((cc, cc), cc, dev)
    held = [(f"{cc} x {cc} random", post), (f"{cc} x {cc} tie-heavy", ties)]
    held += [(f"{a} x {b} {kind}", make)
             for a, b in MEA_ODD_SHAPES
             for kind, make in (
                 ("random", torch.rand((a, b), generator=g, device=dev)),
                 ("tie-heavy", tie_heavy((a, b), a * b, dev)))]
    err, same = 0.0, True
    for what, p in held:
        case = mea_dirs_case(p)
        err = max(err, case["err"])
        same &= case["same"]
        print(f"mea_dirs vs plain on {what}: max |d| {case['err']:.3e}, "
              f"directions {'equal' if case['same'] else 'FAIL'}",
              flush=True)
    wavefront.check_waits(dev)
    ms = time_cuda(lambda: djc.mea_dirs(post), per=DR_PER)
    ms_ties = time_cuda(lambda: djc.mea_dirs(ties), per=DR_PER)
    plain_ms = time_cuda(lambda: djc.mea_dirs_plain(post), reps=3)
    bnd = mea_bound(cc, cc)
    floor = mea_floor_ms(cc, cc, max_sm_clock_hz())
    print(f"mea_dirs at {cc} x {cc} ({djc.mea_warps(cc)} warps, "
          f"{mea_floor_steps(cc, cc)} dependent steps): {ms:.4f} ms random, "
          f"{ms_ties:.4f} ms tie-heavy (was {MEA_WAS_MS} ms: "
          f"{MEA_WAS_MS / ms:.1f}x; plain {plain_ms:.1f} ms, bound "
          f"{bnd[0]:.5f} ms by {bnd[1]}, dependency floor {floor:.4f} ms)",
          flush=True)
    if not same:
        raise SmokeFailure("mea_dirs disagrees with its plain version")
    out.append({"name": "mea_dirs", "route": "cuda",
                "source": "muscle_tpu_torch/csrc/mea_dirs.cu",
                "replaces": "muscle_tpu/pipeline/devjoin.py:181",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None,
                "ms_tie_heavy": ms_ties})
    del post, ties, held
    torch.cuda.empty_cache()
    return out


def mea_bound(cc1: int, cc2: int) -> tuple[float, str]:
    """mea_dirs' bound: the posterior read once, the packed codes and the
    scores written once; per cell one add, the max of b and x, the
    running max, three compares for the direction."""
    return bound_ms(4 * cc1 * cc2 + 4 * cc1 * -(-cc2 // 16) + 4 * cc1,
                    6 * cc1 * cc2)


def mea_dirs_case(post, got=None) -> dict:
    """mea_dirs' output `got` on `post` (launched here when not given)
    against its plain version on the same posterior (directions and
    scores equal required), and the kernel's time there (CUDA events
    around DR_PER launches) with its bound and dependency floor. The
    launches made here are not counted."""
    import torch
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    before = djc.LAUNCHES["mea_dirs"]
    if got is None:
        got = djc.mea_dirs(post)
    want = djc.mea_dirs_plain(post)
    torch.cuda.synchronize()
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = float((got[1] - want[1]).abs().max())
    ms = time_cuda(lambda: djc.mea_dirs(post), per=DR_PER)
    djc.LAUNCHES["mea_dirs"] = before
    cc1, cc2 = post.shape
    return {"same": same, "err": err, "ms": ms, "shape": (cc1, cc2),
            "bound": mea_bound(cc1, cc2),
            "floor": mea_floor_ms(cc1, cc2, max_sm_clock_hz())}


def geometry_text(cc: int) -> str:
    """Kernels 7/7L's launch geometry (ops/devjoin_cuda._geometry)."""
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    g = djc._geometry(cc)
    return (f"{g.warps} warps a block, tile {g.tr} x {g.tc}, "
            f"{-(-cc // g.tc)} column tile(s), {g.smem} B shared")


def grid_kernel_case(args, got=None) -> dict:
    """Kernel 7's output `got` on `args` (launched here when not given)
    against its plain version on the same inputs, and the times of the
    kernel and of one torch.index_add of the same slots (CUDA events
    around DR_PER calls) and of its plain version, with its bound. The
    launches made here are not counted."""
    import torch
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    vals, cols, k2, pid, bank, dump, cc = args
    before = djc.LAUNCHES["densify_reduce"]
    if got is None:
        got = djc.densify_reduce(*args)
    want = djc.densify_reduce_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    same = torch.equal(got, want)
    del got, want
    ms = time_cuda(lambda: djc.densify_reduce(*args), per=DR_PER)
    plain_ms = time_cuda(lambda: djc.densify_reduce_plain(*args), reps=3)
    djc.LAUNCHES["densify_reduce"] = before
    # one torch call for the same sums: an out-of-place index_add of every
    # valid slot of the real pairs at its flat (s, l, col) index onto a
    # zero F template
    dev = vals.device
    n_r, l = pid.shape[0], vals.shape[1]
    s_i, t_i = torch.nonzero(pid != dump, as_tuple=True)
    p = pid[s_i, t_i].long()
    c = cols[p, :, :k2].long()
    col = bank.long()[t_i[:, None, None], c.clamp(min=0)]
    ok = (c >= 0) & (col >= 0) & (col < cc)
    flat = ((s_i[:, None, None] * l + torch.arange(l, device=dev)[:, None])
            * cc + col)[ok]
    vsel = vals[p, :, :k2][ok]
    f = torch.zeros(n_r * l * cc, device=dev)
    lib_ms = time_cuda(lambda: torch.index_add(f, 0, flat, vsel), per=DR_PER)
    # the valid slots (value, column), the grid and the maps read once, F
    # written once; one add per valid slot
    slots = float(vsel.numel())
    bnd = bound_ms(8 * slots + 4 * pid.numel() + 4 * bank.numel()
                   + 4 * n_r * l * cc, slots)
    del f, flat, vsel, col, c, ok
    return {"same": same, "err": err, "ms": ms, "plain_ms": plain_ms,
            "lib_ms": lib_ms, "bound": bnd, "slots": int(slots),
            "shape": f"{n_r} x {pid.shape[1]} grid, {int(p.numel())} real "
                     f"pairs, L={l}, k2={k2}, cc={cc}; "
                     + geometry_text(cc)}


def print_grid_case(what: str, case: dict) -> None:
    bnd = case["bound"]
    print(f"densify_reduce (kernel 7) vs plain on {what} ({case['shape']}, "
          f"{case['slots']} valid slots): max |d| {case['err']:.3e} "
          f"{'equal' if case['same'] else 'FAIL'}; {case['ms']:.3f} ms "
          f"(plain {case['plain_ms']:.1f} ms, index_add "
          f"{case['lib_ms']:.3f} ms, bound {bnd[0]:.4f} ms by {bnd[1]})",
          flush=True)


def list_kernel_case(args, got=None) -> dict:
    """Kernel 7L's output `got` on `args` (launched here when not given)
    against its plain version on the same inputs, and the times of the
    kernel and of one torch.index_add of the same slots (CUDA events
    around DR_PER calls) and of its plain version, with its bound. The
    launches made here are not counted."""
    import torch
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    vals, cols, k2, rp, pid, co, bk, dump, cc = args
    before = djc.LAUNCHES["densify_reduce_list"]
    if got is None:
        got = djc.densify_reduce_list(*args)
    want = djc.densify_reduce_list_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    same = torch.equal(got, want)
    del got, want
    ms = time_cuda(lambda: djc.densify_reduce_list(*args), per=DR_PER)
    plain_ms = time_cuda(lambda: djc.densify_reduce_list_plain(*args), reps=3)
    djc.LAUNCHES["densify_reduce_list"] = before
    # one torch call for the same sums: an out-of-place index_add of every
    # valid slot of the owners' entries at its flat (owner, l, col) index
    # onto a zero F template
    dev = vals.device
    n_s, l = rp.numel() - 1, vals.shape[1]
    e0, e1 = int(rp[0]), int(rp[-1])
    own = torch.repeat_interleave(torch.arange(n_s, device=dev),
                                  (rp[1:] - rp[:-1]).long())
    p, t = pid[e0:e1].long(), co[e0:e1].long()
    c = cols[p, :, :k2].long()
    col = bk.long()[t[:, None, None], c.clamp(min=0)]
    ok = (c >= 0) & (col < cc) & (p != dump)[:, None, None]
    flat = ((own[:, None, None] * l + torch.arange(l, device=dev)[:, None])
            * cc + col)[ok]
    vsel = vals[p, :, :k2][ok]
    f = torch.zeros(n_s * l * cc, device=dev)
    lib_ms = time_cuda(lambda: torch.index_add(f, 0, flat, vsel), per=DR_PER)
    # the valid slots (value, column) and the maps read once, F written
    # once; one add per valid slot
    slots = float(vsel.numel())
    bnd = bound_ms(8 * slots + 4 * (rp.numel() + 2 * (e1 - e0) + bk.numel())
                   + 4 * n_s * l * cc, slots)
    del f, flat, vsel, col, c, ok, own
    return {"same": same, "err": err, "ms": ms, "plain_ms": plain_ms,
            "lib_ms": lib_ms, "bound": bnd, "slots": int(slots),
            "shape": f"{n_s} owners, {e1 - e0} entries, {bk.shape[0]} "
                     f"col-owners, L={l}, k2={k2}, cc={cc}; "
                     + geometry_text(cc)}


def print_list_case(what: str, case: dict) -> None:
    bnd = case["bound"]
    print(f"densify_reduce_list (kernel 7L) vs plain on {what} "
          f"({case['shape']}, {case['slots']} valid slots): max |d| "
          f"{case['err']:.3e} {'equal' if case['same'] else 'FAIL'}; "
          f"{case['ms']:.3f} ms (plain {case['plain_ms']:.1f} ms, index_add "
          f"{case['lib_ms']:.3f} ms, bound {bnd[0]:.4f} ms by {bnd[1]})",
          flush=True)


def phase_list_kernel(dev) -> dict:
    """Kernel 7L (densify-reduce, list variant) against its plain version
    before the main path, on 2,000 pairs sampled from a 128 x 128-row
    join as PProg samples them over a random store, L = 384, k2 = 24,
    cc = 600; it must be equal (max |d| = 0). Phase 3 holds every
    launch of the main path to the plain version on its own inputs
    (ListKernelCheck) and takes the kernel's times there."""
    import torch
    from muscle_tpu_torch.pipeline.posteriors import store_rows
    from muscle_tpu_torch.pipeline.pprog import get_pairs
    from muscle_tpu_torch.utils.rng import MwcRng

    n1 = n2 = 128
    l, k, k2, cc = 384, 32, 24, 600
    sampled = get_pairs(n1, n2, 2000, MwcRng(1))
    p1 = store_rows(len(sampled))
    dump = p1 - 1
    vals, cols = synthetic_store(dev, p1, l, k, seed=2000)
    # sampled is sorted by (i, j): owner i's entries are one run
    ro = np.array([i for i, _ in sampled])
    row_ptr = np.zeros(n1 + 1, np.int32)
    np.cumsum(np.bincount(ro, minlength=n1), out=row_ptr[1:])
    rng = np.random.default_rng(600)
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n2)]).astype(np.int32)
    rp, pid, co, bk = (torch.as_tensor(a, device=dev) for a in (
        row_ptr, np.arange(len(sampled), dtype=np.int32),
        np.array([j for _, j in sampled], np.int32), bank))
    case = list_kernel_case((vals, cols, k2, rp, pid, co, bk, dump, cc))
    print_list_case(f"{len(sampled)} pairs sampled from a {n1} x {n2}-row "
                    "join, random store", case)
    if not case["same"]:
        raise SmokeFailure("densify_reduce_list disagrees with its plain "
                           "version")
    del vals, cols
    torch.cuda.empty_cache()
    return {"name": "densify_reduce_list", "route": "cuda",
            "source": "muscle_tpu_torch/csrc/densify_reduce_list.cu",
            "replaces": "muscle_tpu/pipeline/devjoin.py:88",
            "launches": 0, "max_abs_err": case["err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound"][0],
            "bound_by": case["bound"][1], "library_ms": case["lib_ms"]}


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


# kernels each branch of the main path runs
PAIR_KERNELS = ("pairhmm_fwd", "pairhmm_bwd_post")
STRIPE_KERNELS = ("pairhmm_fwd_stripe", "pairhmm_bwd_stripe")
REFINE_KERNELS = ("densify_reduce", "mea_dirs")
LIST_KERNELS = ("densify_reduce_list",)
DENSIFY = ("densify",)

# launches of each kernel over the main path's runs (phase 3), and of
# kernels A/B/1M/2M by (name, schedule, Ly)
MAIN_PATH: dict[str, int] = {}
MAIN_SCHEDULES: dict[tuple, int] = {}


def _kernel_modules():
    from muscle_tpu_torch.ops import (densify_cuda, devjoin_cuda, dp_cuda,
                                      pairhmm_cuda, pairhmm_emis_cuda,
                                      pairhmm_striped)
    return (pairhmm_cuda, pairhmm_striped, densify_cuda, devjoin_cuda,
            pairhmm_emis_cuda, dp_cuda)


def reset_launches():
    for m in _kernel_modules():
        m.reset_launches()


def launches() -> dict[str, int]:
    out = {}
    for m in _kernel_modules():
        out.update(m.LAUNCHES)
    return out


def count_main_path() -> dict[str, int]:
    """The launches since reset_launches(), added to MAIN_PATH, and
    kernels A/B/1M/2M's by schedule and width to MAIN_SCHEDULES."""
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    got = launches()
    for k, v in got.items():
        MAIN_PATH[k] = MAIN_PATH.get(k, 0) + v
    for k, v in pc.SCHEDULES.items():
        MAIN_SCHEDULES[k] = MAIN_SCHEDULES.get(k, 0) + v
    return got


class HeldLaunches:
    """Launches of the main path held, as they happen, to their plain
    version: `cases` (one each), and the seconds and peak device memory
    the checks take, to be kept out of the run's walls and peak."""

    def __init__(self):
        self.cases: list[dict] = []
        self.seconds = 0.0
        self.peak = 0

    def hold(self, case_of, args, out) -> None:
        import torch
        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        self.cases.append(case_of(args, got=out))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.seconds += time.perf_counter() - t0


# kernel-7 launches held to the plain version at the start of each
# device refine: the first HELD_GRID of each DeviceJoiner
HELD_GRID = 2


class GridKernelCheck(HeldLaunches):
    """Stands in for kernel 7's wrapper in the device refine joins while
    the main path runs: the first HELD_GRID launches of each DeviceJoiner
    (one an align() call or Super4 cluster that refines on the device;
    counted as any other) are held against the plain version on the same
    inputs and timed there (grid_kernel_case); `held_since` prints and
    requires them."""

    def __init__(self):
        super().__init__()
        self._left = 0
        self._saved = None

    def __call__(self, *args):
        from muscle_tpu_torch.ops import devjoin_cuda as djc
        out = djc.densify_reduce(*args)
        if self._left > 0:
            self._left -= 1
            self.hold(grid_kernel_case, args, out)
        return out

    def __enter__(self):
        from muscle_tpu_torch.pipeline import devjoin
        init = devjoin.DeviceJoiner.__init__
        self._saved = (devjoin.densify_reduce, init)

        def held_init(joiner, *args, **kwargs):
            self._left = HELD_GRID
            init(joiner, *args, **kwargs)
        devjoin.densify_reduce = self
        devjoin.DeviceJoiner.__init__ = held_init
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.pipeline import devjoin
        devjoin.densify_reduce, devjoin.DeviceJoiner.__init__ = self._saved

    def held_since(self, name: str, n_cases: int, launched: int) -> None:
        """Print and require the cases held since there were `n_cases`:
        at least one for a run that launched kernel 7, each equal."""
        new = self.cases[n_cases:]
        for i, case in enumerate(new):
            print_grid_case(f"{name}'s held launch {i + 1} of {len(new)}",
                            case)
        if launched and not new:
            raise SmokeFailure(f"{name}: {launched} kernel-7 launches, none "
                               "held")
        if not all(c["same"] for c in new):
            raise SmokeFailure(f"{name}: a kernel-7 launch disagrees with its "
                               "plain version")


GRID_CHECK = GridKernelCheck()


class MeaDirsCheck(HeldLaunches):
    """Stands in for mea_dirs in the device joins while the main path
    runs: every launch is counted by its (cc1, cc2) rungs; the first
    HELD_GRID launches of each DeviceJoiner (a device refine) and the
    launch of each PProg device join are held against mea_dirs_plain on
    the same posterior and timed there (mea_dirs_case); `held_since`
    prints and requires them. `pprog_seconds` is the PProg checks'
    share of `seconds`."""

    def __init__(self):
        super().__init__()
        self._left = 0
        self._pprog = False
        self._saved = None
        self.rungs: dict = {}
        self.pprog_seconds = 0.0

    def __call__(self, post):
        from muscle_tpu_torch.ops import devjoin_cuda as djc
        from muscle_tpu_torch.pipeline.devjoin import _cc_rung
        out = djc.mea_dirs(post)
        rung = tuple(_cc_rung(c) for c in post.shape)
        self.rungs[rung] = self.rungs.get(rung, 0) + 1
        if self._left > 0:
            self._left -= 1
            s0 = self.seconds
            self.hold(mea_dirs_case, post, out)
            self.cases[-1]["pprog"] = self._pprog
            if self._pprog:
                self.pprog_seconds += self.seconds - s0
        return out

    def __enter__(self):
        from muscle_tpu_torch.pipeline import devjoin, pprog
        init, sampled = devjoin.DeviceJoiner.__init__, pprog.align_sampled_device
        self._saved = (devjoin.mea_dirs, init, sampled)

        def held_init(joiner, *args, **kwargs):
            self._left, self._pprog = HELD_GRID, False
            init(joiner, *args, **kwargs)

        def held_sampled(*args, **kwargs):
            self._left, self._pprog = 1, True
            try:
                return sampled(*args, **kwargs)
            finally:
                self._left = 0
        devjoin.mea_dirs = self
        devjoin.DeviceJoiner.__init__ = held_init
        pprog.align_sampled_device = held_sampled
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.pipeline import devjoin, pprog
        (devjoin.mea_dirs, devjoin.DeviceJoiner.__init__,
         pprog.align_sampled_device) = self._saved

    def held_since(self, name: str, n_cases: int, launched: int) -> None:
        """Print and require the cases held since there were `n_cases`:
        at least one for a run that launched mea_dirs, each equal."""
        new = self.cases[n_cases:]
        for i, c in enumerate(new):
            bnd = c["bound"]
            print(f"mea_dirs vs plain on {name}'s held "
                  f"{'PProg' if c['pprog'] else 'refine'} launch {i + 1} of "
                  f"{len(new)} ({c['shape'][0]} x {c['shape'][1]}): max |d| "
                  f"{c['err']:.3e} {'equal' if c['same'] else 'FAIL'}; "
                  f"{c['ms']:.4f} ms (bound {bnd[0]:.5f} ms by {bnd[1]}, "
                  f"dependency floor {c['floor']:.4f} ms)", flush=True)
        if launched and not new:
            raise SmokeFailure(f"{name}: {launched} mea_dirs launches, none "
                               "held")
        if not all(c["same"] for c in new):
            raise SmokeFailure(f"{name}: a mea_dirs launch disagrees with its "
                               "plain version")


MEA_CHECK = MeaDirsCheck()


def mea_rungs() -> dict:
    """The main path's mea_dirs launches by (cc1, cc2) rung of the bucket
    ladder: {rung: (launches, held launches, their summed ms)}."""
    from muscle_tpu_torch.pipeline.devjoin import _cc_rung
    out = {r: [n, 0, 0.0] for r, n in MEA_CHECK.rungs.items()}
    for c in MEA_CHECK.cases:
        row = out[tuple(_cc_rung(x) for x in c["shape"])]
        row[1] += 1
        row[2] += c["ms"]
    return dict(sorted(out.items()))


def print_mea_rungs() -> None:
    for (r1, r2), (n, held, ms) in mea_rungs().items():
        print(f"mea_dirs on the main path at rung {r1} x {r2}: {n} launches, "
              f"{held} held, {ms:.4f} ms summed over the held", flush=True)


def peak_bytes() -> int:
    """Peak device memory since the last reset, the kernel-7 and
    mea_dirs checks' own memory left out."""
    import torch
    return max(torch.cuda.max_memory_allocated(), GRID_CHECK.peak,
               MEA_CHECK.peak)


def run_path(name, seqs, dev, kernels, **kwargs):
    """One align() call of the main path: the launch counts are set to 0
    just before it and read just after; each kernel of `kernels` must
    have launched. Held kernel-7 and mea_dirs launches (GRID_CHECK,
    MEA_CHECK) are printed and their time taken out of the wall and the
    refine stage. Returns (msa, wall s, stage walls, launches)."""
    import torch
    from muscle_tpu_torch import align
    from muscle_tpu_torch.utils import logging as mlog
    mlog.STAGE_TIMES.clear()
    n_cases, s0 = len(GRID_CHECK.cases), GRID_CHECK.seconds
    m_cases, m0 = len(MEA_CHECK.cases), MEA_CHECK.seconds
    GRID_CHECK.peak = MEA_CHECK.peak = 0
    reset_launches()
    t0 = time.perf_counter()
    msa = align(seqs, device=dev, **kwargs)
    torch.cuda.synchronize()
    held = GRID_CHECK.seconds - s0 + MEA_CHECK.seconds - m0
    wall = time.perf_counter() - t0 - held
    got = count_main_path()
    missing = [k for k in kernels if got[k] <= 0]
    if missing:
        raise SmokeFailure(f"{name}: {missing} not launched")
    GRID_CHECK.held_since(name, n_cases, got["densify_reduce"])
    MEA_CHECK.held_since(name, m_cases, got["mea_dirs"])
    check_alignment(seqs, msa, name)
    stages = {k: round(v - (held if k == "refine" else 0), 4)
              for k, v in mlog.STAGE_TIMES.items()}
    return msa, wall, stages, got


def phase_families(dev) -> dict:
    from muscle_tpu_torch import MultiSequence
    results = {}
    for name, inp, strip, golden in FAMILIES:
        seqs = MultiSequence.from_fasta(os.path.join(ROOT, inp),
                                        strip_gaps=strip)
        gold = MultiSequence.from_fasta(os.path.join(ROOT, golden))
        msa, wall, _, _ = run_path(name, seqs, dev, PAIR_KERNELS)
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
        msa, _, _, _ = run_path(name, seqs, dev, PAIR_KERNELS,
                                consistency_iters=iters)
        print(f"family {name}: valid alignment, width {msa.col_count()}",
              flush=True)
    return results


def synthetic_family(n=32, lo=400, hi=512, seed=32):
    """Mutated copies of one random protein (tests/test_devjoin.py)."""
    from muscle_tpu_torch import MultiSequence, Sequence
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=hi)
    aas = AMINO_LETTERS
    seqs = MultiSequence()
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        mut = base[:ln].copy()
        nmut = int(rng.integers(0, ln // 3))
        pos = rng.integers(0, ln, size=nmut)
        mut[pos] = rng.integers(0, 20, size=nmut)
        seqs.add(Sequence(f"s{i}", bytes(aas[c] for c in mut)))
    return seqs


def family_of_lengths(lengths, letters: bytes, seed: int):
    """Mutated copies of one random sequence over `letters`, of the given
    lengths in this order (up to a third of the positions redrawn)."""
    from muscle_tpu_torch import MultiSequence, Sequence
    rng = np.random.default_rng(seed)
    base = rng.integers(0, len(letters), size=max(lengths))
    seqs = MultiSequence()
    for i, ln in enumerate(lengths):
        mut = base[:ln].copy()
        pos = rng.integers(0, ln, size=int(rng.integers(0, ln // 3)))
        mut[pos] = rng.integers(0, len(letters), size=len(pos))
        seqs.add(Sequence(f"s{i}", bytes(letters[c] for c in mut)))
    return seqs


# the long families: proteins of 8.7-11k residues (polyketide synthases,
# titin segments), routed 7 in-cap, 5 transposed, 3 striped, one length
# in (9728, 9856] so kernels A/B run at Ly = 10240; and a pair of
# ~19 kb nucleotide sequences (a filovirus genome's length), padded
# 19456 x 20480 onto 10 stripes
AMINO_LETTERS = b"ARNDCQEGHILKMFPSTWYV"
LONG_MIXED = (11000, 9800, 8700, 10600, 9300, 10900)
LONG_PAIR = (19000, 18900)
# host refine of "long mixed" costs ~0.36 s a join (dense ~1.2e8-cell
# column posteriors): 100 iterations took its call past 60 s; 20 keep
# the whole script near 600 s beside the ensemble phases
LONG_MIXED_REFINE_ITERS = 20
# sha256 of the long families' FASTA text on the H100 at commit d02860e,
# before kernels 5/6 ran as one launch a pass
# (tools/torch_long_family_sha.py): the redesign keeps every bit, so
# the text must not move
LONG_FAMILY_SHA256 = {
    "long mixed":
        "c6c783c655f27053a3bc10dab941f262f818e7ac01858b26f5f77cf69f88e914",
    "long pair":
        "c3dc2d8b5d576b370f15e5a569c26566a5b6f36c797530135ed9ed9f49e799d1",
}
# striped groups of the long families (pairs of one (px, py) rectangle):
# long mixed's 11000 x 10600, 11000 x 10900 (11264 x 12288) and 10600 x
# 10900 (10752 x 12288); the long pair's one
STRIPED_GROUPS = {"long mixed": 2, "long pair": 1}
# long mixed's wall before kernels A/B's wave schedule (PERF.md §5, two
# runs of this script on the commit before it, NVIDIA H100 80GB HBM3 at
# 700 W)
LONG_MIXED_WAS = "39.71-42.08 s"


def phase_long_families(dev) -> dict:
    """The long-pair router on the main path: `align` of the two long
    families at full length."""
    import hashlib
    from collections import Counter

    import torch
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.pipeline import posteriors as post_mod
    widths, striped = [], []
    launch_fwd = pc.pairhmm_fwd
    striped_batch = post_mod._long_pairs_striped_batch

    def recording_fwd(xb, yb, *args):
        widths.append(int(yb.shape[1]))
        return launch_fwd(xb, yb, *args)

    def recording_striped(codes, lens, pack, batch, *args):
        striped.append(len(batch))
        return striped_batch(codes, lens, pack, batch, *args)

    out = {}
    print(f"family long mixed: refine cut to {LONG_MIXED_REFINE_ITERS} "
          "iterations (default 100)", flush=True)
    for name, seqs, kernels, want, iters in (
            ("long mixed", family_of_lengths(LONG_MIXED,
                                             AMINO_LETTERS, 6),
             PAIR_KERNELS + STRIPE_KERNELS + ("densify",),
             {"in_cap": 7, "transposed": 5, "striped": 3, "scan": 0},
             LONG_MIXED_REFINE_ITERS),
            ("long pair", family_of_lengths(LONG_PAIR, b"ACGT", 2),
             STRIPE_KERNELS,
             {"in_cap": 0, "transposed": 0, "striped": 1, "scan": 0},
             100)):
        torch.cuda.reset_peak_memory_stats()
        post_mod.reset_routes()
        widths.clear()
        striped.clear()
        pc.pairhmm_fwd = recording_fwd
        post_mod._long_pairs_striped_batch = recording_striped
        try:
            msa, wall, stages, got = run_path(name, seqs, dev, kernels,
                                              refine_iters=iters)
        finally:
            pc.pairhmm_fwd = launch_fwd
            post_mod._long_pairs_striped_batch = striped_batch
        peak = torch.cuda.max_memory_allocated()
        routes = dict(post_mod.ROUTES)
        scheds = {f"{k[0]} {k[1]} {k[2]}": v
                  for k, v in sorted(pc.SCHEDULES.items())}
        digest = hashlib.sha256(msa.to_fasta_text().encode()).hexdigest()
        same = digest == LONG_FAMILY_SHA256[name]
        print(f"family {name} (lengths {[len(s) for s in seqs]}): "
              f"wall={wall:.2f}s width={msa.col_count()} "
              f"peak_device_mem={peak / 2**30:.3f} GiB "
              f"stages={json.dumps(stages)} routes={json.dumps(routes)} "
              f"kernel A launches by width="
              f"{dict(sorted(Counter(widths).items()))} "
              f"striped groups={striped} "
              f"kernel A/B launches by schedule and width="
              f"{json.dumps(scheds)} "
              f"launches={json.dumps(got)} sha256={digest} "
              f"({'the same as' if same else 'NOT'} the text before the "
              "striped redesign)", flush=True)
        if name == "long mixed":
            print(f"family long mixed: wall {wall:.2f}s, posteriors stage "
                  f"{stages.get('posteriors', 0.0):.2f}s (before the wave "
                  f"schedule: wall {LONG_MIXED_WAS}, PERF.md)", flush=True)
        if not same:
            raise SmokeFailure(f"{name}: the alignment's text moved")
        if routes != want:
            raise SmokeFailure(f"{name}: routes {routes}, want {want}")
        if name == "long mixed" and 10240 not in widths:
            raise SmokeFailure(f"{name}: kernels A/B never ran at Ly = 10240")
        unchecked = sorted(set(widths) - set(AB_CHECK_WIDTHS))
        if unchecked:
            raise SmokeFailure(f"{name}: kernels A/B ran at widths "
                               f"{unchecked} not held against their twins")
        # one forward and one backward launch a striped group, whatever
        # its stripes (10 for the long pair, 6 for long mixed's)
        if (len(striped) != STRIPED_GROUPS[name]
                or got["pairhmm_fwd_stripe"] != len(striped)
                or got["pairhmm_bwd_stripe"] != len(striped)):
            raise SmokeFailure(f"{name}: {len(striped)} striped groups, "
                               f"launches {got['pairhmm_fwd_stripe']} / "
                               f"{got['pairhmm_bwd_stripe']}: want one "
                               "pass each way a group")
        out[name] = {"wall_s": wall, "peak_bytes": peak, "stages": stages,
                     "routes": routes}
    return out


def phase_scan_route(dev, lengths=(512, 480), row_block=256) -> None:
    """One pair through the checkpoint/recompute scan on the card (a
    Python loop of ~10^3 launches a DP row: a 1500 x 1400 pair takes
    ~2 min on an H100, so the pair is smaller), held to kernels A/B on
    the same pair at the kernel gate."""
    import torch
    from muscle_tpu_torch.alphabet import ALPHA_AMINO
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import sparse as sp
    from muscle_tpu_torch.ops.pairhmm_long import long_pair_posterior_sparse
    from muscle_tpu_torch.pipeline.posteriors import encode_batch, round_up
    pack = HMMParams.from_defaults(nucleo=False).to_scores()
    seqs = family_of_lengths(lengths, AMINO_LETTERS, 15)
    codes, lens = encode_batch(seqs, ALPHA_AMINO)
    lx, ly = (int(v) for v in lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, cols, ea, _ = long_pair_posterior_sparse(
        codes[0][:lx], codes[1][:ly], pack, k=32, row_block=row_block,
        device=dev)
    wall = time.perf_counter() - t0
    py = round_up(ly, 128)
    xb = np.full((1, round_up(lx, 128)), 20, np.int32)
    yb = np.full((1, py), 20, np.int32)
    xb[0, :lx] = codes[0][:lx]
    yb[0, :ly] = codes[1][:ly]
    post, ea_k = pc.batch_posteriors_cuda(
        *(torch.from_numpy(a).to(dev) for a in (xb, yb, lens[:1], lens[1:])),
        pack)
    kv, kc, _ = sp.sparsify(post, 32)
    got = sp.densify_np(vals, cols, py)
    want = sp.densify_np(kv[0, :lx].cpu().numpy(), kc[0, :lx].cpu().numpy(),
                         py)
    d = np.abs(got - want)
    flip = ((got == 0) | (want == 0)) & (np.maximum(got, want) <= 0.0102)
    d_post = float(np.where(flip, 0.0, d).max())
    d_ea = abs(ea - float(ea_k[0]))
    ok = d_post < 2e-3 and d_ea < 2e-3
    print(f"scan route (pairhmm_long, row blocks of {row_block}) on a "
          f"{lx} x {ly} "
          f"pair: wall {wall:.2f}s; vs kernels A/B posterior {d_post:.3e} "
          f"(flips ignored, tol 2e-3), EA {d_ea:.3e} (tol 2e-3) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("the scan route disagrees with kernels A/B")


# the synthetic Super5 set (phase 3): 1,000 proteins as the JAX package's
# recorded `-super5 rdrp-1000` config has (docs/PARITY.md:388-407), in
# 4 families of 150 and 8 of 50
SUPER5_FAMILIES = (150,) * 4 + (50,) * 8


def super5_set(seed: int = 1000):
    """Families as synthetic_family builds one (a random root of 380
    residues; each member a prefix of 300-380 with 3-12 % of its
    positions substituted), plus 1-4 indels of 1-5 residues a member,
    placed before the truncation: members that differ only by
    substitutions align unambiguously, their EA passes UCLUST's 0.99, so
    it folds a family into a handful of centroids and no Super4 cluster
    reaches 64. About 5 % of
    each family are exact duplicates of another member and about 10 %
    single-substitution near-duplicates. Rows shuffled."""
    from muscle_tpu_torch import MultiSequence, Sequence
    rng = np.random.default_rng(seed)
    rows = []
    for f, size in enumerate(SUPER5_FAMILIES):
        root = rng.integers(0, 20, 380)
        n_dup, n_near = round(0.05 * size), round(0.10 * size)
        fam = []
        for _ in range(size - n_dup - n_near):
            m = list(root)
            for _ in range(int(rng.integers(1, 5))):
                p, w = int(rng.integers(0, len(m))), int(rng.integers(1, 6))
                if rng.random() < 0.5:
                    del m[p:p + w]
                else:
                    m[p:p] = rng.integers(0, 20, w).tolist()
            m = np.array(m[:int(rng.integers(300, 381))])
            pos = rng.choice(len(m), int(rng.uniform(0.03, 0.12) * len(m)),
                             replace=False)
            m[pos] = (m[pos] + rng.integers(1, 20, len(pos))) % 20
            fam.append(m)
        for _ in range(n_dup):
            fam.append(fam[int(rng.integers(0, size - n_dup - n_near))])
        for _ in range(n_near):
            m = fam[int(rng.integers(0, size - n_dup - n_near))].copy()
            p = int(rng.integers(0, len(m)))
            m[p] = (m[p] + int(rng.integers(1, 20))) % 20
            fam.append(m)
        rows += [(f"fam{f}_{i}", m) for i, m in enumerate(fam)]
    order = rng.permutation(len(rows))
    return MultiSequence([Sequence(rows[i][0], bytes(AMINO_LETTERS[c]
                                                     for c in rows[i][1]))
                          for i in order])


def phase_synthetic(dev) -> dict:
    """The synthetic families, one per branch of the main path."""
    import torch
    from muscle_tpu_torch.pipeline import mpc
    out = {}
    for n, lo, hi, kernels, what in (
            (32, 400, 512, PAIR_KERNELS, "dense, host refine"),
            (70, 100, 128, PAIR_KERNELS + REFINE_KERNELS,
             "dense, device refine"),
            (24, 700, 1000, PAIR_KERNELS + ("densify",),
             "blocked f32 Gram, host refine"),
            (200, 400, 512, PAIR_KERNELS + ("densify",) + REFINE_KERNELS,
             "blocked bf16 Gram, device refine")):
        name = f"synthetic n={n} L={lo}-{hi}"
        seqs = synthetic_family(n, lo, hi, seed=n)
        torch.cuda.reset_peak_memory_stats()
        msa, wall, stages, got = run_path(name, seqs, dev, kernels)
        peak = peak_bytes()
        print(f"family {name} ({what}): wall={wall:.2f}s "
              f"width={msa.col_count()} "
              f"peak_device_mem={peak / 2**30:.3f} GiB "
              f"stages={json.dumps(stages)} launches={json.dumps(got)}",
              flush=True)
        out[n] = {"wall_s": wall, "peak_bytes": peak, "stages": stages}
        if n == 70:
            # ROADMAP item 8's gate on the card: device refine joins give
            # the host joins' alignment
            saved = mpc.DEVICE_REFINE_N
            mpc.DEVICE_REFINE_N = n + 1
            try:
                host, hwall, hstages, _ = run_path(
                    f"{name} host refine", seqs, dev, PAIR_KERNELS)
            finally:
                mpc.DEVICE_REFINE_N = saved
            same = ({s.label: s.text() for s in host}
                    == {s.label: s.text() for s in msa})
            print(f"family {name} with host refine: wall={hwall:.2f}s "
                  f"stages={json.dumps(hstages)} "
                  f"equal-to-device-refine={same}", flush=True)
            if not same:
                raise SmokeFailure(f"{name}: device refine and host refine "
                                   "give different alignments")
    return out


class ListKernelCheck(HeldLaunches):
    """Stands in for kernel 7L's wrapper in the device joins while the
    Super5 path runs: each launch of the main path (counted as any other)
    is held against the plain version on the same inputs and timed there
    (list_kernel_case)."""

    def __call__(self, *args):
        from muscle_tpu_torch.ops import devjoin_cuda as djc
        out = djc.densify_reduce_list(*args)
        self.hold(list_kernel_case, args, out)
        return out


def run_super5(name, seqs, dev, kernels):
    """One super5() call of the main path, as run_path does for align():
    launch counts set to 0 just before it and read just after; each
    kernel of `kernels` must have launched, and every kernel-7L launch is
    held to its plain version (ListKernelCheck; the checks' time is taken
    out of the wall and of the pprog and super4 stage walls). Returns
    (msa, wall s, stage walls, launches, the run's counts, peak device
    bytes, the 7L cases)."""
    import torch
    from muscle_tpu_torch import super5
    from muscle_tpu_torch.pipeline import devjoin
    from muscle_tpu_torch.pipeline.super5 import LAST_RUN
    from muscle_tpu_torch.utils import logging as mlog
    check = ListKernelCheck()
    launch = devjoin.densify_reduce_list
    mlog.STAGE_TIMES.clear()
    torch.cuda.reset_peak_memory_stats()
    n_cases, s0 = len(GRID_CHECK.cases), GRID_CHECK.seconds
    m_cases, m0 = len(MEA_CHECK.cases), MEA_CHECK.seconds
    mp0 = MEA_CHECK.pprog_seconds
    GRID_CHECK.peak = MEA_CHECK.peak = 0
    reset_launches()
    devjoin.densify_reduce_list = check
    try:
        t0 = time.perf_counter()
        msa = super5(seqs, device=dev)
        torch.cuda.synchronize()
        mea_pprog = MEA_CHECK.pprog_seconds - mp0
        grid_held = (GRID_CHECK.seconds - s0 + MEA_CHECK.seconds - m0
                     - mea_pprog)
        pprog_held = check.seconds + mea_pprog
        wall = time.perf_counter() - t0 - pprog_held - grid_held
    finally:
        devjoin.densify_reduce_list = launch
    got = count_main_path()
    peak = max(peak_bytes(), check.peak)
    missing = [k for k in kernels if got[k] <= 0]
    if missing:
        raise SmokeFailure(f"{name}: {missing} not launched")
    if len(check.cases) != got["densify_reduce_list"]:
        raise SmokeFailure(f"{name}: {got['densify_reduce_list']} kernel-7L "
                           f"launches, {len(check.cases)} checked")
    for i, case in enumerate(check.cases):
        print_list_case(f"{name}'s device join {i + 1} of "
                        f"{len(check.cases)}", case)
    if not all(c["same"] for c in check.cases):
        raise SmokeFailure(f"{name}: a kernel-7L launch disagrees with its "
                           "plain version")
    GRID_CHECK.held_since(name, n_cases, got["densify_reduce"])
    MEA_CHECK.held_since(name, m_cases, got["mea_dirs"])
    check_alignment(seqs, msa, name)
    stages = {k: round(v - (pprog_held if k in ("pprog", "super4") else 0)
                       - (grid_held if k in ("refine", "cluster_mpcs",
                                             "super4") else 0), 4)
              for k, v in mlog.STAGE_TIMES.items()}
    if pprog_held:
        print(f"{name}: kernel-7L and PProg mea_dirs checks took "
              f"{pprog_held:.2f}s, taken out of the wall and of the pprog "
              "and super4 stages", flush=True)
    if grid_held:
        print(f"{name}: refine kernel-7 and mea_dirs checks took "
              f"{grid_held:.2f}s, taken out of the wall and of the refine, "
              "cluster_mpcs and super4 stages", flush=True)
    return msa, wall, stages, got, dict(LAST_RUN), peak, check.cases


RDRP16 = "tests/goldens/rdrp_sub16.super5.afa"
# stages of the Super5 path, in its order (the per-cluster MPC stages sum
# into cluster_mpcs)
SUPER5_STAGES = ("uclust", "eacluster", "cluster_mpcs", "consensus+distmx",
                 "pprog", "transaln", "super4")


def phase_super5(dev) -> dict:
    """super5() with default settings on rdrp-16 (must equal its golden,
    by label) and on synthetic-1000 (must take every part of the path)."""
    from muscle_tpu_torch import MultiSequence
    out = {}
    seqs = MultiSequence.from_fasta(os.path.join(ROOT, RDRP16),
                                    strip_gaps=True)
    gold = MultiSequence.from_fasta(os.path.join(ROOT, RDRP16))
    msa, wall, stages, got, run, peak, _ = run_super5("rdrp-16", seqs, dev,
                                                      PAIR_KERNELS)
    same = ({s.label: s.text() for s in msa}
            == {s.label: s.text() for s in gold})
    q = q_score(msa, gold)
    print(f"super5 rdrp-16: n={len(seqs)} column-identical={same} Q={q:.4f} "
          f"wall={wall:.2f}s peak_device_mem={peak / 2**30:.3f} GiB "
          f"stages={json.dumps({k: stages.get(k) for k in SUPER5_STAGES})} "
          f"run={json.dumps(run)} launches={json.dumps(got)}", flush=True)
    if not same:
        raise SmokeFailure("super5 rdrp-16 is not column-identical to its "
                           "golden")
    out["rdrp-16"] = {"wall_s": wall, "q": q, "stages": stages, "run": run}

    seqs = super5_set()
    msa, wall, stages, got, run, peak, cases = run_super5(
        "synthetic-1000", seqs, dev,
        PAIR_KERNELS + DENSIFY + REFINE_KERNELS + LIST_KERNELS)
    print(f"super5 synthetic-1000: n={len(seqs)} wall={wall:.2f}s "
          f"width={msa.col_count()} peak_device_mem={peak / 2**30:.3f} GiB "
          f"stages={json.dumps({k: stages.get(k) for k in SUPER5_STAGES})} "
          f"all stages={json.dumps(stages)} run={json.dumps(run)} "
          f"launches={json.dumps(got)}", flush=True)
    rows = {s.label: s.text() for s in msa}
    text_of = {}
    for s in seqs:
        text_of.setdefault(s.text(), []).append(s.label)
    for labels in text_of.values():
        if len({rows[lb] for lb in labels}) != 1:
            raise SmokeFailure(f"synthetic-1000: duplicates {labels} differ")
    checks = {"duplicates removed": run["unique"] < run["seqs"],
              "members extended by TransAln": run["members"] > 0,
              "more than one Super4 cluster": len(run["clusters"]) > 1,
              "a cluster of 64 or more": max(run["clusters"]) >= 64,
              "PProg device joins": run["pprog_joins"]["device"] > 0}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SmokeFailure(f"synthetic-1000 skipped part of the path: {failed}")
    out["synthetic-1000"] = {"wall_s": wall, "peak_bytes": peak,
                             "stages": stages, "run": run, "list_cases": cases}
    return out


# ---------------------------------------------------------------------------
# Muscle-3D: `-align` on `.mega` structure profiles
# ---------------------------------------------------------------------------

# the mega families of phase 3 (n, shortest, longest chain, seed): mega-8
# (dense branch, host refine, kernels 1E/2E), mega-128 (the sparse store,
# bf16 Gram consistency, device refine), mega-long (the legacy route,
# kernels 1E/3/4, at pad 12288; f32 Gram consistency, host refine)
MEGA_8 = (8, 250, 450, 8)
MEGA_128 = (128, 300, 380, 128)
MEGA_LONG = (4, 8300, 9800, 4)
# their pads (the bucket ladder's), and the width at which the fused and
# the legacy routes are held against each other
MEGA_128_PAD, MEGA_LONG_PAD, ROUTES_PAD = 384, 12288, 2048
# the wave width at which kernels 1E/2E are held to kernels A/B on a
# letter lattice
LETTER_WAVE_PAD = 4096
# kernel 1E on mega-long's chunk before the wave (PERF.md, NVIDIA H100
# 80GB HBM3 at 700 W): one block a pair, S = 6
FWD_EMIS_WAS_MS = 378.3
# kernel 1E on mega-long's chunk (phase 2): ms, bound, dependency floor
WIDE_1E: dict = {}
# host refine of mega-long, cut as "long mixed"'s: a join of ~9,000-column
# profiles costs ~0.35 s on the host
MEGA_LONG_REFINE_ITERS = 20
# sha256 of mega-long's FASTA text on the H100 at commit 3a0d2bf, before
# kernel 1E ran on the wave (tools/torch_long_family_sha.py --family
# mega-long): the wave keeps every bit, so the text must not move
MEGA_LONG_SHA256 = (
    "e525e7b9a48271f82f116fe6fbaccfcdeb209197b88b0ddc0a6975b0365a2800")


def mega_set(n, lo, hi, seed):
    """A `.mega` set built from a seed by tests/mega_synth.py (8 features,
    the reference files' width; chains mutated copies of a random root:
    1-4 indels of 1-5 positions, a truncation to lo..hi, 12 % of each
    feature's letters substituted), parsed, then written and parsed again
    through the port's write_mega / parse_mega (under build/chip_smoke/).
    Returns (MegaProfileSet, each chain's root positions (-1 where
    inserted): the true alignment)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from mega_synth import chains, mega_text
    from muscle_tpu_torch.io.mega import parse_mega, write_mega
    base = os.path.join(ROOT, "build", "chip_smoke", f"mega-{n}-{seed}")
    os.makedirs(os.path.dirname(base), exist_ok=True)
    with open(base + ".txt.mega", "w") as f:
        f.write(mega_text(n, lo, hi, seed))
    write_mega(parse_mega(base + ".txt.mega"), base + ".mega")
    return parse_mega(base + ".mega"), chains(n, lo, hi, seed)[1]


def mega_seqs(ms):
    from muscle_tpu_torch import MultiSequence, Sequence
    return MultiSequence([Sequence(lb, s) for lb, s in zip(ms.labels, ms.seqs)])


def q_true(msa, labels, origins) -> float:
    """Q against the construction's true alignment: the fraction of the
    residue pairs that share a root position which the alignment puts in
    one column."""
    col = {}
    for s in msa:
        t = np.frombuffer(s.text().encode(), np.uint8)
        col[s.label] = np.flatnonzero(t != ord("-"))
    hit = total = 0
    for a in range(len(labels)):
        for b in range(a + 1, len(labels)):
            oa, ob = origins[a], origins[b]
            common, ia, ib = np.intersect1d(oa[oa >= 0], ob[ob >= 0],
                                            return_indices=True)
            ia = np.flatnonzero(oa >= 0)[ia]
            ib = np.flatnonzero(ob >= 0)[ib]
            hit += int((col[labels[a]][ia] == col[labels[b]][ib]).sum())
            total += len(common)
    return hit / max(total, 1)


def mega_batch(ms, pairs, width, dev, x_rows=None):
    """Emission lattice (B, x_rows or width, width), insert scores and
    lengths of `pairs` of `ms`, on the card (ops/emissions.py)."""
    import torch
    from muscle_tpu_torch.ops import emissions as em
    prof = torch.as_tensor(em.pad_profiles(ms.profiles, width), device=dev)
    lens = np.array([p.shape[0] for p in ms.profiles], np.int32)
    xi = torch.as_tensor([p[0] for p in pairs], device=dev)
    yi = torch.as_tensor([p[1] for p in pairs], device=dev)
    rows = x_rows or width
    w, lp, lpm = em.mega_feature_arrays(ms, dev)
    px, py = prof[xi, :rows], prof[yi]
    lx = np.minimum(lens[[p[0] for p in pairs]], rows).astype(np.int32)
    ly = lens[[p[1] for p in pairs]]
    return (em.mega_emission_matrix(px, py, w, lpm).contiguous(),
            em.mega_insert_scores(px, w, lp).contiguous(),
            em.mega_insert_scores(py, w, lp).contiguous(),
            torch.as_tensor(lx, device=dev), torch.as_tensor(ly, device=dev))


def gate(post_ref, ea_ref, post, ea):
    """The kernel gate (tests/test_pallas_fused.py:62-69): (posterior
    max |d| ignoring cells that flip at the 0.01 threshold, EA max |d|)."""
    import torch
    d = (post - post_ref).abs()
    flip = ((post == 0) | (post_ref == 0)) & \
        (torch.maximum(post, post_ref) <= 0.0102)
    return float(d.where(~flip, 0.0).max()), float((ea - ea_ref).abs().max())


# rows of each full-shape launch of kernels 1E and 3 held to the plain
# versions: the plain versions' Python row loop takes ~40 ms a row at
# Ly 12288, minutes for a whole pair
HELD_ROWS = 128


def head_rows(args, r):
    """The inputs cut to the first r rows of x (lx = r): forward rows
    i < r read x positions 0..i only."""
    import torch
    e, ins_x, ins_y, lx, ly, params = args
    return (e[:, :r].contiguous(), ins_x[:, :r].contiguous(), ins_y,
            torch.full_like(lx, r), ly, params)


def tail_rows(args, r):
    """The inputs cut to the last r real rows of x of each pair (lx = r):
    kernel 3's rows u < r read x positions lx-r..lx-1 only (row u reads
    lx-u)."""
    import torch
    e, ins_x, ins_y, lx, ly, params = args
    if int(lx.min()) < r:
        raise SmokeFailure(f"tail_rows: a pair has fewer than {r} rows")
    ar = torch.arange(e.shape[0], device=e.device)[:, None]
    idx = lx.long()[:, None] - r + torch.arange(r, device=e.device)[None, :]
    return (e[ar, idx].contiguous(), ins_x[ar, idx].contiguous(), ins_y,
            torch.full_like(lx, r), ly, params)


def hold_fwd(args, fm, r=HELD_ROWS):
    """A launch of kernel 1E on `args` held to the plain version: max |d|
    of its rows < r against fwd_emis_plain on the first r rows, and the
    plain version's ms."""
    import torch
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    head = head_rows(args, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, _ = pe.fwd_emis_plain(*head)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    lx, ly = head[3], head[4]
    return float((real_cells(fm[:, :r], lx, ly)
                  - real_cells(want, lx, ly)).abs().max()), ms


def hold_bwd(args, rb, r=HELD_ROWS):
    """A launch of kernel 3 on `args` held to the plain version: max |d|
    of its rows u < r against bwd_plain on each pair's last r rows, and
    of its rows u >= lx against 0; the plain version's ms."""
    import torch
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    tail = tail_rows(args, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pe.bwd_plain(*tail)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    d = float((rb[:, :r] - want).abs().max())
    for k, lx in enumerate(args[3].tolist()):
        d = max(d, float(rb[k, lx:].abs().max()) if lx < rb.shape[1] else 0.0)
    return d, ms


class LegacyKernelCheck:
    """Stands in for kernels 1E, 3 and 4's wrappers in the legacy route
    while mega-long runs: each launch of the main path (counted as any
    other) is held, as it happens, to the plain versions on its own
    inputs (hold_fwd, hold_bwd, and mea_scores_plain on the whole
    posterior). The seconds and device memory the checks take are kept
    out of the run's wall, its posteriors stage and its peak."""

    NAMES = ("pairhmm_fwd_emis", "pairhmm_bwd", "mea_scores")

    def __init__(self):
        self.errs = {k: [] for k in self.NAMES}
        self.seconds = 0.0
        self.peak = 0
        self.saved = {}

    def _held(self, name, check):
        import torch
        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        self.errs[name].append(check())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.seconds += time.perf_counter() - t0

    def fwd(self, *args):
        fm, fend = self.saved["pairhmm_fwd_emis"](*args)
        self._held("pairhmm_fwd_emis", lambda: hold_fwd(args, fm)[0])
        return fm, fend

    def bwd(self, *args):
        rb = self.saved["pairhmm_bwd"](*args)
        self._held("pairhmm_bwd", lambda: hold_bwd(args, rb)[0])
        return rb

    def mea(self, post, lxb, lyb):
        from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
        got = self.saved["mea_scores"](post, lxb, lyb)
        self._held("mea_scores", lambda: float(
            (got - pe.mea_scores_plain(post)).abs().max()))
        return got

    def __enter__(self):
        from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
        self.saved = {k: getattr(pe, k) for k in self.NAMES}
        pe.pairhmm_fwd_emis, pe.pairhmm_bwd, pe.mea_scores = \
            self.fwd, self.bwd, self.mea
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
        for k, fn in self.saved.items():
            setattr(pe, k, fn)


def phase_mega_kernels(dev, sets) -> list[dict]:
    """Kernels 1E, 2E, 3 and 4 against their plain versions (equal
    required): 1E and 2E at mega-128's bucket shape (256 pairs at 384),
    and fed a letter lattice against kernels A and B; 3 and 4 at
    mega-long's (8 pairs at 12288, the main path's chunk; the full-shape
    launches of 1E and 3 held on HELD_ROWS rows of each pair, hold_fwd and
    hold_bwd); the fused route
    against the legacy route on 8 mega pairs at 2048. Times (CUDA
    events), bounds and ptxas's registers and spills."""
    import torch
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe

    for line in ptxas_lines(["pairhmm_fwd_emis", "pairhmm_bwd_post_emis",
                             "pairhmm_bwd", "mea_scores"]):
        print(f"ptxas: {line}", flush=True)
    pack = HMMParams.from_defaults(nucleo=False).to_scores()
    params = pc.params_vec(pack, dev)
    out = {}

    def cells_of(lx, ly):
        return float((lx.long() * ly.long()).sum())

    # 1E and 2E at mega-128's bucket shape: its first 256 pairs at 384
    ms128 = sets["mega-128"][0]
    n128 = len(ms128.labels)
    pairs = [(x, y) for x in range(n128) for y in range(x + 1, n128)][:256]
    e, ins_x, ins_y, lx, ly = mega_batch(ms128, pairs, MEGA_128_PAD, dev)
    args = (e, ins_x, ins_y, lx, ly, params)
    fm, fend = pe.pairhmm_fwd_emis(*args)
    (fm2, fend2), plain1 = timed_once(lambda: pe.fwd_emis_plain(*args))
    d1 = max(float((real_cells(fm, lx, ly) - real_cells(fm2, lx, ly)).abs()
                    .max()),
             float((fend - fend2).abs().max()))
    tot = pc._total_prob(fend, params)
    post, mea = pe.pairhmm_bwd_post_emis(*args, tot, fm)
    (post2, mea2), plain2 = timed_once(
        lambda: pe.bwd_post_emis_plain(*args, tot, fm))
    d2 = max(float((post - post2).abs().max()), float((mea - mea2).abs().max()))
    print(f"kernel 1E pairhmm_fwd_emis vs plain at mega-128's bucket (256 "
          f"pairs, 384 x 384): max |d| {d1:.3e} "
          f"{'equal' if d1 == 0 else 'FAIL'}; kernel 2E pairhmm_bwd_post_emis "
          f"vs plain: max |d| {d2:.3e} {'equal' if d2 == 0 else 'FAIL'}",
          flush=True)
    if d1 or d2:
        raise SmokeFailure("kernel 1E or 2E differs from its plain version")
    ms1 = time_cuda(lambda: pe.pairhmm_fwd_emis(*args))
    ms2 = time_cuda(lambda: pe.pairhmm_bwd_post_emis(*args, tot, fm))
    cells = cells_of(lx, ly)
    b = len(pairs)
    # 1E: the lattice's real cells, insert scores, lengths and params in;
    # the M lattice's real cells and the final states out. 2E: the
    # lattice's and the M lattice's real cells, insert scores, lengths,
    # totals in; the dense posterior and the MEA scores out
    ins_bytes = 4 * (float(lx.sum()) + float(ly.sum()) + 2 * b + 16)
    bnd1 = bound_ms(ins_bytes + 8 * cells + 20 * b, cells * FWD_OPS_PER_CELL)
    bnd2 = bound_ms(ins_bytes + 8 * cells + 4 * b + 4 * e.numel() + 4 * b,
                    cells * BWD_POST_OPS_PER_CELL)
    print(f"kernel 1E {ms1:.3f} ms (plain {plain1:.1f} ms, bound "
          f"{bnd1[0]:.4f} ms by {bnd1[1]}); kernel 2E {ms2:.3f} ms (plain "
          f"{plain2:.1f} ms, bound {bnd2[0]:.4f} ms by {bnd2[1]}); {b} pairs, "
          f"{cells:.0f} real cells", flush=True)
    out["pairhmm_fwd_emis"] = (d1, ms1, plain1, bnd1,
                               "muscle_tpu_torch/csrc/pairhmm_fwd_emis.cu",
                               "muscle_tpu/ops/pairhmm_pallas.py:304")
    out["pairhmm_bwd_post_emis"] = (
        d2, ms2, plain2, bnd2, "muscle_tpu_torch/csrc/pairhmm_bwd_post_emis.cu",
        "muscle_tpu/ops/pairhmm_pallas.py:565")
    del e, ins_x, ins_y, args, fm, fm2, post, post2

    # fed the letter lattice match[x_i, y_j]: 1E = kernel A, 2E = kernel B
    xb, yb, lxn, lyn = ragged_batch(256, MEGA_128_PAD // 3, MEGA_128_PAD,
                                    MEGA_128_PAD, seed=384)
    x, y, lxt, lyt = (torch.from_numpy(a).to(dev) for a in (xb, yb, lxn, lyn))
    match, insert, _ = pc.tables(pack, dev)
    fma, fenda = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
    tota = pc._total_prob(fenda, params)
    posta, meaa = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                      tota, fma)
    el = match[x.long()[:, :, None], y.long()[:, None, :]].contiguous()
    largs = (el, insert[x.long()].contiguous(), insert[y.long()].contiguous(),
             lxt, lyt, params)
    fme, fende = pe.pairhmm_fwd_emis(*largs)
    poste, meae = pe.pairhmm_bwd_post_emis(*largs, tota, fma)
    torch.cuda.synchronize()
    same = (torch.equal(real_cells(fma, lxt, lyt), real_cells(fme, lxt, lyt))
            and torch.equal(fenda, fende) and torch.equal(posta, poste)
            and torch.equal(meaa, meae))
    print(f"kernels 1E/2E on the letter lattice match[x_i, y_j] (256 amino "
          f"pairs, 384 x 384) vs kernels A/B: "
          f"{'equal' if same else 'FAIL'}", flush=True)
    if not same:
        raise SmokeFailure("kernels 1E/2E differ from kernels A/B on a "
                           "letter lattice")
    del el, largs, fma, fme, posta, poste
    # the same at a wave width: 1E on the wave against kernel A on the
    # wave, every real cell of fm (every row < lx), and 2E (one block a
    # pair) against kernel B (the wave)
    xb, yb, lxn, lyn = ragged_batch(8, LETTER_WAVE_PAD // 3, LETTER_WAVE_PAD,
                                    LETTER_WAVE_PAD, seed=4096)
    x, y, lxt, lyt = (torch.from_numpy(a).to(dev) for a in (xb, yb, lxn, lyn))
    fma, fenda = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
    tota = pc._total_prob(fenda, params)
    posta, meaa = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                      tota, fma)
    el = match[x.long()[:, :, None], y.long()[:, None, :]].contiguous()
    largs = (el, insert[x.long()].contiguous(), insert[y.long()].contiguous(),
             lxt, lyt, params)
    fme, fende = bounded_pass(lambda: pe.pairhmm_fwd_emis(*largs),
                              "kernel 1E on the wave (letter lattice)", dev)
    poste, meae = pe.pairhmm_bwd_post_emis(*largs, tota, fma)
    torch.cuda.synchronize()
    pc.wavefront.check_waits(dev)
    same = (torch.equal(real_cells(fma, lxt, lyt), real_cells(fme, lxt, lyt))
            and torch.equal(fenda, fende) and torch.equal(posta, poste)
            and torch.equal(meaa, meae))
    geo = pc.ab_geometry(8, LETTER_WAVE_PAD)
    print(f"kernel 1E on the wave (G = {geo.g}, {geo.groups} groups a pair) "
          f"vs kernel A on the wave, and 2E (one block a pair) vs B (the "
          f"wave), on the letter lattice (8 amino pairs, {LETTER_WAVE_PAD} x "
          f"{LETTER_WAVE_PAD}, lx {int(lxt.min())}-{int(lxt.max())}; every "
          f"real cell of fm): {'equal' if same else 'FAIL'}", flush=True)
    if not same:
        raise SmokeFailure("kernel 1E on the wave differs from kernel A on "
                           "the wave on a letter lattice")
    del el, largs, fma, fme, posta, poste
    torch.cuda.empty_cache()

    # 3 and 4 at mega-long's shape: its 6 pairs and 2 copies of the first
    # (the main path's chunk), 8 x 12288 x 12288
    msl = sets["mega-long"][0]
    nl = len(msl.labels)
    pairs = [(x, y) for x in range(nl) for y in range(x + 1, nl)]
    pairs += [pairs[0]] * (8 - len(pairs))
    largs = mega_batch(msl, pairs, MEGA_LONG_PAD, dev) + (params,)
    lx, ly = largs[3], largs[4]
    cells = cells_of(lx, ly)
    # the full-shape launches held to the plain versions (hold_fwd,
    # hold_bwd: the first / last HELD_ROWS rows of each pair), kernel 4's
    # on the whole posterior
    geo1 = pc.ab_geometry(8, MEGA_LONG_PAD)
    fm, fend = bounded_pass(lambda: pe.pairhmm_fwd_emis(*largs),
                            "kernel 1E on mega-long's chunk, on the wave", dev)
    d1s, _ = hold_fwd(largs, fm)
    out["pairhmm_fwd_emis"] = (max(d1, d1s),) + out["pairhmm_fwd_emis"][1:]
    # kernel 3 on the wave (G = 4 at 12288), its launch bounded in wall
    # time, held to the plain version
    geo3 = pe.bwd_geometry(8, MEGA_LONG_PAD)
    rb = bounded_pass(lambda: pe.pairhmm_bwd(*largs),
                      "kernel 3 on mega-long's chunk, on the wave", dev)
    d3, plain3 = hold_bwd(largs, rb)
    print(f"kernels 1E and 3 (pairhmm_bwd) vs plain on mega-long's pairs at "
          f"8 x 12288 x 12288, lx {int(lx.min())}-{int(lx.max())}: 1E on the "
          f"wave (G = {geo1.g}, {geo1.groups} groups a pair): its "
          f"first {HELD_ROWS} rows max |d| {d1s:.3e}; 3 on the wave (G = "
          f"{geo3.g}, {geo3.groups} groups a pair): rows u < {HELD_ROWS} "
          f"(each pair's last {HELD_ROWS} rows of x) and rows u >= lx (zero) "
          f"max |d| {d3:.3e} {'equal' if d1s == d3 == 0 else 'FAIL'}",
          flush=True)
    if d1s or d3:
        raise SmokeFailure("kernel 1E or 3 differs from its plain version "
                           "at Ly = 12288")
    ms1l = time_cuda(lambda: pe.pairhmm_fwd_emis(*largs), reps=3)
    ms3 = time_cuda(lambda: pe.pairhmm_bwd(*largs), reps=3)
    pc.wavefront.check_waits(dev)
    floor1 = row_floor_ms(int(lx.max()), geo1.g, max_sm_clock_hz(), False)
    floor3 = row_floor_ms(int(lx.max()), geo3.g, max_sm_clock_hz(), True,
                          LEGACY_FLOOR)
    post = pe.finish_posteriors(fm, rb, fend, lx, ly, params)
    del rb
    got = pe.mea_scores(post, lx, ly)
    want, plain4 = timed_once(lambda: pe.mea_scores_plain(post))
    d4 = float((got - want).abs().max())
    ms4 = steady_ms(lambda: pe.mea_scores(post, lx, ly))
    pc.wavefront.check_waits(dev)
    warps4 = pe.mea_scores_warps(
        8, MEGA_LONG_PAD, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    floor4 = mea_scores_floor_ms(lx, ly, warps4, max_sm_clock_hz())
    ins_bytes = 4 * (float(lx.sum()) + float(ly.sum()) + 2 * 8 + 16)
    bnd3 = bound_ms(ins_bytes + 8 * cells, cells * BWD_OPS_PER_CELL)
    bnd4 = bound_ms(4 * cells + 3 * 4 * 8, cells * MEA_OPS_PER_CELL)
    bnd1l = bound_ms(ins_bytes + 8 * cells + 20 * 8, cells * FWD_OPS_PER_CELL)
    print(f"kernel 4 (mea_scores) vs plain on mega-long's posteriors (8 x "
          f"12288 x 12288): max |d| {d4:.3e} {'equal' if d4 == 0 else 'FAIL'}",
          flush=True)
    print(f"at mega-long's shape ({cells:.0f} real cells): kernel 1E "
          f"{ms1l:.3f} ms on the wave (was {FWD_EMIS_WAS_MS} ms one block a "
          f"pair: {FWD_EMIS_WAS_MS / ms1l:.1f}x; bound {bnd1l[0]:.4f} ms by "
          f"{bnd1l[1]}, dependency floor {floor1:.2f} ms), kernel 3 "
          f"{ms3:.3f} ms on the wave (was {BWD_WAS_MS} ms: "
          f"{BWD_WAS_MS / ms3:.1f}x; plain {plain3:.1f} ms on {HELD_ROWS} "
          f"rows, bound {bnd3[0]:.4f} ms by {bnd3[1]}, dependency floor "
          f"{floor3:.2f} ms), kernel 4 {ms4:.3f} ms on the wave of row bands "
          f"({warps4} warps a block, {pe.mea_scores_rounds(MEGA_LONG_PAD, warps4)}"
          f" rounds a pair; was {MEA_SCORES_WAS_MS[MEGA_LONG_PAD]} ms one "
          f"block a pair: {MEA_SCORES_WAS_MS[MEGA_LONG_PAD] / ms4:.1f}x; "
          f"plain {plain4:.1f} ms, bound {bnd4[0]:.4f} ms by {bnd4[1]}, "
          f"dependency floor {floor4:.3f} ms)", flush=True)
    if d4:
        raise SmokeFailure("kernel 4 differs from its plain version")
    WIDE_1E.update(ms=ms1l, bound=bnd1l[0])
    out["pairhmm_bwd"] = (d3, ms3, plain3, bnd3,
                          "muscle_tpu_torch/csrc/pairhmm_bwd.cu",
                          "muscle_tpu/ops/pairhmm_pallas.py:443")
    out["mea_scores"] = (d4, ms4, plain4, bnd4,
                         "muscle_tpu_torch/csrc/mea_scores.cu",
                         "muscle_tpu/ops/pairhmm_pallas.py:875")
    del largs, fm, post
    torch.cuda.empty_cache()

    # the two routes against each other: 8 mega-128 pairs at 2048 lanes
    e, ins_x, ins_y, lx, ly = mega_batch(ms128, pairs_of(n128, 8), ROUTES_PAD,
                                         dev)
    args = (e, ins_x, ins_y, lx, ly, params)
    post_f, ea_f = pe.emissions_path_fused(*args)
    post_l, ea_l = pe.emissions_path_legacy(*args)
    d_post, d_ea = gate(post_f, ea_f, post_l, ea_l)
    ok = d_post < 2e-3 and d_ea < 2e-3
    print(f"fused route (1E, 2E) vs legacy route (1E, 3, finish_posteriors, "
          f"4) on 8 mega pairs at 2048: posterior {d_post:.3e} (flips "
          f"ignored, tol 2e-3), EA {d_ea:.3e} (tol 2e-3) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("the fused and legacy routes disagree")
    del e, args, post_f, post_l
    torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
            for name, (err, ms, plain, bnd, src, rep) in out.items()]


def pairs_of(n, count):
    return [(x, y) for x in range(n) for y in range(x + 1, n)][:count]


MEGA_KERNELS = ("pairhmm_fwd_emis", "pairhmm_bwd_post_emis")
LEGACY_KERNELS = ("pairhmm_fwd_emis", "pairhmm_bwd", "mea_scores")


def hold_legacy_launches(name, check, got) -> None:
    """Raise unless every launch of kernels 1E, 3 and 4 in the run was
    held (LegacyKernelCheck) and equal to the plain versions."""
    for k, errs in check.errs.items():
        print(f"{name}: kernel {k} launch(es) held to the plain version on "
              f"their own inputs: max |d| {errs}", flush=True)
        if len(errs) != got[k]:
            raise SmokeFailure(f"{name}: {got[k]} {k} launches, {len(errs)} "
                               "held")
        if any(errs):
            raise SmokeFailure(f"{name}: a {k} launch differs from its plain "
                               "version")
    print(f"{name}: the checks took {check.seconds:.2f}s, taken out of the "
          "wall and of the posteriors stage", flush=True)


def phase_mega(dev, sets) -> dict:
    """`align(seqs, mega=...)` of the three mega families on the card:
    mega-8 (dense, host refine; its alignment must equal the port's own
    CPU alignment of the same file), mega-128 (sparse store, bf16 Gram
    consistency, device refine), mega-long (the legacy route, f32 Gram
    consistency, host refine cut to MEGA_LONG_REFINE_ITERS; each of its
    kernel 1E, 3 and 4 launches held to the plain versions on its own
    inputs, LegacyKernelCheck). Each must be a valid alignment through the
    kernels of its branch; Q against the construction's truth printed."""
    import hashlib

    import torch
    from muscle_tpu_torch import align
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.pipeline.mpc import PAIR_BATCH
    out = {}
    n128 = MEGA_128[0]
    chunks = -(-(n128 * (n128 - 1) // 2) // PAIR_BATCH)
    for name, kernels, routes, iters in (
            ("mega-8", MEGA_KERNELS, {"fused": 1, "legacy": 0}, 100),
            ("mega-128", MEGA_KERNELS + DENSIFY + REFINE_KERNELS,
             {"fused": chunks, "legacy": 0}, 100),
            ("mega-long", LEGACY_KERNELS + DENSIFY,
             {"fused": 0, "legacy": 1}, MEGA_LONG_REFINE_ITERS)):
        ms, origins = sets[name]
        seqs = mega_seqs(ms)
        torch.cuda.reset_peak_memory_stats()
        pe.reset_routes()
        check = LegacyKernelCheck() if name == "mega-long" else None
        with check or contextlib.nullcontext():
            msa, wall, stages, got = run_path(name, seqs, dev, kernels,
                                              mega=ms, refine_iters=iters)
        peak = peak_bytes()
        if check:
            hold_legacy_launches(name, check, got)
            wall -= check.seconds
            stages["posteriors"] = round(stages["posteriors"] - check.seconds,
                                         4)
            peak = max(peak, check.peak)
            out["legacy_errs"] = check.errs
        q = q_true(msa, ms.labels, origins)
        got_routes = dict(pe.ROUTES)
        print(f"{name}: n={len(seqs)} lengths "
              f"{min(len(s) for s in seqs)}-{max(len(s) for s in seqs)} "
              f"wall={wall:.2f}s width={msa.col_count()} Q(truth)={q:.4f} "
              f"peak_device_mem={peak / 2**30:.3f} GiB "
              f"stages={json.dumps(stages)} routes={json.dumps(got_routes)} "
              f"refine_iters={iters} launches={json.dumps(got)}", flush=True)
        if got_routes != routes:
            raise SmokeFailure(f"{name}: routes {got_routes}, want {routes}")
        if name == "mega-long":
            digest = hashlib.sha256(msa.to_fasta_text().encode()).hexdigest()
            same = digest == MEGA_LONG_SHA256
            print(f"mega-long: sha256 {digest} ({'the same as' if same else 'NOT'}"
                  " the text before kernel 1E ran on the wave)", flush=True)
            if not same:
                raise SmokeFailure("mega-long: the alignment's text moved")
        if name == "mega-8":
            t0 = time.perf_counter()
            cpu = align(seqs, mega=ms, device="cpu")
            same = cpu.to_fasta_text() == msa.to_fasta_text()
            print(f"mega-8 on the CPU (plain versions, the scan): "
                  f"{time.perf_counter() - t0:.2f}s, column-identical to the "
                  f"card's: {same}", flush=True)
            if not same:
                raise SmokeFailure("mega-8: the card's alignment differs from "
                                   "the CPU's")
        out[name] = {"wall_s": wall, "peak_bytes": peak, "stages": stages,
                     "q": q, "routes": got_routes}
    return out


# ---------------------------------------------------------------------------
# ensembles: kernels 1M / 2M (per-pair tables) and 3K (the letter path's
# legacy backward)
# ---------------------------------------------------------------------------

ENSEMBLE_SEEDS = (0, 1, 2, 3)


def ensemble_tables(dev, reps):
    """Per-lane tables (match, insert, start, tv) from the packs of
    ENSEMBLE_SEEDS (seed 0 unperturbed), lane i taking pack reps[i]; and
    the packs."""
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm as ph
    packs = []
    for seed in ENSEMBLE_SEEDS:
        hp = HMMParams.from_defaults(nucleo=False)
        if seed:
            hp.perturb(seed)
        packs.append(hp.to_scores())
    return packs, ph.score_args_multi(packs, reps, dev)


def lane_groups(match, insert, params):
    """The lanes of each pack: [lane indices] of the lanes whose match,
    insert and params rows are all equal."""
    import torch
    key = torch.cat([params, insert, match.flatten(1)], dim=1)
    rows, inv = torch.unique(key, dim=0, return_inverse=True)
    return [torch.nonzero(inv == g).flatten() for g in range(rows.shape[0])]


def hold_multi_fwd(args, fm, fend):
    """Max |d| of a kernel-1M launch's output (fm on the real cells, fend)
    against kernel A on each pack's lanes with that pack's tables."""
    import torch
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    x, y, lx, ly, m, i, p = args
    d = 0.0
    for lanes in lane_groups(m, i, p):
        k = int(lanes[0])
        sub = tuple(t[lanes].contiguous() for t in (x, y, lx, ly))
        fm1, fend1 = pc.pairhmm_fwd(*sub, m[k].contiguous(),
                                    i[k].contiguous(), p[k].contiguous())
        d = max(d, float((real_cells(fm[lanes], sub[2], sub[3])
                          - real_cells(fm1, sub[2], sub[3])).abs().max()),
                float((fend[lanes] - fend1).abs().max()))
    return d


def hold_multi_bwd(args, tot, fm, post, mea):
    """Max |d| of a kernel-2M launch (post, mea) against kernel B on each
    pack's lanes with that pack's tables, the same totals and lattice."""
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    x, y, lx, ly, m, i, p = args
    d = 0.0
    for lanes in lane_groups(m, i, p):
        k = int(lanes[0])
        sub = tuple(t[lanes].contiguous() for t in (x, y, lx, ly))
        post1, mea1 = pc.pairhmm_bwd_post(
            *sub, m[k].contiguous(), i[k].contiguous(), p[k].contiguous(),
            tot[lanes].contiguous(), fm[lanes].contiguous())
        d = max(d, float((post[lanes] - post1).abs().max()),
                float((mea[lanes] - mea1).abs().max()))
    return d


def phase_ensemble_kernels(dev, b=512, width=512) -> list[dict]:
    """Kernels 1M and 2M at B = 512, L = 512 with the 4 packs of
    ENSEMBLE_SEEDS mixed lane by lane, each against its plain version and
    each lane against kernels A/B on its pack (max |d| = 0 required);
    kernels 1E/2E with per-pair params on the per-pair lattice against
    1M/2M (= 0); kernel 3K at the same shape against its plain version
    (= 0), and the whole legacy letter route (A, 3K, finish_posteriors,
    4) against the fused route (A, B) at the kernel gate. Times (CUDA
    events), bounds, plain versions' times and ptxas's lines."""
    import torch
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe

    for line in ptxas_lines(["pairhmm_fwd", "pairhmm_bwd_post",
                             "pairhmm_bwd_codes"]):
        print(f"ptxas: {line}", flush=True)
    xb, yb, lx, ly = ragged_batch(b, width // 3, width, width, seed=20261017)
    x, y, lxt, lyt = (torch.from_numpy(a).to(dev) for a in (xb, yb, lx, ly))
    reps = [k % len(ENSEMBLE_SEEDS) for k in range(b)]
    packs, (m, i, s, t) = ensemble_tables(dev, reps)
    m, i = m.contiguous(), i.contiguous()
    p = pc.params_rows(s, t)
    args = (x, y, lxt, lyt, m, i, p)
    cells = float(np.sum(lx.astype(np.int64) * ly.astype(np.int64)))
    kk = i.shape[1]

    fm, fend = pc.pairhmm_fwd(*args)
    (fm2, fend2), plain1 = timed_once(lambda: pc.fwd_plain(*args))
    d1 = max(float((real_cells(fm, lxt, lyt)
                    - real_cells(fm2, lxt, lyt)).abs().max()),
             float((fend - fend2).abs().max()))
    tot = pc._total_prob(fend, p)
    post, mea = pc.pairhmm_bwd_post(*args, tot, fm)
    (post2, mea2), plain2 = timed_once(lambda: pc.bwd_post_plain(*args, tot,
                                                                 fm))
    d2 = max(float((post - post2).abs().max()), float((mea - mea2).abs().max()))
    lane1, lane2 = hold_multi_fwd(args, fm, fend), \
        hold_multi_bwd(args, tot, fm, post, mea)
    print(f"kernel 1M pairhmm_fwd_multi vs plain ({b} pairs, {width} x "
          f"{width}, packs of seeds {list(ENSEMBLE_SEEDS)} lane by lane): max "
          f"|d| {d1:.3e}; each pack's lanes vs kernel A on that pack: "
          f"{lane1:.3e}; kernel 2M pairhmm_bwd_post_multi vs plain: "
          f"{d2:.3e}; vs kernel B: {lane2:.3e} "
          f"{'equal' if d1 == d2 == lane1 == lane2 == 0 else 'FAIL'}",
          flush=True)
    if d1 or d2 or lane1 or lane2:
        raise SmokeFailure("kernel 1M or 2M differs from its plain version "
                           "or from kernels A/B")
    del fm2, post2

    # 1E / 2E with per-pair params on the per-pair lattice m[b, x_i, y_j]
    ar = torch.arange(b, device=dev)[:, None, None]
    el = m[ar, x.long()[:, :, None], y.long()[:, None, :]].contiguous()
    ins_x = torch.gather(i, 1, x.long()).contiguous()
    ins_y = torch.gather(i, 1, y.long()).contiguous()
    fme, fende = pe.pairhmm_fwd_emis(el, ins_x, ins_y, lxt, lyt, p)
    poste, meae = pe.pairhmm_bwd_post_emis(el, ins_x, ins_y, lxt, lyt, p, tot,
                                           fm)
    torch.cuda.synchronize()
    de = max(float((real_cells(fme, lxt, lyt)
                    - real_cells(fm, lxt, lyt)).abs().max()),
             float((fende - fend).abs().max()),
             float((poste - post).abs().max()), float((meae - mea).abs().max()))
    print(f"kernels 1E/2E with per-pair params on the per-pair lattice vs "
          f"1M/2M: max |d| {de:.3e} {'equal' if de == 0 else 'FAIL'}",
          flush=True)
    if de:
        raise SmokeFailure("kernels 1E/2E with per-pair params differ from "
                           "1M/2M")
    del el, ins_x, ins_y, fme, poste

    rb = pc.pairhmm_bwd_codes(*args)
    rb2, plain3 = timed_once(lambda: pc.bwd_codes_plain(*args))
    d3 = rbm_err(rb, rb2, lxt, lyt)
    print(f"kernel 3K pairhmm_bwd_codes vs plain (per-pair tables, {b} pairs, "
          f"{width} x {width}, {pc.bwd_codes_geometry(b, width).schedule}; "
          f"the real cells and rows u >= lx): max |d| {d3:.3e} "
          f"{'equal' if d3 == 0 else 'FAIL'}", flush=True)
    if d3:
        raise SmokeFailure("kernel 3K differs from its plain version")
    del rb2

    # the legacy letter route against the fused one, on these lanes
    post_l, ea_l = pc.batch_posteriors_cuda_multi(x, y, lxt, lyt, m, i, s, t,
                                                  fused=False)
    ea_f = mea / torch.minimum(lxt, lyt).float()
    d_post, d_ea = gate(post, ea_f, post_l, ea_l)
    ok = d_post < 2e-3 and d_ea < 2e-3
    print(f"legacy letter route (1M, 3K, finish_posteriors, 4) vs fused (1M, "
          f"2M) at {b} x {width}: posterior {d_post:.3e} (flips ignored, tol "
          f"2e-3), EA {d_ea:.3e} (tol 2e-3) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SmokeFailure("the legacy letter route disagrees with the fused "
                           "route")
    # kernel 4 on that route's posterior, the route's own shape
    got4 = pe.mea_scores(post_l, lxt, lyt)
    want4, plain4 = timed_once(lambda: pe.mea_scores_plain(post_l))
    d4 = float((got4 - want4).abs().max())
    ms4 = steady_ms(lambda: pe.mea_scores(post_l, lxt, lyt))
    pc.wavefront.check_waits(dev)
    warps4 = pe.mea_scores_warps(
        b, width, torch.cuda.get_device_properties(dev).multi_processor_count)
    bnd4 = bound_ms(4 * cells + 3 * 4 * b, cells * MEA_OPS_PER_CELL)
    floor4 = mea_scores_floor_ms(lxt, lyt, warps4, max_sm_clock_hz())
    print(f"kernel 4 (mea_scores) vs plain on the legacy letter route's "
          f"posteriors ({b} x {width} x {width}, {warps4} warps a block, "
          f"{pe.mea_scores_rounds(width, warps4)} round(s) a pair): max |d| "
          f"{d4:.3e} {'equal' if d4 == 0 else 'FAIL'}; {ms4:.4f} ms (was "
          f"{MEA_SCORES_WAS_MS[width]} ms one block a pair: "
          f"{MEA_SCORES_WAS_MS[width] / ms4:.2f}x; plain {plain4:.1f} ms, "
          f"bound {bnd4[0]:.4f} ms by {bnd4[1]}, dependency floor "
          f"{floor4:.4f} ms)", flush=True)
    if d4:
        raise SmokeFailure("kernel 4 differs from its plain version on the "
                           "legacy letter route's posteriors")
    MEA_512.update(ms=ms4, bound=bnd4[0], err=d4)
    del post_l

    ms1 = time_cuda(lambda: pc.pairhmm_fwd(*args))
    ms2 = time_cuda(lambda: pc.pairhmm_bwd_post(*args, tot, fm))
    ms3 = steady_ms(lambda: pc.pairhmm_bwd_codes(*args))
    # bytes this run's pairs need: the real codes, both lengths and each
    # pair's tables and params in; 1M writes the M lattice's real cells
    # and the final states; 2M reads those cells and the totals and
    # writes the dense posterior and the MEA scores; 3K writes RB_M's
    # real cells (the combine reads no other)
    inputs = 4 * (float(lx.sum()) + float(ly.sum()) + 2 * b
                  + b * (kk * kk + kk + 16))
    bnd1 = bound_ms(inputs + 4 * cells + 4 * 5 * b, cells * FWD_OPS_PER_CELL)
    bnd2 = bound_ms(inputs + 4 * b + 4 * cells + 4 * b * width * width
                    + 4 * b, cells * BWD_POST_OPS_PER_CELL)
    bnd3 = bound_ms(inputs + 4 * cells, cells * BWD_OPS_PER_CELL)
    print(f"kernel 1M {ms1:.3f} ms (plain {plain1:.1f} ms, bound "
          f"{bnd1[0]:.4f} ms by {bnd1[1]}); kernel 2M {ms2:.3f} ms (plain "
          f"{plain2:.1f} ms, bound {bnd2[0]:.4f} ms by {bnd2[1]}); kernel 3K "
          f"{ms3:.3f} ms ({pc.bwd_codes_geometry(b, width).schedule}; was "
          f"{BWD_CODES_WAS_MS[width]} ms: "
          f"{BWD_CODES_WAS_MS[width] / ms3:.2f}x; plain {plain3:.1f} ms, "
          f"bound {bnd3[0]:.4f} ms by {bnd3[1]}); {b} pairs, {cells:.0f} "
          f"real cells", flush=True)
    del fm, post, rb
    torch.cuda.empty_cache()
    d3w, ms3w, bnd3w = bwd_codes_wide(dev)
    rep = "muscle_tpu/ops/pairhmm_pallas.py"
    out = [{"name": name, "route": "cuda",
             "source": f"muscle_tpu_torch/csrc/{src}", "replaces": f"{rep}:{ln}",
             "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
            for name, src, ln, err, ms, plain, bnd in (
                ("pairhmm_fwd_multi", "pairhmm_fwd.cu", 304, max(d1, lane1),
                 ms1, plain1, bnd1),
                ("pairhmm_bwd_post_multi", "pairhmm_bwd_post.cu", 565,
                 max(d2, lane2), ms2, plain2, bnd2),
                ("pairhmm_bwd_codes", "pairhmm_bwd_codes.cu", 443,
                 max(d3, d3w), ms3, plain3, bnd3))]
    # 3K's wide launch on the wave beside its main-path shape
    out[-1].update(ms_4096=ms3w, bound_ms_4096=bnd3w[0])
    return out


# kernel 3K's wide launch, held and timed in phase 2: pairs, width
BWD_CODES_WIDE = (4, 4096)
# kernel 4 on the legacy letter route's 512 x 512^2 (phase 2): ms, bound
MEA_512: dict = {}


def rbm_err(rb, want, lx, ly) -> float:
    """Max |d| of a kernel-3K RB_M against its plain version on the real
    cells (rows u < lx, lanes v < ly: all that finish_posteriors reads;
    the block body leaves its segments past ly unwritten), and of its
    rows u >= lx against 0."""
    import torch
    rows = torch.arange(rb.shape[1], device=rb.device)[None, :, None]
    return max(float((real_cells(rb, lx, ly)
                      - real_cells(want, lx, ly)).abs().max()),
               float(rb.where(rows >= lx[:, None, None], 0.0).abs().max()))


def tail_codes(args, r):
    """Kernel 3K's inputs cut to the last r real rows of x of each pair
    (lx = r): its rows u < r read x positions lx-r..lx-1 only."""
    import torch
    xb, yb, lx, ly, match, insert, params = args
    if int(lx.min()) < r:
        raise SmokeFailure(f"tail_codes: a pair has fewer than {r} rows")
    ar = torch.arange(xb.shape[0], device=xb.device)[:, None]
    idx = lx.long()[:, None] - r + torch.arange(r, device=xb.device)[None, :]
    return (xb[ar, idx].contiguous(), yb, torch.full_like(lx, r), ly, match,
            insert, params)


def hold_bwd_codes(args, rb, r=HELD_ROWS):
    """A launch of kernel 3K on `args` held as hold_bwd holds kernel 3:
    max |d| of its rows u < r against bwd_codes_plain on each pair's last
    r rows of x, and of its rows u >= lx against 0; the plain version's
    ms."""
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    tail = tail_codes(args, r)
    want, ms = timed_once(lambda: pc.bwd_codes_plain(*tail))
    d = float((real_cells(rb[:, :r], tail[2], tail[3])
               - real_cells(want, tail[2], tail[3])).abs().max())
    for k, lx in enumerate(args[2].tolist()):
        d = max(d, float(rb[k, lx:].abs().max()) if lx < rb.shape[1] else 0.0)
    return d, ms


def bwd_codes_wide(dev):
    """Kernel 3K on the wave: BWD_CODES_WIDE pairs of random amino codes
    (lengths as ragged_batch) with per-pair tables, held to its plain
    version (hold_bwd_codes) and timed (steady_ms) beside its time one
    block a pair before the wave. Returns (max |d|, ms, bound)."""
    import torch
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    b, width = BWD_CODES_WIDE
    xb, yb, lx, ly = ragged_batch(b, width // 3, width, width, seed=4096)
    x, y, lxt, lyt = (torch.from_numpy(a).to(dev) for a in (xb, yb, lx, ly))
    _, (m, i, s, t) = ensemble_tables(dev, [k % len(ENSEMBLE_SEEDS)
                                            for k in range(b)])
    args = (x, y, lxt, lyt, m.contiguous(), i.contiguous(),
            pc.params_rows(s, t))
    geo = pc.bwd_codes_geometry(b, width)
    rb = bounded_pass(lambda: pc.pairhmm_bwd_codes(*args),
                      f"kernel 3K on the wave at {width}", dev)
    d, plain = hold_bwd_codes(args, rb)
    ms = steady_ms(lambda: pc.pairhmm_bwd_codes(*args))
    pc.wavefront.check_waits(dev)
    cells = float(np.sum(lx.astype(np.int64) * ly.astype(np.int64)))
    kk = i.shape[1]
    bnd = bound_ms(4 * (float(lx.sum()) + float(ly.sum()) + 2 * b
                        + b * (kk * kk + kk + 16)) + 4 * cells,
                   cells * BWD_OPS_PER_CELL)
    print(f"kernel 3K pairhmm_bwd_codes on the wave (G = {geo.g}, "
          f"{geo.groups} groups a pair; {b} pairs at {width}, lx "
          f"{int(lx.min())}-{int(lx.max())}, per-pair tables) vs plain: rows "
          f"u < {HELD_ROWS} (each pair's last {HELD_ROWS} rows of x) and "
          f"rows u >= lx (zero) max |d| {d:.3e} "
          f"{'equal' if d == 0 else 'FAIL'}; {ms:.3f} ms (was "
          f"{BWD_CODES_WAS_MS[width]} ms one block a pair: "
          f"{BWD_CODES_WAS_MS[width] / ms:.1f}x; plain {plain:.1f} ms on "
          f"{HELD_ROWS} rows, bound {bnd[0]:.4f} ms by {bnd[1]})", flush=True)
    if d:
        raise SmokeFailure("kernel 3K on the wave differs from its plain "
                           "version")
    del rb
    torch.cuda.empty_cache()
    return d, ms, bnd


MULTI_KERNELS = ("pairhmm_fwd_multi", "pairhmm_bwd_post_multi")


def hold_plain(name, args, out):
    """Max |d| of a kernel-1M or 2M launch's output against its plain
    version on all of its lanes, the same per-pair tables and inputs (fm
    on the real cells, as kernel 1M leaves the rest unwritten)."""
    import torch
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    if name == "pairhmm_fwd_multi":
        fm, fend = out
        fm2, fend2 = pc.fwd_plain(*args)
        return max(float((real_cells(fm, args[2], args[3])
                          - real_cells(fm2, args[2], args[3])).abs().max()),
                   float((fend - fend2).abs().max()))
    post, mea = out
    post2, mea2 = pc.bwd_post_plain(*args)
    return max(float((post - post2).abs().max()),
               float((mea - mea2).abs().max()))


class MultiKernelCheck:
    """Stands in for the letter-path wrappers while an ensemble runs:
    each launch of kernels 1M and 2M (per-pair tables) is held, as it
    happens, lane by lane against kernels A and B on each pack's lanes
    with that pack's tables and the same inputs (hold_multi_fwd,
    hold_multi_bwd), and the first launch of each, on all its lanes,
    against its plain version (hold_plain); the launches the checks make
    are taken back out of the counts, and the seconds and device memory
    they take out of the run's wall, stage walls and peak."""

    NAMES = ("pairhmm_fwd", "pairhmm_bwd_post")

    def __init__(self):
        self.errs = {k: [] for k in MULTI_KERNELS}
        self.plain_errs = {k: [] for k in MULTI_KERNELS}
        self.plain_shapes = {}
        self.seconds = 0.0
        self.peak = 0
        self.saved = {}

    def _held(self, into, check):
        import torch
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        counts, scheds = dict(pc.LAUNCHES), pc.SCHEDULES.copy()
        into.append(check())
        pc.LAUNCHES.update(counts)
        pc.SCHEDULES.clear()
        pc.SCHEDULES.update(scheds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.seconds += time.perf_counter() - t0

    def _hold(self, name, lanes, args, out):
        self._held(self.errs[name], lanes)
        if not self.plain_errs[name]:
            self.plain_shapes[name] = tuple(args[4].shape[:1]) \
                + tuple(args[0].shape[1:]) + tuple(args[1].shape[1:])
            self._held(self.plain_errs[name],
                       lambda: hold_plain(name, args, out))

    def fwd(self, *args):
        fm, fend = self.saved["pairhmm_fwd"](*args)
        if args[4].dim() == 3:
            self._hold("pairhmm_fwd_multi",
                       lambda: hold_multi_fwd(args, fm, fend), args,
                       (fm, fend))
        return fm, fend

    def bwd_post(self, *args, **kwargs):
        post, mea = self.saved["pairhmm_bwd_post"](*args, **kwargs)
        if args[4].dim() == 3:
            self._hold("pairhmm_bwd_post_multi",
                       lambda: hold_multi_bwd(args[:7], args[7], args[8],
                                              post, mea),
                       args[:9], (post, mea))
        return post, mea

    def __enter__(self):
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        self.saved = {k: getattr(pc, k) for k in self.NAMES}
        pc.pairhmm_fwd, pc.pairhmm_bwd_post = self.fwd, self.bwd_post
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        for k, fn in self.saved.items():
            setattr(pc, k, fn)


class LetterLegacyCheck:
    """Stands in for kernels 3K's and 4's wrappers while the legacy letter
    route runs: each launch held, as it happens, to its plain version on
    the same inputs; the checks' time kept out of the wall."""

    def __init__(self):
        self.errs: list[float] = []
        self.mea_errs: list[float] = []
        self.seconds = 0.0
        self.saved = {}

    def _held(self, errs, check):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        errs.append(check())
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def bwd(self, *args, **kwargs):
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        rb = self.saved["bwd"](*args, **kwargs)
        self._held(self.errs, lambda: rbm_err(
            rb, pc.bwd_codes_plain(*args), args[2], args[3]))
        return rb

    def mea(self, post, *args, **kwargs):
        from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
        got = self.saved["mea"](post, *args, **kwargs)
        self._held(self.mea_errs, lambda: float(
            (got - pe.mea_scores_plain(post)).abs().max()))
        return got

    def __enter__(self):
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
        self.saved = {"bwd": pc.pairhmm_bwd_codes, "mea": pe.mea_scores}
        pc.pairhmm_bwd_codes, pe.mea_scores = self.bwd, self.mea
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
        pc.pairhmm_bwd_codes = self.saved["bwd"]
        pe.mea_scores = self.saved["mea"]


def efa_blocks(path):
    """[(name, FASTA text)] of an EFA, in its order."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("<"):
                out.append([line[1:].strip(), ""])
            else:
                out[-1][1] += line
    return [tuple(b) for b in out]


def run_ensemble(name, seqs, dev, opts, workdir):
    """One run_align_command("align", ...) of an ensemble, the function
    the CLI calls: the launch counts set to 0 just before it and read
    just after; kernels 1M and 2M must have launched, every launch of
    them is held to the single-pack kernels and the first of each to its
    plain version (MultiKernelCheck); every replicate must be an
    alignment of the input. Returns (EFA path, blocks, wall s, stage
    walls, peak device bytes, launches, the check)."""
    import torch
    from muscle_tpu_torch.pipeline.ensemble import run_align_command
    from muscle_tpu_torch.utils import logging as mlog
    inp = os.path.join(workdir, f"{name}.fa")
    seqs.write_fasta(inp)
    efa = os.path.join(workdir, f"{name}.efa")
    mlog.STAGE_TIMES.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with MultiKernelCheck() as check:
        t0 = time.perf_counter()
        run_align_command("align", inp, efa, {**opts, "device": str(dev)})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - check.seconds
    got = count_main_path()
    peak = max(torch.cuda.max_memory_allocated(), check.peak)
    missing = [k for k in MULTI_KERNELS if got[k] <= 0]
    if missing:
        raise SmokeFailure(f"{name}: {missing} not launched")
    for k, errs in check.errs.items():
        print(f"{name}: {len(errs)} kernel {k} launch(es) held lane by lane "
              f"to the single-pack kernels: max |d| {max(errs or [0.0]):.3e}",
              flush=True)
        if len(errs) != got[k]:
            raise SmokeFailure(f"{name}: {got[k]} {k} launches, {len(errs)} "
                               "held")
        if any(errs):
            raise SmokeFailure(f"{name}: a {k} launch differs from the "
                               "single-pack kernels")
        plain = check.plain_errs[k]
        print(f"{name}: kernel {k}'s first launch ({check.plain_shapes.get(k)}"
              f" lanes x Lx x Ly) held on all its lanes to its plain version: "
              f"max |d| {max(plain or [0.0]):.3e}", flush=True)
        if len(plain) != 1 or any(plain):
            raise SmokeFailure(f"{name}: kernel {k}'s first launch unheld or "
                               "different from its plain version")
    blocks = efa_blocks(efa)
    from muscle_tpu_torch import MultiSequence
    for rep, text in blocks:
        check_alignment(seqs, MultiSequence.from_fasta_text(text),
                        f"{name} replicate {rep}")
    stages = {}
    for k, v in mlog.STAGE_TIMES.items():
        if k.startswith("ensemble posteriors"):
            v -= check.seconds
        stages[k] = round(v, 4)
    return efa, blocks, wall, stages, peak, got, check


def print_efa_tools(name, efa):
    """-maxcc, -disperse and -efastats of an ensemble's EFA (the port's
    CLI handlers)."""
    import io
    from muscle_tpu_torch.cli import main as cli_main
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for cmd in ("maxcc", "disperse", "efastats"):
            if cli_main([f"-{cmd}", efa, "-quiet"]) != 0:
                raise SmokeFailure(f"{name}: -{cmd} failed")
    lines = buf.getvalue().splitlines()
    for line in lines[:2]:
        print(f"{name}: {line}", flush=True)
    print(f"{name}: -efastats {lines[2]}; {len(lines) - 3} replicate lines "
          f"(EFA tools {time.perf_counter() - t0:.2f}s)", flush=True)


# ensemble-48: a Pfam-seed-sized protein family, padded to 384 so that
# n * pad = 18,432 > SMALL_DENSE_NL and the serial MPC takes the same
# Gram-consistency, host-refine branch as the batched loop
ENSEMBLE_48 = (48, 300, 384, 48)


def phase_ensembles(dev) -> dict:
    """The ensembles through run_align_command (the CLI's function):
    ensemble-48 (-stratified: seeds 0-3 x none/abc/acb/bca, default
    consiters and refineiters; its none.0 must equal align() of the same
    family), diversified-BB11002 (-diversified: 100 replicates, seed 0
    unperturbed, on the degapped golden; none.0's identity to the golden
    and Q printed), each with every kernel-1M/2M launch held lane by lane
    and the first of each held to its plain version (MultiKernelCheck);
    then legacy-BB11001 (align() under the legacy
    letter route, fused=False: kernels A, 3K, 4, each 3K launch held to
    its plain version)."""
    import tempfile
    import torch
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    out = {}
    # inputs and EFAs go under the checkout's gitignored build/
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        n, lo, hi, seed = ENSEMBLE_48
        seqs = synthetic_family(n, lo, hi, seed=seed)
        name = "ensemble-48"
        efa, blocks, wall, stages, peak, got, check = run_ensemble(
            name, seqs, dev, {"stratified": True}, workdir)
        print(f"{name}: n={n} L {min(len(s) for s in seqs)}-"
              f"{max(len(s) for s in seqs)} -stratified: {len(blocks)} "
              f"replicates wall={wall:.2f}s (checks {check.seconds:.2f}s "
              f"out) peak_device_mem={peak / 2**30:.3f} GiB "
              f"stages={json.dumps(stages)} launches={json.dumps(got)}",
              flush=True)
        if [b[0] for b in blocks] != [f"{p}.{s}" for s in range(4)
                                      for p in ("none", "abc", "acb", "bca")]:
            raise SmokeFailure(f"{name}: replicates {[b[0] for b in blocks]}")
        msa, swall, sstages, _ = run_path(f"{name} align", seqs, dev,
                                          PAIR_KERNELS + DENSIFY)
        same = msa.to_fasta_text() == blocks[0][1]
        print(f"{name}: align() of the same family wall={swall:.2f}s "
              f"stages={json.dumps(sstages)}; replicate none.0 equal to it: "
              f"{same}", flush=True)
        if not same:
            raise SmokeFailure(f"{name}: replicate none.0 differs from align()")
        print_efa_tools(name, efa)
        out[name] = {"wall_s": wall, "stages": stages, "peak_bytes": peak,
                     "align_wall_s": swall, "errs": check.errs,
                     "plain_errs": check.plain_errs}

        gold = MultiSequence.from_fasta(
            os.path.join(ROOT, "tests/goldens/BB11002.seq.afa"))
        seqs = MultiSequence.from_fasta(
            os.path.join(ROOT, "tests/goldens/BB11002.seq.afa"),
            strip_gaps=True)
        name = "diversified-BB11002"
        efa, blocks, wall, stages, peak, got, check = run_ensemble(
            name, seqs, dev, {"diversified": True}, workdir)
        none0 = MultiSequence.from_fasta_text(blocks[0][1])
        ident = ({s.label: s.text() for s in none0}
                 == {s.label: s.text() for s in gold})
        print(f"{name}: n={len(seqs)} -diversified: {len(blocks)} replicates "
              f"wall={wall:.2f}s (checks {check.seconds:.2f}s out) "
              f"peak_device_mem={peak / 2**30:.3f} GiB "
              f"stages={json.dumps(stages)} launches={json.dumps(got)}; "
              f"none.0 column-identical to the golden: {ident}, "
              f"Q={q_score(none0, gold):.4f}", flush=True)
        if len(blocks) != 100 or blocks[0][0] != "none.0":
            raise SmokeFailure(f"{name}: {len(blocks)} replicates")
        print_efa_tools(name, efa)
        out[name] = {"wall_s": wall, "stages": stages, "peak_bytes": peak,
                     "errs": check.errs, "plain_errs": check.plain_errs}

    name = "legacy-BB11001"
    seqs = MultiSequence.from_fasta(
        os.path.join(ROOT, FAMILIES[0][1]), strip_gaps=True)
    saved = pc.FUSED
    pc.FUSED = False
    try:
        with LetterLegacyCheck() as check:
            msa, wall, stages, got = run_path(
                name, seqs, dev, ("pairhmm_fwd", "pairhmm_bwd_codes",
                                  "mea_scores"))
    finally:
        pc.FUSED = saved
    wall -= check.seconds
    fused, _, _, _ = run_path(f"{name} fused", seqs, dev, PAIR_KERNELS)
    same = msa.to_fasta_text() == fused.to_fasta_text()
    gold = MultiSequence.from_fasta(os.path.join(ROOT, FAMILIES[0][3]))
    print(f"{name}: the legacy letter route (fused=False): wall={wall:.2f}s "
          f"launches={json.dumps(got)}; {len(check.errs)} kernel-3K and "
          f"{len(check.mea_errs)} kernel-4 launch(es) held to the plain "
          f"versions: max |d| {max(check.errs or [0.0]):.3e}, "
          f"{max(check.mea_errs or [0.0]):.3e}; text equal to the fused "
          f"route's: {same}; Q vs golden {q_score(msa, gold):.4f}",
          flush=True)
    if (len(check.errs) != got["pairhmm_bwd_codes"] or any(check.errs)
            or len(check.mea_errs) != got["mea_scores"]
            or any(check.mea_errs)):
        raise SmokeFailure(f"{name}: a kernel-3K or kernel-4 launch unheld "
                           "or different from its plain version")
    out[name] = {"wall_s": wall, "errs": check.errs,
                 "mea_errs": check.mea_errs}
    return out


# ---------------------------------------------------------------------------
# Super6 / Super7: the NW Viterbi and SW score kernels (ops/dp_cuda.py)
# ---------------------------------------------------------------------------

# phase 2's batches: 64 ragged amino pairs at each pad (385 / 2049 NW
# lanes: one column a thread, and three)
DP_PAIRS = 64
DP_WIDTHS = (384, 2048)
# f32 operations a DP cell, the least work of the function (a running
# gap scan, 2 a cell). NW: the trace bits (m + open, d + ext, i + ext,
# max(m, d), 3 compares), best (2 max), M' (1 add), D' (1 max), I' (the
# scan input's add and the scan's add and max) = 14; SW: F (3 adds, 1
# max), Z (1 add, 2 max, the mask), E (2 adds; the scan's add and max),
# H (2 max, the mask), the running best (1 max) = 16
NW_OPS_PER_CELL = 14
SW_OPS_PER_CELL = 16
# main-path launches held to the plain versions as they happen, in each
# Super6 / Super7 / -protdists run (DpCheck)
HELD_DP = {"nw_viterbi": 4, "sw_scores": 2}
# the kernels' entries: their times at phase 2's second pad
DP_WIDE: dict = {}


def dp_bound(name, args) -> tuple[float, str]:
    """bound_ms of one nw_viterbi / sw_scores call on `args`: NW reads
    the codes and writes every row's bits, the final rows and the scores,
    and does NW_OPS_PER_CELL on every cell of its (BX, BY+1) lattice (it
    computes all rows: the bits of each are its output); SW reads the
    codes and writes B scores, its operations on each pair's lx x ly real
    cells (the rows past lx are masked to 0 and the kernel stops there)."""
    xb, yb, lxb, lyb, subst = args
    b, bx = xb.shape
    by = yb.shape[1]
    inputs = 4 * (b * (bx + by) + 2 * b + subst.numel())
    if name == "nw_viterbi":
        return bound_ms(inputs + b * bx * (by + 1) + 4 * b * 3 * (by + 1)
                        + 4 * b, NW_OPS_PER_CELL * b * bx * (by + 1))
    cells = float((lxb.long().clamp(max=bx) * lyb.long()).sum())
    return bound_ms(inputs + 4 * b, SW_OPS_PER_CELL * cells)


def dp_case(name, args, got=None) -> dict:
    """nw_viterbi or sw_scores held against its plain version on `args`
    (the launch's output `got`, or a launch of its own): NW's bits must
    be equal and its final rows and scores max |d| = 0, SW's scores
    max |d| = 0."""
    import torch
    from muscle_tpu_torch.ops import dp_cuda, nw, sw
    if got is None:
        got = getattr(dp_cuda, name)(*args)
        torch.cuda.synchronize()
    plain = nw.nw_viterbi_plain if name == "nw_viterbi" else \
        sw.sw_scores_plain
    want, plain_ms = timed_once(lambda: plain(*args))
    if name == "nw_viterbi":
        bits_same = torch.equal(got[0], want[0])
        err = max(float((got[1] - want[1]).abs().max()),
                  float((got[2] - want[2]).abs().max()))
    else:
        bits_same = True
        err = float((got - want).abs().max())
    xb, yb = args[:2]
    return {"name": name, "shape": (xb.shape[0], xb.shape[1], yb.shape[1]),
            "err": err, "bits_same": bits_same,
            "same": bits_same and err == 0.0, "plain_ms": plain_ms,
            "bound": dp_bound(name, args)}


def dp_args(b, width, seed, dev):
    """ragged_batch's amino pairs (wildcard-padded; pair 0 at lx = ly =
    width) and BLOSUM62_21, on the card."""
    import torch
    from muscle_tpu_torch.ops.sw import BLOSUM62_21
    xb, yb, lx, ly = ragged_batch(b, width // 3, width, width, seed)
    return (tuple(torch.from_numpy(a).to(dev) for a in (xb, yb, lx, ly))
            + (torch.as_tensor(BLOSUM62_21, device=dev),))


def phase_dp_kernels(dev) -> list[dict]:
    """nw_viterbi and sw_scores against their plain versions at
    DP_PAIRS pairs at each DP_WIDTHS pad (bits equal, max |d| = 0),
    their ptxas lines, their times (CUDA events) and bounds."""
    from muscle_tpu_torch.ops import dp_cuda
    for line in ptxas_lines(list(dp_cuda.LAUNCHES)):
        if any(f"C={c}>" in line for c in (1, 2, 3)):
            print(f"ptxas {line}", flush=True)
    rows = {}
    for width in DP_WIDTHS:
        args = dp_args(DP_PAIRS, width, 20261018 + width, dev)
        for name in dp_cuda.LAUNCHES:
            case = dp_case(name, args)
            ms = time_cuda(lambda: getattr(dp_cuda, name)(*args))
            threads, cols = dp_cuda.geometry(width + (name == "nw_viterbi"))
            bnd = case["bound"]
            print(f"{name} vs plain at {DP_PAIRS} pairs, pad {width} "
                  f"({threads} threads x {cols} column(s)): "
                  f"{'bits equal, ' if name == 'nw_viterbi' and case['bits_same'] else ''}"
                  f"max |d| {case['err']:.3e} "
                  f"{'equal' if case['same'] else 'FAIL'}; {ms:.4f} ms "
                  f"(plain {case['plain_ms']:.1f} ms, bound {bnd[0]:.5f} ms "
                  f"by {bnd[1]})", flush=True)
            if not case["same"]:
                raise SmokeFailure(f"{name} disagrees with its plain version "
                                   f"at pad {width}")
            rows.setdefault(name, {})[width] = (case, ms)
    out = []
    for name, src, rep in (("nw_viterbi", "nw_viterbi.cu",
                            "muscle_tpu/ops/nw.py:98"),
                           ("sw_scores", "sw_scores.cu",
                            "muscle_tpu/ops/sw.py:115")):
        (c0, ms0), (c1, ms1) = (rows[name][w] for w in DP_WIDTHS)
        DP_WIDE[name] = {"ms": ms1, "plain_ms": c1["plain_ms"],
                         "bound_ms": c1["bound"][0]}
        out.append({"name": name, "route": "cuda",
                    "source": f"muscle_tpu_torch/csrc/{src}",
                    "replaces": rep, "launches": 0,
                    "max_abs_err": max(c0["err"], c1["err"]), "ms": ms0,
                    "plain_ms": c0["plain_ms"], "bound_ms": c0["bound"][0],
                    "bound_by": c0["bound"][1], "library_ms": None})
    return out


class DpCheck(HeldLaunches):
    """Stands in for ops/nw.nw_viterbi_batch and ops/sw.sw_scores_batch
    while the Super6 / Super7 / -protdists runs go: after `arm()`, the
    first HELD_DP[name] launches of each kernel are held against the
    plain version on the same inputs (dp_case); every launch is counted
    by the wrappers as any other."""

    def __init__(self):
        super().__init__()
        self.left: dict[str, int] = {}
        self._saved = None

    def arm(self) -> None:
        self.left = dict(HELD_DP)

    def _held(self, name, launch):
        def held(*args):
            out = launch(*args)
            if self.left.get(name, 0) > 0:
                self.left[name] -= 1
                self.hold(functools.partial(dp_case, name), args, out)
            return out
        return held

    def __enter__(self):
        from muscle_tpu_torch.ops import dp_cuda, nw, sw
        self._saved = (nw.nw_viterbi_batch, sw.sw_scores_batch)
        nw.nw_viterbi_batch = self._held("nw_viterbi", dp_cuda.nw_viterbi)
        sw.sw_scores_batch = self._held("sw_scores", dp_cuda.sw_scores)
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.ops import nw, sw
        nw.nw_viterbi_batch, sw.sw_scores_batch = self._saved

    def held_since(self, name: str, n_cases: int, got: dict) -> None:
        """Print and require the cases held since there were `n_cases`:
        one at least for each DP kernel the run launched, each equal."""
        new = self.cases[n_cases:]
        for i, c in enumerate(new):
            bnd = c["bound"]
            print(f"{c['name']} vs plain on {name}'s held launch {i + 1} of "
                  f"{len(new)} ({c['shape'][0]} pairs, {c['shape'][1]} x "
                  f"{c['shape'][2]}): "
                  f"{'bits equal, ' if c['name'] == 'nw_viterbi' and c['bits_same'] else ''}"
                  f"max |d| {c['err']:.3e} "
                  f"{'equal' if c['same'] else 'FAIL'} (plain "
                  f"{c['plain_ms']:.1f} ms; bound {bnd[0]:.5f} ms by "
                  f"{bnd[1]})", flush=True)
        for k in HELD_DP:
            if got.get(k, 0) and not any(c["name"] == k for c in new):
                raise SmokeFailure(f"{name}: {got[k]} {k} launches, none held")
        if not all(c["same"] for c in new):
            raise SmokeFailure(f"{name}: a DP kernel launch disagrees with its "
                               "plain version")


DP_CHECK = DpCheck()

# tests/test_super6.py: the reference binary's -protdists on BB11001
# (label-pair order i > j), whose degapped chains are the golden's
REF_PROTDISTS = {
    ("1j46_A", "1aab_"): 1.188,
    ("1k99_A", "1aab_"): 1.314,
    ("1k99_A", "1j46_A"): 1.406,
    ("2lef_A", "1aab_"): 1.339,
    ("2lef_A", "1j46_A"): 1.42,
    ("2lef_A", "1k99_A"): 1.406,
}
# Super6's set: the first SUPER6_ROWS rows of super5_set()
SUPER6_ROWS = 1000
# Super7 on the degapped rdrp-16 golden at this shrub size
RDRP16_SHRUB = 4
SUPER6_STAGES = ("uclustpd", "cluster_dists", "cluster_mpcs", "pprog")
SUPER7_STAGES = ("guide_tree", "shrub_mpcs", "pprog")


def run_super67(name, cmd, inp, seqs, workdir, kernels, opts):
    """One run_align_command (the CLI's function) of `cmd` on the file
    `inp` (`seqs` its rows) on the card: launch counts set to 0 just
    before it and read just after, each kernel of `kernels` required;
    the first NW / SW launches held (DP_CHECK), and the kernel-7 and
    mea_dirs launches as in every run (GRID_CHECK, MEA_CHECK), their
    time taken out of the wall and the stages. Returns (msa, wall s,
    stage walls, launches, peak device bytes)."""
    import torch
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.pipeline.ensemble import run_align_command
    from muscle_tpu_torch.utils import logging as mlog
    out = os.path.join(workdir, f"{name}.afa")
    mlog.STAGE_TIMES.clear()
    torch.cuda.reset_peak_memory_stats()
    n_dp, d0 = len(DP_CHECK.cases), DP_CHECK.seconds
    n_cases, s0 = len(GRID_CHECK.cases), GRID_CHECK.seconds
    m_cases, m0 = len(MEA_CHECK.cases), MEA_CHECK.seconds
    mp0 = MEA_CHECK.pprog_seconds
    GRID_CHECK.peak = MEA_CHECK.peak = DP_CHECK.peak = 0
    reset_launches()
    DP_CHECK.arm()
    t0 = time.perf_counter()
    run_align_command(cmd, inp, out, dict(opts))
    torch.cuda.synchronize()
    dp_held = DP_CHECK.seconds - d0
    pprog_held = MEA_CHECK.pprog_seconds - mp0
    grid_held = GRID_CHECK.seconds - s0 + MEA_CHECK.seconds - m0 - pprog_held
    wall = time.perf_counter() - t0 - dp_held - pprog_held - grid_held
    got = count_main_path()
    peak = max(peak_bytes(), DP_CHECK.peak)
    missing = [k for k in kernels if got[k] <= 0]
    if missing:
        raise SmokeFailure(f"{name}: {missing} not launched")
    DP_CHECK.held_since(name, n_dp, got)
    GRID_CHECK.held_since(name, n_cases, got["densify_reduce"])
    MEA_CHECK.held_since(name, m_cases, got["mea_dirs"])
    msa = MultiSequence.from_fasta(out)
    check_alignment(seqs, msa, name)
    # the NW holds fall in UClustPD, the SW ones in the guide tree
    taken = {"uclustpd": dp_held, "guide_tree": dp_held, "pprog": pprog_held,
             "cluster_mpcs": grid_held, "shrub_mpcs": grid_held}
    stages = {k: round(v - taken.get(k, 0.0), 4)
              for k, v in mlog.STAGE_TIMES.items()}
    held = dp_held + pprog_held + grid_held
    if held:
        print(f"{name}: held launches' checks took {held:.2f}s, taken out "
              "of the wall and the stages", flush=True)
    return msa, wall, stages, got, peak


def phase_super67(dev, sets) -> dict:
    """-protdists on the degapped BB11001 golden through the CLI (each
    distance within 5e-4 of the reference binary's, raises); Super6 with
    default settings on super5_set()'s first SUPER6_ROWS rows; Super7 on
    mega-128 (shrub_size 32, the SW tree: Q against the truth), on
    mega-8 at shrub_size 3 (the card's text must equal the port's CPU
    text, raises) and on the degapped rdrp-16 golden at shrub_size
    RDRP16_SHRUB: each an alignment of its input through its kernels."""
    import tempfile

    import torch
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.cli import main as cli_main
    from muscle_tpu_torch.pipeline import super6
    from muscle_tpu_torch.pipeline.ensemble import run_align_command
    out = {}
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir, DP_CHECK:
        # -protdists on BB11001
        name = "protdists-BB11001"
        tsv = os.path.join(workdir, "bb11001.tsv")
        n_dp = len(DP_CHECK.cases)
        reset_launches()
        DP_CHECK.arm()
        t0 = time.perf_counter()
        rc = cli_main(["-protdists", os.path.join(ROOT, FAMILIES[0][1]),
                       "-output", tsv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = count_main_path()
        DP_CHECK.held_since(name, n_dp, got)
        dists = {}
        with open(tsv) as f:
            for line in f:
                a, b, d = line.split("\t")
                dists[frozenset((a, b))] = float(d)
        errs = {f"{a}/{b}": abs(dists[frozenset((a, b))] - want)
                for (a, b), want in REF_PROTDISTS.items()}
        print(f"{name}: -protdists rc={rc} wall={wall:.2f}s (checks in) "
              f"distances={json.dumps({f'{a}/{b}': dists[frozenset((a, b))] for a, b in REF_PROTDISTS})} "
              f"max |d| to the reference binary {max(errs.values()):.1e} "
              f"(tol 5e-4) launches={json.dumps(got)}", flush=True)
        if rc != 0 or got["nw_viterbi"] <= 0 or max(errs.values()) > 5e-4:
            raise SmokeFailure(f"{name}: distances off the reference binary's")
        out[name] = {"wall_s": wall, "dists": errs}

        # Super6 on synthetic-1000
        seqs = MultiSequence(list(super5_set())[:SUPER6_ROWS])
        name = f"super6 synthetic-{len(seqs)}"
        inp = os.path.join(workdir, "super6.fa")
        seqs.write_fasta(inp)
        msa, wall, stages, got, peak = run_super67(
            name, "super6", inp, seqs, workdir,
            ("nw_viterbi",) + PAIR_KERNELS, {})
        run = dict(super6.LAST_RUN)
        print(f"{name}: n={len(seqs)} wall={wall:.2f}s width={msa.col_count()} "
              f"peak_device_mem={peak / 2**30:.3f} GiB "
              f"stages={json.dumps({k: stages.get(k) for k in SUPER6_STAGES})} "
              f"all stages={json.dumps(stages)} run={json.dumps(run)} "
              f"launches={json.dumps(got)}", flush=True)
        out["super6"] = {"wall_s": wall, "stages": stages, "run": run,
                         "peak_bytes": peak}

        # Super7 on mega-128 (shrub 32, SW tree) and mega-8 (shrub 3)
        for key, spec, shrub in (("mega-128", MEGA_128, 32),
                                 ("mega-8", MEGA_8, 3)):
            ms, origins = sets[key]
            seqs = mega_seqs(ms)
            n, _, _, seed = spec
            inp = os.path.join(ROOT, "build", "chip_smoke",
                               f"mega-{n}-{seed}.mega")
            name = f"super7 {key} shrub {shrub}"
            opts = {"shrub_size": str(shrub)}
            msa, wall, stages, got, peak = run_super67(
                name.replace(" ", "-"), "super7", inp, seqs, workdir,
                ("sw_scores",) + MEGA_KERNELS, opts)
            q = q_true(msa, ms.labels, origins)
            print(f"{name}: n={len(seqs)} wall={wall:.2f}s "
                  f"width={msa.col_count()} Q(truth)={q:.4f} "
                  f"peak_device_mem={peak / 2**30:.3f} GiB "
                  f"stages={json.dumps({k: stages.get(k) for k in SUPER7_STAGES})} "
                  f"launches={json.dumps(got)}", flush=True)
            out[name] = {"wall_s": wall, "stages": stages, "q": q}
            if key == "mega-8":
                cpu_out = os.path.join(workdir, "super7-mega-8-cpu.afa")
                DP_CHECK.left.clear()
                t0 = time.perf_counter()
                run_align_command("super7", inp, cpu_out,
                                  dict(opts, device="cpu"))
                with open(cpu_out) as f:
                    same = f.read() == msa.to_fasta_text()
                print(f"{name} on the CPU (plain versions): "
                      f"{time.perf_counter() - t0:.2f}s, text equal to the "
                      f"card's: {same}", flush=True)
                if not same:
                    raise SmokeFailure(f"{name}: the card's text differs from "
                                       "the CPU's")

        # Super7 on rdrp-16 (letters, SW tree)
        seqs = MultiSequence.from_fasta(os.path.join(ROOT, RDRP16),
                                        strip_gaps=True)
        inp = os.path.join(workdir, "rdrp16.fa")
        seqs.write_fasta(inp)
        name = f"super7 rdrp-16 shrub {RDRP16_SHRUB}"
        msa, wall, stages, got, peak = run_super67(
            name.replace(" ", "-"), "super7", inp, seqs, workdir,
            ("sw_scores",) + PAIR_KERNELS,
            {"shrub_size": str(RDRP16_SHRUB)})
        gold = MultiSequence.from_fasta(os.path.join(ROOT, RDRP16))
        print(f"{name}: n={len(seqs)} wall={wall:.2f}s "
              f"width={msa.col_count()} Q(vs its super5 golden)="
              f"{q_score(msa, gold):.4f} "
              f"stages={json.dumps({k: stages.get(k) for k in SUPER7_STAGES})} "
              f"launches={json.dumps(got)}", flush=True)
        out[name] = {"wall_s": wall, "stages": stages}
    return out


# phase_surface: a repeat-rich family (a period-3 motif, few
# substitutions: n, lo, hi, period, seed) whose posterior rows hold more
# than 8 entries, so that under sparse_k=16 the pair store keeps 16
# slots a row (and max_nnz is clamped to 16) through kernels 8 and 7
SURFACE_REPEAT = (70, 200, 256, 3, 70)
# kernel 3K at phase 2's shape (512 pairs, 512 x 512, per-pair tables)
# before its corner output: PERF.md row 3K
BWD_CODES_BEFORE_CORNER_MS = 3.041
BWD_CODES_CORNER_SHAPE = (512, 512)   # pairs, width
# the host-only commands' inputs: the seven BAliBASE goldens for -bench
BENCH_GOLDENS = [f"BB1100{k}.seq.afa" for k in (1, 2, 4, 5, 6, 7, 9)]


def repeat_family(n, lo, hi, period, seed):
    """Proteins of lo..hi residues cut from one random period-`period`
    motif repeated, at a random phase, with up to 1/40 of the positions
    substituted: every shift by the period aligns nearly as well."""
    from muscle_tpu_torch import MultiSequence, Sequence
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, 20, size=period)
    seqs = MultiSequence()
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        start = int(rng.integers(0, period))
        mut = np.tile(motif, hi // period + 2)[start:start + ln].copy()
        nmut = int(rng.integers(0, ln // 40))
        pos = rng.integers(0, ln, size=nmut)
        mut[pos] = rng.integers(0, 20, size=nmut)
        seqs.add(Sequence(f"r{i}", bytes(AMINO_LETTERS[c] for c in mut)))
    return seqs


class PanelCheck:
    """Stands in for kernel 8 in the blocked consistency while one run
    goes: its first launch held to densify_panel_plain on the same
    inputs (max |d|, the store's K)."""

    def __init__(self):
        self.cases: list[dict] = []
        self._left = 0
        self._saved = None

    def __call__(self, vals, cols, pids, flags, dtype):
        import torch
        from muscle_tpu_torch.ops import densify_cuda as dc
        out = self._saved(vals, cols, pids, flags, dtype)
        if self._left > 0:
            self._left -= 1
            want = dc.densify_panel_plain(vals, cols, pids, flags, dtype)
            torch.cuda.synchronize()
            self.cases.append({
                "err": float((out.float() - want.float()).abs().max()),
                "same": torch.equal(out, want), "k": int(vals.shape[2]),
                "shape": f"{pids.shape[0]} x {pids.shape[1]} blocks of "
                         f"L = {vals.shape[1]}, {dtype}"})
            del want
        return out

    def __enter__(self):
        from muscle_tpu_torch.ops import consistency
        self._saved = consistency.densify_panel
        self._left = 1
        consistency.densify_panel = self
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.ops import consistency
        consistency.densify_panel = self._saved


class TestfbCheck:
    """Stands in for kernels A and 3K's wrappers while -testfb runs: the
    first launch of each held to its plain version on the same inputs
    (A: fm on the real cells and fend; 3K with its corner output: the
    corner and RB_M on the real cells and the zero rows), and the totals
    that -testfb compares, from the same outputs."""

    def __init__(self):
        self.errs: dict[str, float] = {}
        self.totals: list = []
        self._saved = None

    def _fwd(self, *args, **kw):
        import torch
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        fm, fend = self._saved[0](*args, **kw)
        if "pairhmm_fwd" not in self.errs:
            fm2, fend2 = pc.fwd_plain(*args[:7])
            lx, ly = args[2], args[3]
            self.errs["pairhmm_fwd"] = max(
                float((real_cells(fm, lx, ly)
                       - real_cells(fm2, lx, ly)).abs().max()),
                float((fend - fend2).abs().max()))
            self.totals.append(pc._total_prob(fend, args[6]))
            del fm2
            torch.cuda.synchronize()
        return fm, fend

    def _bwd(self, *args, **kw):
        import torch
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        out = self._saved[1](*args, **kw)
        if kw.get("corner") and "pairhmm_bwd_codes" not in self.errs:
            rb, far = out
            rb2, far2 = pc.bwd_codes_plain(*args[:7], corner=True)
            self.errs["pairhmm_bwd_codes"] = max(
                float((far - far2).abs().max()),
                rbm_err(rb, rb2, args[2], args[3]))
            self.totals.append(pc._total_prob(far, args[6]))
            del rb2
            torch.cuda.synchronize()
        return out

    def __enter__(self):
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        self._saved = (pc.pairhmm_fwd, pc.pairhmm_bwd_codes)
        pc.pairhmm_fwd, pc.pairhmm_bwd_codes = self._fwd, self._bwd
        return self

    def __exit__(self, *exc):
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        pc.pairhmm_fwd, pc.pairhmm_bwd_codes = self._saved


def cli_card_cpu(name, argv, out, kernels, cpu_out=None, ea_tol=None):
    """The port's CLI `argv` (writing `out`) on the card, launch counts
    set to 0 just before it and read just after (each of `kernels`
    required), then again with -device cpu writing out + ".cpu", or the
    CPU's text already written to `cpu_out` by cpu_refs_main: the texts
    must be equal. With `ea_tol` (a TSV of EAs, -eadistmx) the CPU's
    pair-HMM (the scan, another association) may differ by up to ea_tol
    in each value, and the text must equal instead the CPU text of the
    kernels' plain versions (the pair stage's "cuda" route on CPU
    tensors), written to out + ".plain". Returns (card wall s, CPU wall
    s or None, launches)."""
    import torch
    from muscle_tpu_torch.cli import main as cli_main
    reset_launches()
    t0 = time.perf_counter()
    rc = cli_main(argv + ["-output", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = count_main_path()
    missing = [k for k in kernels if got[k] <= 0]
    if rc != 0 or missing:
        raise SmokeFailure(f"{name}: rc={rc}, {missing} not launched")
    rc_cpu, cpu_wall = 0, None
    if cpu_out is None:
        cpu_out = out + ".cpu"
        t0 = time.perf_counter()
        rc_cpu = cli_main(argv + ["-output", cpu_out, "-device", "cpu"])
        cpu_wall = time.perf_counter() - t0
    with open(out) as f, open(cpu_out) as g:
        card_text, cpu_text = f.read(), g.read()
    cpu = (f"CPU {cpu_wall:.2f}s" if cpu_wall is not None
           else "CPU text from cpu_refs_main")
    if ea_tol is None:
        same = rc_cpu == 0 and card_text == cpu_text
        print(f"{name}: card {wall:.2f}s, {cpu}, card text = CPU text: "
              f"{same} launches={json.dumps(got)}", flush=True)
    else:
        from muscle_tpu_torch.pipeline import posteriors
        saved = posteriors.default_backend
        posteriors.default_backend = lambda device: "cuda"
        try:
            rc_plain = cli_main(argv + ["-output", out + ".plain",
                                        "-device", "cpu"])
        finally:
            posteriors.default_backend = saved
        with open(out + ".plain") as f:
            same_plain = rc_plain == 0 and f.read() == card_text
        rows = [(a.rsplit("\t", 1), b.rsplit("\t", 1)) for a, b in zip(
            card_text.splitlines(), cpu_text.splitlines())]
        d = max(abs(float(a[1]) - float(b[1])) for a, b in rows)
        same = (same_plain and rc_cpu == 0 and d <= ea_tol
                and len(rows) == len(cpu_text.splitlines())
                and all(a[0] == b[0] for a, b in rows))
        print(f"{name}: card {wall:.2f}s, {cpu}; card text = the plain "
              f"versions' CPU text: {same_plain}; max |d| to the CPU "
              f"scan's text {d:.4f} (tol {ea_tol}) launches="
              f"{json.dumps(got)}", flush=True)
    if not same:
        raise SmokeFailure(f"{name}: the card's output differs from the "
                           "CPU's")
    return wall, cpu_wall, got


def host_command(name, argv):
    """One host-only command of the port's CLI, its wall printed; it must
    return 0 and launch no kernel."""
    from muscle_tpu_torch.cli import main as cli_main
    reset_launches()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in launches().items() if v}
    print(f"host command {name}: rc={rc} wall={wall:.3f}s", flush=True)
    if rc != 0 or launched:
        raise SmokeFailure(f"{name}: rc={rc}, launched {launched}")
    return wall


# the CPU references too long to run in line (-uclust and the greedy
# PProg over rdrp-16 take minutes on the CPU scan, a Python loop over
# rows of small tensors, as fast on one thread as on four): a child
# process of this script computes them on one thread, at a lower
# priority, while the card runs the earlier phases (with four threads it
# slowed them by up to 30 % on the H100's host, PERF.md)
CPU_REF_THREADS = 1


def rdrp16_greedy(device):
    """The greedy PProg.run over the degapped rdrp-16 golden's 16
    single-row MSAs on `device`: (rows, the joined MSA)."""
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.pipeline.pairwise import PairAligner
    from muscle_tpu_torch.pipeline.pprog import PProg
    rows = MultiSequence.from_fasta(os.path.join(ROOT, RDRP16),
                                    strip_gaps=True)
    pack = HMMParams.from_defaults(nucleo=False).to_scores()
    pp = PProg(PairAligner(rows, pack, "amino", device=device),
               {s.label: k for k, s in enumerate(rows)})
    return rows, pp.run([MultiSequence([s]) for s in rows])


def cpu_refs_main(outdir) -> int:
    """`chip_smoke.py --cpu-refs DIR` (started by main as a child): the
    port's CPU texts of -uclust -minea 0.9 and of the greedy PProg over
    the degapped rdrp-16 golden, into DIR (uclust.fa, greedy.afa, then
    walls.json last)."""
    import torch
    sys.path.insert(0, ROOT)
    os.nice(10)
    torch.set_num_threads(CPU_REF_THREADS)
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.cli import main as cli_main
    walls = {}
    fa = os.path.join(outdir, "rdrp16.fa")
    MultiSequence.from_fasta(os.path.join(ROOT, RDRP16),
                             strip_gaps=True).write_fasta(fa)
    t0 = time.perf_counter()
    rc = cli_main(["-uclust", fa, "-minea", "0.9", "-output",
                   os.path.join(outdir, "uclust.fa"), "-device", "cpu"])
    walls["uclust"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, msa = rdrp16_greedy("cpu")
    msa.write_fasta(os.path.join(outdir, "greedy.afa"))
    walls["greedy"] = time.perf_counter() - t0
    with open(os.path.join(outdir, "walls.json"), "w") as f:
        json.dump(walls, f)
    return rc


def start_cpu_refs():
    """Start cpu_refs_main in a child process; (process, its directory)."""
    outdir = os.path.join(ROOT, "build", "chip_smoke", "cpu_refs")
    os.makedirs(outdir, exist_ok=True)
    for name in os.listdir(outdir):
        os.remove(os.path.join(outdir, name))
    log = open(os.path.join(ROOT, "build", "chip_smoke", "cpu_refs.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--cpu-refs", outdir], stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc, outdir


def wait_cpu_refs(refs) -> dict:
    """Wait for the child; its walls (raises if it failed)."""
    proc, outdir = refs
    t0 = time.perf_counter()
    rc = proc.wait(timeout=CPU_REFS_LIMIT_S)
    waited = time.perf_counter() - t0
    walls_path = os.path.join(outdir, "walls.json")
    if rc != 0 or not os.path.exists(walls_path):
        raise SmokeFailure(f"the CPU references' process failed (rc={rc}; "
                           "build/chip_smoke/cpu_refs.log)")
    with open(walls_path) as f:
        walls = json.load(f)
    print(f"CPU references (child process, {CPU_REF_THREADS} threads): "
          f"walls {json.dumps({k: round(v, 1) for k, v in walls.items()})}"
          f" s; waited {waited:.1f}s for them here", flush=True)
    return walls


# the longest wait for the CPU references at phase_surface
CPU_REFS_LIMIT_S = 300
# -eadistmx's EAs: the kernels against the CPU's scan, the kernel gate's
# EA tolerance (ROADMAP.md) and the last printed digit's rounding
EA_TOL = 2e-3 + 1e-4


def phase_surface(dev, sets, refs) -> dict:
    """The rest of the CLI and API surface on the card:
    - -eadistmx on the degapped BB11002 golden, -uclust -minea 0.9 on the
      degapped rdrp-16 golden and -transaln of BB11001's first two rows
      (degapped) onto the MSA of its other two, through the CLI on the
      card: the text required equal to the port's CPU text;
    - -testfb on the degapped BB11004 golden (exit 0 required): its
      kernel-A and 3K (corner output) launches held to their plain
      versions (max |d| = 0 required), the worst relative |fwd - bwd|;
    - kernel 3K at phase 2's shape (512 pairs, 512 x 512, per-pair
      tables) with the corner output off and on: the RB_M of both and
      the corner equal to the plain version, both timed (steady_ms)
      beside BWD_CODES_BEFORE_CORNER_MS;
    - align(sparse_k=16, batch_size=64) on repeat_family(SURFACE_REPEAT)
      (the blocked bf16 Gram consistency, kernel 8, and device refine,
      kernel 7, over a store of 16 slots): the first kernel-8 launch and
      the first HELD_GRID kernel-7 launches held to their plain versions
      (equal required); align(random_chain_tree=True) on the degapped
      BB11001 golden: card text = CPU text;
    - the greedy PProg.run over the degapped rdrp-16 golden's 16
      single-row MSAs: card text = CPU text (-uclust's and this one's
      CPU texts from the child process `refs`, start_cpu_refs);
    - each host-only command once, its wall printed: -muscle3 (Q against
      the golden), -m3select, -bench over BENCH_GOLDENS, -masm_train,
      -masm_stats and -swmasm on mega-8, -kmerdist, -upgma5, -consseq,
      -msastats, the -msatool family, -cmp_ref_msas, -derep, -hmmdump
      and -perturbhmm 3.
    Returns the holds and times for the kernels line."""
    import tempfile

    import torch
    from muscle_tpu_torch import MultiSequence, align
    from muscle_tpu_torch.cli import main as cli_main
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    t_phase = time.perf_counter()
    out = {"errs": {}}
    gold = os.path.join(ROOT, "tests", "goldens")
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as wd:
        def degapped(path, name):
            seqs = MultiSequence.from_fasta(os.path.join(ROOT, path),
                                            strip_gaps=True)
            p = os.path.join(wd, name)
            seqs.write_fasta(p)
            return seqs, p

        # the pair-HMM commands, card against CPU
        _, bb2 = degapped(FAMILIES[1][1], "bb11002.fa")
        cli_card_cpu("-eadistmx BB11002", ["-eadistmx", bb2],
                     os.path.join(wd, "ea.tsv"), PAIR_KERNELS,
                     ea_tol=EA_TOL)
        out["cpu_ref_walls"] = wait_cpu_refs(refs)
        rdrp, rdrp_fa = degapped(RDRP16, "rdrp16.fa")
        cli_card_cpu("-uclust -minea 0.9 rdrp-16",
                     ["-uclust", rdrp_fa, "-minea", "0.9"],
                     os.path.join(wd, "centroids.fa"), PAIR_KERNELS,
                     cpu_out=os.path.join(refs[1], "uclust.fa"))
        bb1, bb1_fa = degapped(FAMILIES[0][1], "bb11001.fa")
        gold1 = MultiSequence.from_fasta(os.path.join(ROOT, FAMILIES[0][1]))
        fresh = os.path.join(wd, "fresh.fa")
        MultiSequence([bb1[0], bb1[1]]).write_fasta(fresh)
        ref2 = os.path.join(wd, "ref2.afa")
        MultiSequence([gold1[2], gold1[3]]).write_fasta(ref2)
        cli_card_cpu("-transaln BB11001 rows 0-1 onto rows 2-3",
                     ["-transaln", fresh, "-ref", ref2],
                     os.path.join(wd, "transaln.afa"), PAIR_KERNELS)

        # -testfb on BB11004: kernels A and 3K (corner) held
        _, bb4 = degapped(FAMILIES[2][1], "bb11004.fa")
        reset_launches()
        with TestfbCheck() as tfb:
            t0 = time.perf_counter()
            rc = cli_main(["-testfb", bb4])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = count_main_path()
        fwd, bwd = (t.cpu().numpy() for t in tfb.totals)
        worst = float(np.max(np.abs(fwd - bwd)
                             / np.maximum(1.0, np.abs(fwd))))
        print(f"-testfb BB11004: rc={rc} wall={wall:.2f}s (checks in); "
              f"kernel A vs plain max |d| {tfb.errs.get('pairhmm_fwd')}, "
              f"kernel 3K with its corner output vs plain max |d| "
              f"{tfb.errs.get('pairhmm_bwd_codes')}; worst relative "
              f"|fwd - bwd| {worst:.3e} (limit 1e-3) "
              f"launches={json.dumps(got)}", flush=True)
        if (rc != 0 or len(tfb.errs) != 2 or any(tfb.errs.values())
                or got["pairhmm_fwd"] <= 0 or got["pairhmm_bwd_codes"] <= 0):
            raise SmokeFailure("-testfb: exit code, holds or launches")
        out["errs"].update(tfb.errs)
        out["testfb_worst"] = worst

    # kernel 3K at phase 2's shape, corner output off and on
    b, width = BWD_CODES_CORNER_SHAPE
    xb, yb, lx, ly = ragged_batch(b, width // 3, width, width,
                                  seed=20261017)
    x, y, lxt, lyt = (torch.from_numpy(a).to(dev) for a in (xb, yb, lx, ly))
    _, (m, i, s, t) = ensemble_tables(dev, [k % len(ENSEMBLE_SEEDS)
                                            for k in range(b)])
    args = (x, y, lxt, lyt, m.contiguous(), i.contiguous(),
            pc.params_rows(s, t))
    rb = pc.pairhmm_bwd_codes(*args)
    rb2, far = pc.pairhmm_bwd_codes(*args, corner=True)
    want_rb, want_far = pc.bwd_codes_plain(*args, corner=True)
    torch.cuda.synchronize()
    d3 = max(rbm_err(rb, want_rb, lxt, lyt), rbm_err(rb2, want_rb, lxt, lyt),
             float((far - want_far).abs().max()))
    del rb, rb2, want_rb
    ms_off = steady_ms(lambda: pc.pairhmm_bwd_codes(*args))
    ms_on = steady_ms(lambda: pc.pairhmm_bwd_codes(*args, corner=True))
    print(f"kernel 3K pairhmm_bwd_codes at {b} x {width} x {width} "
          f"(per-pair tables, {pc.bwd_codes_geometry(b, width).schedule}): "
          f"corner output off {ms_off:.3f} ms, on {ms_on:.3f} ms (before "
          f"the corner output: {BWD_CODES_BEFORE_CORNER_MS} ms, PERF.md row 3K); "
          f"RB_M off and on and the corner vs plain max |d| {d3:.3e} "
          f"{'equal' if d3 == 0 else 'FAIL'}", flush=True)
    if d3:
        raise SmokeFailure("kernel 3K's corner output or RB_M differs from "
                           "its plain version")
    out["errs"]["pairhmm_bwd_codes"] = max(out["errs"]["pairhmm_bwd_codes"],
                                          d3)
    out["bwd_codes_512"] = {"corner_off_ms": ms_off, "corner_on_ms": ms_on}
    del args, x, y, m, i

    # MPC's options on the card
    n, lo, hi, period, seed = SURFACE_REPEAT
    seqs = repeat_family(n, lo, hi, period, seed)
    name = f"repeat family n={n} L={lo}-{hi} sparse_k=16 batch_size=64"
    n_grid = len(GRID_CHECK.cases)
    with PanelCheck() as panel:
        msa, wall, stages, got = run_path(
            name, seqs, dev, PAIR_KERNELS + ("densify",) + REFINE_KERNELS,
            sparse_k=16, batch_size=64)
    p8 = panel.cases[0]
    held7 = GRID_CHECK.cases[n_grid:]
    k7 = sorted({int(c["shape"].split("k2=")[1].split(",")[0])
                 for c in held7})
    print(f"{name}: wall={wall:.2f}s width={msa.col_count()} "
          f"stages={json.dumps(stages)} launches={json.dumps(got)}; "
          f"densify (kernel 8) first launch ({p8['shape']}, store K = "
          f"{p8['k']}) vs plain max |d| {p8['err']:.3e} "
          f"{'equal' if p8['same'] else 'FAIL'}; kernel 7 held launches' "
          f"k2 {k7}", flush=True)
    if not p8["same"] or p8["k"] != 16:
        raise SmokeFailure(f"{name}: kernel 8's first launch (K = {p8['k']}) "
                           "differs from its plain version or the store "
                           "does not hold 16 slots")
    out["errs"]["densify"] = p8["err"]
    out["repeat"] = {"wall_s": wall, "k8": p8["k"], "k7": k7}

    name = "BB11001 random_chain_tree"
    msa, wall, _, got = run_path(name, bb1, dev, PAIR_KERNELS,
                                 random_chain_tree=True)
    cpu = align(bb1, device="cpu", random_chain_tree=True)
    same = cpu.to_fasta_text() == msa.to_fasta_text()
    print(f"{name}: card {wall:.2f}s, card text = CPU text: {same}",
          flush=True)
    if not same:
        raise SmokeFailure(f"{name}: the card's text differs from the CPU's")

    # the greedy PProg over rdrp-16's single rows
    name = "greedy PProg.run rdrp-16"
    m_cases = len(MEA_CHECK.cases)
    reset_launches()
    t0 = time.perf_counter()
    _, joined = rdrp16_greedy(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = count_main_path()
    if any(got[k] <= 0 for k in PAIR_KERNELS):
        raise SmokeFailure(f"{name}: {PAIR_KERNELS} not launched")
    MEA_CHECK.held_since(name, m_cases, got["mea_dirs"])
    check_alignment(rdrp, joined, name)
    with open(os.path.join(refs[1], "greedy.afa")) as f:
        same = f.read() == joined.to_fasta_text()
    print(f"{name}: card {wall:.2f}s (checks in), card text = CPU text "
          f"(cpu_refs_main): {same} launches={json.dumps(got)}", flush=True)
    if not same:
        raise SmokeFailure(f"{name}: the card's text differs from the CPU's")

    # the host-only commands, once each
    with tempfile.TemporaryDirectory(dir=scratch) as wd:
        walls = {}
        bb1_fa = os.path.join(wd, "bb11001.fa")
        bb1.write_fasta(bb1_fa)
        rdrp_fa = os.path.join(wd, "rdrp16.fa")
        rdrp.write_fasta(rdrp_fa)
        m3 = os.path.join(wd, "m3.afa")
        walls["muscle3"] = host_command("-muscle3 BB11001",
                                        ["-muscle3", bb1_fa, "-output", m3])
        print(f"-muscle3 BB11001: Q against the golden "
              f"{q_score(MultiSequence.from_fasta(m3), gold1):.4f}",
              flush=True)
        walls["m3select"] = host_command(
            "-m3select -replicates 4 BB11001",
            ["-m3select", bb1_fa, "-replicates", "4", "-output",
             os.path.join(wd, "sel.afa")])
        names = os.path.join(wd, "names.txt")
        with open(names, "w") as f:
            f.write("".join(g + "\n" for g in BENCH_GOLDENS))
        walls["bench"] = host_command(
            "-bench the seven BB goldens",
            ["-bench", names, "-refdir", gold])
        ms8, _ = sets["mega-8"]
        n8, _, _, seed8 = MEGA_8
        mega8 = os.path.join(ROOT, "build", "chip_smoke",
                             f"mega-{n8}-{seed8}.mega")
        chains_fa = os.path.join(wd, "mega8.fa")
        mega_seqs(ms8).write_fasta(chains_fa)
        chains_afa = os.path.join(wd, "mega8.afa")
        host_command("-muscle3 mega-8 chains",
                     ["-muscle3", chains_fa, "-output", chains_afa])
        masm = os.path.join(wd, "mega8.masm")
        walls["masm_train"] = host_command(
            "-masm_train mega-8", ["-masm_train", chains_afa, "-input",
                                   mega8, "-output", masm])
        walls["masm_stats"] = host_command("-masm_stats mega-8",
                                           ["-masm_stats", masm])
        walls["swmasm"] = host_command(
            "-swmasm mega-8", ["-swmasm", masm, "-query", mega8, "-output",
                               os.path.join(wd, "sw.tsv")])
        dist = os.path.join(wd, "kmer.tsv")
        walls["kmerdist"] = host_command(
            "-kmerdist rdrp-16", ["-kmerdist", rdrp_fa, "-output", dist])
        walls["upgma5"] = host_command(
            "-upgma5 rdrp-16", ["-upgma5", dist, "-output",
                                os.path.join(wd, "t.nwk")])
        aln2 = os.path.join(ROOT, FAMILIES[1][1])
        walls["consseq"] = host_command(
            "-consseq BB11002", ["-consseq", aln2, "-output",
                                 os.path.join(wd, "cons.fa")])
        walls["msastats"] = host_command("-msastats BB11002",
                                         ["-msastats", aln2])
        labels2 = os.path.join(wd, "labels2.tsv")
        with open(labels2, "w") as f:
            f.write(f"{gold1[0].label}\tfirst\n")
        for tool, extra in (("strip_gappy_cols", []),
                            ("strip_gappy_rows", []),
                            ("relabel", ["-labels2", labels2]),
                            ("trimtoref", ["-ref", os.path.join(
                                ROOT, FAMILIES[0][1])]),
                            ("make_a2m", []), ("squeeze_inserts", []),
                            ("core_blocks", ["-min_core_block_seqs", "2"])):
            src = m3 if tool in ("relabel", "trimtoref") else aln2
            walls[tool] = host_command(
                f"-{tool}", [f"-{tool}", src, *extra, "-output",
                             os.path.join(wd, f"{tool}.out")])
        walls["cmp_ref_msas"] = host_command(
            "-cmp_ref_msas BB11001", ["-cmp_ref_msas", m3, "-ref",
                                      os.path.join(ROOT, FAMILIES[0][1])])
        dups = os.path.join(wd, "dups.fa")
        MultiSequence(list(bb1) + [bb1[0], bb1[1]]).write_fasta(dups)
        walls["derep"] = host_command(
            "-derep BB11001 with 2 duplicates",
            ["-derep", dups, "-output", os.path.join(wd, "u.fa")])
        walls["hmmdump"] = host_command(
            "-hmmdump", ["-hmmdump", os.path.join(wd, "hmm")])
        walls["perturbhmm"] = host_command("-perturbhmm 3",
                                           ["-perturbhmm", "3"])
    out["host_walls"] = walls
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase surface: {out['wall_s']:.1f}s", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from muscle_tpu_torch import native
    from muscle_tpu_torch.utils.build import build_all

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = build_all()
    print(f"build: {len(built)} libraries in {time.perf_counter() - t0:.1f}s; "
          f"native host library loaded: {native.loaded()}", flush=True)
    refs = start_cpu_refs()
    try:
        return run_phases(card, refs)
    finally:
        if refs[0].poll() is None:
            refs[0].kill()
        refs[0].wait()


def run_phases(card, refs) -> int:
    """Phases 2-5 (refs: the CPU references' child, start_cpu_refs)."""
    import torch
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    sets = {name: mega_set(*spec) for name, spec in (
        ("mega-8", MEGA_8), ("mega-128", MEGA_128), ("mega-long", MEGA_LONG))}
    print(f"mega sets built, written and parsed: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    kernels = (phase_kernels(dev) + phase_long_kernels(dev)
               + phase_gram_join_kernels(dev) + [phase_list_kernel(dev)]
               + phase_mega_kernels(dev, sets) + phase_ensemble_kernels(dev)
               + phase_dp_kernels(dev))

    t0 = time.perf_counter()
    with GRID_CHECK, MEA_CHECK:
        phase_families(dev)
        phase_synthetic(dev)
        phase_long_families(dev)
        s5 = phase_super5(dev)
        legacy_errs = phase_mega(dev, sets)["legacy_errs"]
        ens = phase_ensembles(dev)
        phase_super67(dev, sets)
        surf = phase_surface(dev, sets, refs)
    print(f"main path: {time.perf_counter() - t0:.1f}s (kernel-7 checks "
          f"{GRID_CHECK.seconds:.2f}s, {len(GRID_CHECK.cases)} launches "
          f"held; mea_dirs checks {MEA_CHECK.seconds:.2f}s, "
          f"{len(MEA_CHECK.cases)} launches held)", flush=True)
    print_mea_rungs()
    phase_scan_route(dev)
    # kernel 7L's entry: its times and bound at the main path's largest
    # device join, the error over every check
    cases = s5["synthetic-1000"]["list_cases"]
    big = max(cases, key=lambda c: c["bound"][0])
    k7l = next(k for k in kernels if k["name"] == "densify_reduce_list")
    k7l.update(max_abs_err=max([k7l["max_abs_err"]]
                               + [c["err"] for c in cases]),
               ms=big["ms"], plain_ms=big["plain_ms"],
               bound_ms=big["bound"][0], bound_by=big["bound"][1],
               library_ms=big["lib_ms"])
    print(f"kernel 7L entry: the largest device join ({big['shape']})",
          flush=True)
    for what, held_cases in (("kernel 7L over synthetic-1000's device joins",
                              cases),
                             ("kernel 7 over the held main-path launches",
                              GRID_CHECK.cases)):
        print(f"{what} ({len(held_cases)}): kernel "
              f"{sum(c['ms'] for c in held_cases):.4f} ms, index_add "
              f"{sum(c['lib_ms'] for c in held_cases):.4f} ms, bound "
              f"{sum(c['bound'][0] for c in held_cases):.4f} ms summed",
              flush=True)
    held = dict(legacy_errs)
    for k in MULTI_KERNELS:
        held[k] = [e for run in ("ensemble-48", "diversified-BB11002")
                   for errs in (ens[run]["errs"], ens[run]["plain_errs"])
                   for e in errs[k]]
    held["pairhmm_bwd_codes"] = (ens["legacy-BB11001"]["errs"]
                                 + [surf["errs"]["pairhmm_bwd_codes"]])
    for name in ("pairhmm_fwd", "densify"):
        held[name] = held.get(name, []) + [surf["errs"][name]]
    held["mea_scores"] = (held.get("mea_scores", [])
                          + ens["legacy-BB11001"]["mea_errs"])
    held["densify_reduce"] = [c["err"] for c in GRID_CHECK.cases]
    held["mea_dirs"] = [c["err"] for c in MEA_CHECK.cases]
    for name in HELD_DP:
        held[name] = [c["err"] for c in DP_CHECK.cases if c["name"] == name]
    for k in kernels:
        k["max_abs_err"] = max([k["max_abs_err"]] + held.get(k["name"], []))
    for k in kernels:
        k["launches"] = MAIN_PATH.get(k["name"], 0)
        if k["launches"] <= 0:
            raise SmokeFailure(f"{k['name']} never launched on the main path")
    # kernels A/B: their launches on the main path by schedule and width,
    # and their times, bound and hold at the long families' in-cap rung
    for i, k in enumerate(kernels[:2]):
        k["schedule"] = {f"{sched} {ly}": n for (name, sched, ly), n
                         in sorted(MAIN_SCHEDULES.items())
                         if name == k["name"]}
        k.update(ms_10240=AB_WIDE["ms"][i],
                 block_ms_10240=AB_WIDE["block_ms"][i],
                 bound_ms_10240=AB_WIDE["bound"][i],
                 max_abs_err=max(k["max_abs_err"], AB_WIDE["max_abs_err"]))
    # kernel 3: its launches by schedule and width; mea_dirs: its
    # launches by (cc1, cc2) rung and the held launches' summed times
    for name in ("pairhmm_bwd", "pairhmm_fwd_emis", "pairhmm_bwd_codes"):
        k = next(k for k in kernels if k["name"] == name)
        k["schedule"] = {f"{sched} {ly}": n for (kn, sched, ly), n
                         in sorted(MAIN_SCHEDULES.items()) if kn == name}
    # kernel 3K: its times at 512 with the corner output (-testfb) off and
    # on, measured in phase_surface
    next(k for k in kernels if k["name"] == "pairhmm_bwd_codes").update(
        corner_off_ms_512=surf["bwd_codes_512"]["corner_off_ms"],
        corner_on_ms_512=surf["bwd_codes_512"]["corner_on_ms"])
    # kernel 1E: its time and bound on mega-long's chunk (the wave); its
    # dependency floor, a model and not a measurement, stays in the
    # printed line
    next(k for k in kernels if k["name"] == "pairhmm_fwd_emis").update(
        ms_12288=WIDE_1E["ms"], bound_ms_12288=WIDE_1E["bound"])
    # kernel 4: its time and bound at the legacy letter route's 512 x 512^2
    # beside mega-long's chunk
    k4 = next(k for k in kernels if k["name"] == "mea_scores")
    k4.update(ms_512=MEA_512["ms"], bound_ms_512=MEA_512["bound"],
              max_abs_err=max(k4["max_abs_err"], MEA_512["err"]))
    km = next(k for k in kernels if k["name"] == "mea_dirs")
    rungs = mea_rungs()
    km["schedule"] = {f"wave {r1} x {r2}": n for (r1, r2), (n, _, _)
                      in rungs.items()}
    km.update(held_launches=len(MEA_CHECK.cases),
              held_ms_summed=sum(c["ms"] for c in MEA_CHECK.cases))
    # nw_viterbi / sw_scores: their times, plain times and bounds at
    # phase 2's second pad (several columns a thread), the held launches
    for name, wide in DP_WIDE.items():
        next(k for k in kernels if k["name"] == name).update(
            {f"{key}_{DP_WIDTHS[1]}": v for key, v in wide.items()},
            held_launches=len(held[name]))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-refs":
        sys.exit(cpu_refs_main(sys.argv[2]))
    sys.exit(main())
