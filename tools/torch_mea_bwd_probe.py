#!/usr/bin/env python3
"""Probe of the MEA wavefronts (mea_dirs; kernel 4, mea_scores) and the
legacy backwards (kernel 3; kernel 3K, pairhmm_bwd_codes) on the card.

    python tools/torch_mea_bwd_probe.py [--check] [--time] [--parent DIR]
        [--warps 4,8,16] [--variants] [--crossover [B,..:W,..]]

--check: mea_dirs against mea_dirs_plain (max |d| = 0 required) on
         random and tie-heavy posteriors at the odd shapes, the rows
         past 512 that wrap the bands (the link row) and wide rows;
         kernel 3 (the wave) against bwd_plain at 128, 2048, 2176 and
         12288 (2 pairs, 96 rows), rows u >= lx zero; kernel 4 against
         mea_scores_plain on ragged posteriors (random and tie-heavy,
         zero outside each pair's (lx, ly)) at KERNEL4_SHAPES, at its
         default warps and at 1, 2 and 5 warps a block (more rounds of
         bands, so more links between blocks); kernel 3K against
         bwd_codes_plain at 512 and 1024 (one block a pair, and the wave
         forced), 2176 and 4096 (the wave), with shared and per-pair
         tables (on the real cells and the zero rows u >= lx:
         chip_smoke.rbm_err).
--time:  CUDA events. mea_dirs at 768 x 768 and the main path's shapes
         (MEA_TIMED; random, tie-heavy; 20 launches between the events);
         kernel 4 on mega-long's chunk (8 x 12288^2, the legacy route's
         own posterior) and on ragged posteriors (KERNEL4_TIMED: the
         legacy letter route's 512 x 512^2 first), kernel 3K at
         BWD_CODES_TIMED (512 pairs with per-pair tables, as
         chip_smoke.py, up to 2048 on both schedules; 4 pairs at 4096 on
         the wave, chip_smoke.bwd_codes_wide's), each steady (chip_smoke.steady_ms: 20 launches first,
         5 between the events); kernel 3 on mega-long's chunk.
--parent DIR: with --time, the kernels of the package unpacked in DIR
         (its csrc built here, its C interfaces: mea_dirs, mea_scores and
         pairhmm_bwd_codes as at commit c4a02f0) timed in the same call,
         in turns: parent, this, this, parent.
--warps: with --time, kernel 4 also at these warps a block.
--crossover [B,..:W,..]: kernel 3K on both schedules (steady) at
         every B of CROSSOVER_B and width of CROSSOVER_WIDTHS, or of the
         lists given (one table set, lengths as letter_batch): where
         the wave starts to win, and how B moves it
         (pairhmm_cuda.bwd_codes_geometry).
--variants: mea_dirs at 768 x 768 as it is, without the hand-over
         between bands (a diagnostic: wrong results), and with clock64
         marks at each warp's band starts and ends (the first 8 bands a
         warp) and counts of the waits' naps.
Prints the card (nvidia-smi name and power limit) first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def random_post(shape, seed, dev):
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.random(shape, dtype=np.float32), device=dev)


MEA_SHAPES = ((1, 33), (23, 16), (40, 57), (130, 150), (767, 769),
              (1100, 300), (768, 768), (600, 6000), (1500, 5000),
              (20, 20000), (3, 40000))
# --time: 768 x 768 (phase 2's) and the main path's shapes (chip_smoke's
# held launches: n = 70, n = 200, mega-128, synthetic-1000's refine and
# PProg joins)
MEA_TIMED = ((768, 768), (128, 128), (512, 512), (578, 549), (765, 490),
             (912, 898), (1398, 1051), (491, 2600))
# kernel 4: (B, Lx, Ly) of the checked ragged posteriors; past 16384
# lanes the block-per-pair kernel could not run
KERNEL4_SHAPES = ((8, 2000, 2048), (64, 512, 512), (2, 96, 16896),
                  (3, 1100, 384), (5, 70, 128))
KERNEL4_WARPS = (None, 1, 2, 5)
# kernel 3K: widths held on the block schedule and on the wave
BWD_CODES_WIDTHS = (512, 1024, 2176, 4096)
# --time: kernel 4 on ragged posteriors (B, L) beside mega-long's chunk
# (the legacy letter route's 512 x 512^2 first: chip_smoke.py's lengths);
# kernel 3K (B, L, per-pair tables, the lengths' seed: chip_smoke.py's
# inputs at 512 and 4096)
KERNEL4_TIMED = ((512, 512), (264, 512), (132, 512), (64, 512), (16, 512),
                 (64, 2048), (8, 2048))
BWD_CODES_TIMED = ((512, 384, True, 20261017), (512, 512, True, 20261017),
                   (512, 1024, True, 20261017), (512, 2048, True, 20261017),
                   (4, 4096, True, 4096))

# --crossover: kernel 3K's schedules at these B (the letter route's
# chunks are 8-256 pairs, fewer in a last chunk) and widths (the main
# path's legacy launch is at 128)
CROSSOVER_B = (1, 4, 16, 64, 128, 256, 512)
CROSSOVER_WIDTHS = (128, 512, 768, 1024, 2048)


def ragged_post(b, n_rows, width, seed, kind, dev):
    """(post, lxb, lyb): a (b, n_rows, width) posterior zero outside each
    pair's (lx, ly), lx in [n_rows / 3, n_rows], ly in [width / 3,
    width] (the first pair full); values uniform in [0, 1) or, tie-heavy,
    from {0, 0.25, 0.5} (mostly 0)."""
    import torch
    rng = np.random.default_rng(seed)
    lx = rng.integers(max(1, n_rows // 3), n_rows + 1, size=b)
    ly = rng.integers(max(1, width // 3), width + 1, size=b)
    lx[0], ly[0] = n_rows, width
    if kind == "random":
        p = rng.random((b, n_rows, width), dtype=np.float32)
    else:
        p = rng.choice(np.float32([0, 0, 0, 0, 0, 0, 0.25, 0.5]),
                       size=(b, n_rows, width))
    r = np.arange(n_rows)[None, :, None]
    c = np.arange(width)[None, None, :]
    p = np.where((r < lx[:, None, None]) & (c < ly[:, None, None]), p, 0.0)
    return (torch.as_tensor(p.astype(np.float32), device=dev),
            torch.as_tensor(lx.astype(np.int32), device=dev),
            torch.as_tensor(ly.astype(np.int32), device=dev))


def letter_batch(b, n_rows, width, seed, dev, per_pair):
    """(xb, yb, lxb, lyb, match, insert, params) of b random amino pairs
    (lengths as chip_smoke.ragged_batch) with the default tables, or, per
    pair, chip_smoke.ensemble_tables' packs mixed lane by lane."""
    import torch

    import chip_smoke as cs
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    xb, yb, lx, ly = cs.ragged_batch(b, width // 3, width, width, seed)
    xb, lx = xb[:, :n_rows], np.minimum(lx, n_rows)
    x, y, lxt, lyt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in (xb, yb, lx, ly))
    if per_pair:
        _, (m, i, s, t) = cs.ensemble_tables(
            dev, [k % len(cs.ENSEMBLE_SEEDS) for k in range(b)])
        return x, y, lxt, lyt, m.contiguous(), i.contiguous(), \
            pc.params_rows(s, t)
    return (x, y, lxt, lyt) + pc.tables(
        HMMParams.from_defaults(nucleo=False).to_scores(), dev)


def check(dev) -> bool:
    import torch

    from chip_smoke import rbm_err, tie_heavy
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    ok = True
    for shape in MEA_SHAPES:
        for kind, make in (("random", random_post), ("tie-heavy", tie_heavy)):
            post = make(shape, shape[0] * 7 + shape[1], dev)
            packed, scores = djc.mea_dirs(post)
            want_p, want_s = djc.mea_dirs_plain(post)
            torch.cuda.synchronize()
            wavefront.check_waits(dev)
            same = torch.equal(packed, want_p) and torch.equal(scores, want_s)
            ok &= same
            print(f"mea_dirs {kind} {shape[0]} x {shape[1]} "
                  f"({djc.mea_warps(shape[0])} warps): "
                  f"{'equal' if same else 'FAIL'}", flush=True)
    for b, n_rows, width in KERNEL4_SHAPES:
        for kind in ("random", "tie-heavy"):
            post, lx, ly = ragged_post(b, n_rows, width, b * n_rows + width,
                                       kind, dev)
            want = pe.mea_scores_plain(post)
            for w in KERNEL4_WARPS:
                got = pe.mea_scores(post, lx, ly, warps=w)
                wavefront.check_waits(dev)
                same = torch.equal(got, want)
                ok &= same
                print(f"kernel 4 {kind} {b} x {n_rows} x {width} ("
                      f"{w or pe.mea_scores_warps(b, n_rows)} warps, "
                      f"{pe.mea_scores_rounds(n_rows, w or pe.mea_scores_warps(b, n_rows))}"
                      f" rounds): {'equal' if same else 'FAIL'}", flush=True)
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), dev)
    for width in (128, 2048, 2176, 12288):
        rng = np.random.default_rng(width)
        b, rows = 2, 96
        lx = torch.tensor([96, 61], dtype=torch.int32, device=dev)
        ly = torch.tensor([width - 7, width // 2 + 33], dtype=torch.int32,
                          device=dev)
        e = torch.as_tensor(rng.random((b, rows, width), dtype=np.float32)
                            * 4 - 3, device=dev)
        ins_x = torch.as_tensor(-1 - rng.random((b, rows), dtype=np.float32),
                                device=dev)
        ins_y = torch.as_tensor(-1 - rng.random((b, width), dtype=np.float32),
                                device=dev)
        args = (e, ins_x, ins_y, lx, ly, params)
        want = pe.bwd_plain(*args)
        got = pe.pairhmm_bwd(*args)
        torch.cuda.synchronize()
        wavefront.check_waits(dev)
        d = float((got - want).abs().max())
        ok &= d == 0
        print(f"kernel 3 at {width} (the wave, G = "
              f"{pe.bwd_geometry(b, width).g}; 2 pairs, 96 rows) vs plain: "
              f"max |d| {d:.3e} {'equal' if d == 0 else 'FAIL'}", flush=True)
    for width in BWD_CODES_WIDTHS:
        for per_pair in (False, True):
            args = letter_batch(4, 96, width, width + per_pair, dev, per_pair)
            want = pc.bwd_codes_plain(*args)
            scheds = ("block", "wave") if width <= pc.WAVE_MIN_LY else (None,)
            for sched in scheds:
                got = pc.pairhmm_bwd_codes(*args, schedule=sched)
                torch.cuda.synchronize()
                wavefront.check_waits(dev)
                d = rbm_err(got, want, args[2], args[3])
                ok &= d == 0
                geo = pc.bwd_codes_geometry(4, width, sched)
                print(f"kernel 3K at {width} ({geo.schedule}"
                      f"{f', G = {geo.g}' if geo.g else ''}; 4 pairs, 96 "
                      f"rows, {'per-pair' if per_pair else 'shared'} "
                      f"tables) vs plain: max |d| {d:.3e} "
                      f"{'equal' if d == 0 else 'FAIL'}", flush=True)
    return ok


def parent_libs(parent_dir):
    """The parent package's mea_dirs, kernel 4 and kernel 3K libraries,
    built here from its csrc, with their C interfaces at commit c4a02f0:
    mea_dirs(post, cc1, cc2, vec, wait_cycles, fault, link, packed,
    scores, stream); mea_scores(post, lxb, B, Lx, Ly, out, stream) (one
    block a pair); pairhmm_bwd_codes(xb, yb, lxb, lyb, match, insert,
    params, per_pair, B, Lx, Ly, kk, rbm, stream) (one block a pair)."""
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, build_dir, nvcc
    out = os.path.join(build_dir(), "parent")
    os.makedirs(out, exist_ok=True)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    types = {"mea_dirs": [vp] + [ci] * 3 + [ll] + [vp] * 5,
             "mea_scores": [vp] * 2 + [ci] * 3 + [vp] * 2,
             "pairhmm_bwd_codes": [vp] * 7 + [ci] * 5 + [vp] * 2}
    procs = {}
    for name in types:
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc(), *CUDA_FLAGS, "-o", so, os.path.join(
                parent_dir, "muscle_tpu_torch", "csrc", f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"the parent's {name}: {log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"the parent's {name}: {regs}", flush=True)
        fn = getattr(ctypes.CDLL(so), name)
        fn.restype, fn.argtypes = ctypes.c_int, types[name]

        def call(*a, fn=fn, name=name):
            if fn(*a):
                raise RuntimeError(f"the parent's {name} launch failed")
        libs[name] = call
    return libs


def in_turns(what, turns, timer) -> dict:
    """Times of each turn, in the order parent, this, this, parent (or
    `this` and the variants once each), printed."""
    order = (["parent", "this", "this", "parent"] if "parent" in turns
             else ["this"])
    order += [k for k in turns if k not in ("parent", "this")]
    times = {k: [] for k in turns}
    for k in order:
        times[k].append(timer(turns[k]))
    print(f"{what}, ms a launch: "
          + "; ".join(f"{k} {v}" for k, v in times.items()), flush=True)
    return times


def time_all(dev, parent_dir, warps) -> None:
    import torch

    import chip_smoke as cs
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    parent = parent_libs(parent_dir) if parent_dir else None

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    fault = wavefront.fault_flag(dev)
    for cc1, cc2 in MEA_TIMED:
        for kind, make in (("random", random_post),
                           ("tie-heavy", cs.tie_heavy)):
            post = make((cc1, cc2), cc1 + cc2, dev)
            turns = {"this": lambda: djc.mea_dirs(post)}
            if parent:
                w = -(-cc2 // 16)
                packed = torch.empty((cc1, w), dtype=torch.int32, device=dev)
                scores = torch.empty(cc1, dtype=torch.float32, device=dev)
                link = torch.empty(-(-cc2 // 16) * 16 + 4,
                                   dtype=torch.float32, device=dev)
                turns["parent"] = lambda: parent["mea_dirs"](
                    ptr(post), cc1, cc2, int(cc2 % 4 == 0),
                    djc.MEA_WAIT_CYCLES, ptr(fault), ptr(link), ptr(packed),
                    ptr(scores), stream)
            in_turns(f"mea_dirs at {cc1} x {cc2} ({kind})", turns,
                     lambda fn: cs.time_cuda(fn, per=20))
            del post
    wavefront.check_waits(dev)

    # kernel 4 on mega-long's chunk: the legacy route's own posterior
    ms_set = cs.mega_set(*cs.MEGA_LONG)[0]
    nl = len(ms_set.labels)
    pairs = [(x, y) for x in range(nl) for y in range(x + 1, nl)]
    pairs += [pairs[0]] * (8 - len(pairs))
    params = pc.params_vec(HMMParams.from_defaults(nucleo=False).to_scores(),
                           dev)
    largs = cs.mega_batch(ms_set, pairs, cs.MEGA_LONG_PAD, dev) + (params,)
    fm, fend = pe.pairhmm_fwd_emis(*largs)
    rb = pe.pairhmm_bwd(*largs)
    wavefront.check_waits(dev)
    turns = {"this": lambda: pe.pairhmm_bwd(*largs)}
    in_turns(f"kernel 3 on mega-long's chunk", turns,
             lambda fn: cs.time_cuda(fn, reps=3))
    lx, ly = largs[3], largs[4]
    post = pe.finish_posteriors(fm, rb, fend, lx, ly, params)
    del largs, rb
    torch.cuda.empty_cache()
    shapes = [("mega-long's chunk", post, lx, ly)]
    for b, width in KERNEL4_TIMED:
        shapes.append((f"{b} ragged pairs at {width}",)
                      + ragged_post(b, width, width, 20261017, "random", dev))
    for what, p, lxt, lyt in shapes:
        b, n_rows, width = p.shape
        want = pe.mea_scores_plain(p)
        default = pe.mea_scores_warps(b, n_rows)
        turns = {"this": lambda p=p, lxt=lxt, lyt=lyt: pe.mea_scores(
            p, lxt, lyt)}
        for w in warps:
            if w != default:
                turns[f"{w} warps"] = (
                    lambda p=p, lxt=lxt, lyt=lyt, w=w: pe.mea_scores(
                        p, lxt, lyt, warps=w))
        same = all(torch.equal(fn(), want) for fn in turns.values())
        wavefront.check_waits(dev)
        if parent:
            out = torch.empty(b, dtype=torch.float32, device=dev)
            turns["parent"] = lambda p=p, lxt=lxt, out=out: parent[
                "mea_scores"](ptr(p), ptr(lxt), b, n_rows, width, ptr(out),
                              stream)
            turns["parent"]()
            torch.cuda.synchronize()
            same &= torch.equal(out, want)
        in_turns(f"kernel 4 on {what} ({b} x {n_rows} x {width}, lx "
                 f"{int(lxt.min())}-{int(lxt.max())}; {default} warps a "
                 f"block by default, {pe.mea_scores_rounds(n_rows, default)}"
                 f" rounds; every output vs plain "
                 f"{'equal' if same else 'FAIL'})", turns, cs.steady_ms)
        wavefront.check_waits(dev)
    del shapes, post, fm
    torch.cuda.empty_cache()

    # kernel 3K: B = 512 with per-pair tables (chip_smoke.py's at 512) up
    # to 2048 on both schedules, and 4 x 4096 on the wave
    for b, width, per_pair, seed in BWD_CODES_TIMED:
        args = letter_batch(b, width, width, seed, dev, per_pair)
        turns = {"this": lambda args=args: pc.pairhmm_bwd_codes(*args)}
        if width <= pc.WAVE_MIN_LY:
            other = ("block" if pc.bwd_codes_geometry(b, width).schedule
                     == "wave" else "wave")
            turns[f"this, the {other}"] = (
                lambda args=args, other=other: pc.pairhmm_bwd_codes(
                    *args, schedule=other))
        if parent:
            rbm = torch.empty((b, width, width), dtype=torch.float32,
                              device=dev)
            kk = args[5].shape[-1]
            turns["parent"] = lambda args=args, rbm=rbm, kk=kk: parent[
                "pairhmm_bwd_codes"](*(ptr(t) for t in args), int(per_pair),
                                     b, width, width, kk, ptr(rbm), stream)
        geo = pc.bwd_codes_geometry(b, width)
        in_turns(f"kernel 3K at {b} x {width} x {width} ({geo.schedule} by "
                 f"default, {'per-pair' if per_pair else 'shared'} tables)",
                 turns, cs.steady_ms)
        wavefront.check_waits(dev)
        del args
        torch.cuda.empty_cache()


def crossover(dev, bs, widths) -> None:
    """Kernel 3K on one block a pair and on the wave at each B of `bs`
    and width of `widths` (steady ms, the two in turns block, wave,
    wave, block), each launch's RB_M held against the other's."""
    import torch

    import chip_smoke as cs
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import wavefront
    for width in widths:
        for b in bs:
            args = letter_batch(b, width, width, b * 7 + width, dev, False)
            got = {s: pc.pairhmm_bwd_codes(*args, schedule=s)
                   for s in ("block", "wave")}
            wavefront.check_waits(dev)
            d = cs.rbm_err(got["block"], got["wave"], args[2], args[3])
            del got
            times = {"block": [], "wave": []}
            for s in ("block", "wave", "wave", "block"):
                times[s].append(cs.steady_ms(
                    lambda s=s: pc.pairhmm_bwd_codes(*args, schedule=s)))
            wavefront.check_waits(dev)
            blk, wav = min(times["block"]), min(times["wave"])
            print(f"kernel 3K crossover at {b} x {width} x {width} (G = "
                  f"{pc.bwd_codes_geometry(b, width, 'wave').g}): block "
                  f"{times['block']} ms, wave {times['wave']} ms; wave / "
                  f"block {wav / blk:.3f}; block vs wave max |d| {d:.3e} "
                  f"{'equal' if d == 0 else 'FAIL'}", flush=True)
            del args
            torch.cuda.empty_cache()


# mea_dirs diagnostics: (tag, [(old, new)]) edits of csrc/mea_dirs.cu with
# csrc/mea_wave.cuh inlined
_NO_HAND = [("const bool ring_in = band > 0 && w > 0, link_in = band > 0 && w == 0;",
             "const bool ring_in = false, link_in = false;"),
            ("const bool ring_out = has_out && w < W - 1;",
             "const bool ring_out = false;"),
            ("const bool link_out = has_out && w == W - 1;",
             "const bool link_out = false;")]
_MARKS = [("#include <cuda_runtime.h>\n", """#include <cuda_runtime.h>
__device__ long long g_marks[16][8][2];
__device__ unsigned long long g_spins[16][3];
extern "C" int mea_marks(long long* m, unsigned long long* sp) {
  cudaMemcpyFromSymbol(m, g_marks, sizeof(g_marks));
  return (int)cudaMemcpyFromSymbol(sp, g_spins, sizeof(g_spins));
}
"""),
          ("    const int row0 = band * 32, i = row0 + lane;\n",
           "    const int row0 = band * 32, i = row0 + lane;\n"
           "    if (lane == 0 && r < 8) g_marks[w][r][0] = clock64();\n"),
          ("    cp_wait<0>();\n    __syncwarp();\n  }\n}",
           "    cp_wait<0>();\n    __syncwarp();\n"
           "    if (lane == 0 && r < 8) g_marks[w][r][1] = clock64();\n  }\n}"),
          ("      if (mine) v = *slot;\n",
           "      if (mine) v = *slot;\n"
           "      if (lane == 0) atomicAdd(&g_spins[threadIdx.x >> 5][0], 1ull);\n"),
          ("  while (__any_sync(FULL, *taken < need)) {\n",
           "  while (__any_sync(FULL, *taken < need)) {\n"
           "    if (lane == 0) atomicAdd(&g_spins[threadIdx.x >> 5][1], 1ull);\n"),
          ("        while ((known = ld_acquire(link_count)) < need) {\n",
           "        while ((known = ld_acquire(link_count)) < need) {\n"
           "          atomicAdd(&g_spins[threadIdx.x >> 5][2], 1ull);\n")]
MEA_VARIANTS = {"as is": [], "no hand-over": _NO_HAND, "marks": _MARKS}


def mea_variant(tag, edits):
    """mea_dirs.cu (its shared header inlined) under `edits`, built beside
    the kernels; (source, library, command)."""
    from muscle_tpu_torch.utils.build import (CUDA_FLAGS, build_dir, nvcc,
                                              package_path)
    with open(package_path("csrc", "mea_dirs.cu")) as f:
        src = f.read()
    with open(package_path("csrc", "mea_wave.cuh")) as f:
        src = src.replace('#include "mea_wave.cuh"\n',
                          f.read().replace("#pragma once\n", ""))
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {tag}: edit not found: {old[:60]}")
        src = src.replace(old, new, 1)
    out = os.path.join(build_dir(), "variants", "mea",
                       tag.replace(" ", "_"))
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "mea_dirs.cu"), os.path.join(out, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    return cu, so, [nvcc(), *CUDA_FLAGS, "-o", so, cu]


def time_variants(dev) -> None:
    import torch

    import chip_smoke as cs
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import wavefront
    builds = {t: mea_variant(t, e) for t, e in MEA_VARIANTS.items()}
    procs = {t: subprocess.Popen(b[2], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for t, b in builds.items()}
    fns = {}
    ref = djc._kernel("mea_dirs")[0]
    for t, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {t}: {log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"variant {t}: {regs}", flush=True)
        lib = ctypes.CDLL(builds[t][1])
        fn = lib.mea_dirs
        fn.restype, fn.argtypes = ref.restype, ref.argtypes
        fns[t] = (fn, lib)
    cc = 768
    post = random_post((cc, cc), cc, dev)
    packed = torch.empty((cc, cc // 16), dtype=torch.int32, device=dev)
    scores = torch.empty(cc, dtype=torch.float32, device=dev)
    link = torch.empty(cc + 16, dtype=torch.float32, device=dev)
    fault = wavefront.fault_flag(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(fn):
        def go():   # a wait past ~1 ms ends (some variants would hang)
            rc = fn(post.data_ptr(), cc, cc, 1,
                    2_000_000, fault.data_ptr(), link.data_ptr(),
                    packed.data_ptr(), scores.data_ptr(), stream)
            if rc:
                raise RuntimeError("variant launch failed")
        return go
    order = list(MEA_VARIANTS) + ["as is"]
    times = {t: [] for t in MEA_VARIANTS}
    for t in order:
        times[t].append(cs.time_cuda(launch(fns[t][0]), reps=3, per=5))
    for t, v in times.items():
        print(f"mea_dirs variant {t} at {cc} x {cc}: ms a launch {v}",
              flush=True)
    print(f"waits past the limit in the variants: {int(fault.item())}",
          flush=True)
    fault.zero_()
    if "marks" not in fns:
        return
    launch(fns["marks"][0])()
    torch.cuda.synchronize()
    marks = (ctypes.c_longlong * (16 * 8 * 2))()
    spins = (ctypes.c_ulonglong * (16 * 3))()
    fns["marks"][1].mea_marks(marks, spins)
    m = np.array(marks, dtype=np.int64).reshape(16, 8, 2)
    t0 = m[m > 0].min()
    clock = cs.max_sm_clock_hz()
    for w in range(16):
        bands = [f"{(a - t0) / clock * 1e6:.1f}-{(b - t0) / clock * 1e6:.1f}"
                 for a, b in m[w] if a > 0]
        sp = list(spins)[3 * w:3 * w + 3]
        print(f"marks warp {w}: bands (us from the first start at the max "
              f"clock) {bands}; spins ring/room/link {sp}", flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--warps", default="")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--crossover", nargs="?", const=":", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mea_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.utils.build import ensure_built
    print(cs.card_line(), flush=True)
    ensure_built(djc.kernel_specs() + pe.kernel_specs() + pc.kernel_specs())
    for line in cs.ptxas_lines(["mea_dirs", "mea_scores", "pairhmm_bwd",
                                "pairhmm_bwd_codes"]):
        print(f"ptxas: {line}", flush=True)
    dev = torch.device("cuda")
    ok = check(dev) if opts.check else True
    if opts.time:
        time_all(dev, opts.parent,
                 [int(w) for w in opts.warps.split(",") if w])
    if opts.variants:
        time_variants(dev)
    if opts.crossover is not None:
        bs, ws = opts.crossover.split(":")
        crossover(dev, [int(v) for v in bs.split(",") if v] or CROSSOVER_B,
                  [int(v) for v in ws.split(",") if v] or CROSSOVER_WIDTHS)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
