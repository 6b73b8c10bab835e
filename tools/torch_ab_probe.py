#!/usr/bin/env python3
"""Kernels A and B (ops/pairhmm_cuda.py) on the card, by schedule.

    python tools/torch_ab_probe.py [--check] [--batch 1] [--lx 11000]
        [--ly 9800] [--width 10240] [--schedule block,wave] [--g 2,4,8]
        [--rows-per-publish 8] [--crossover] [--rung512] [--stages]
        [--sass] [--parent DIR] [--variants branches]

Prints the card and the kernels' ptxas registers and spills. Then:

--check    holds kernels A and B against their plain versions (max |d|
           = 0 on the real cells of fm, on all of fend, the posterior and
           the MEA) at 512 and at every width of chip_smoke's
           AB_CHECK_WIDTHS, 2 pairs of Lx 192, under the block schedule
           and the wave at every G of --g that divides the width's
           segments (and at B = 8 ragged pairs at 10240);
(default)  times one launch of each (CUDA events, median of 3 after a
           warm-up) at --batch copies of one --lx x --ly pair padded to
           Lx x --width, under each schedule of --schedule and each G;
--crossover times both schedules at B = 1, 8, 33, 66, 132 and 264 pairs
           of 1024 x (width - 64) at widths 2176, 4352 and 10240;
--rung512  times the block schedule at phase 2's shape (B = 512 ragged
           amino pairs of 170-512 padded to 512, chip_smoke.ragged_batch)
           and at its first 132 pairs (5 launches between the events):
           this tree's kernels, each of --variants (source edits of the
           block kernels, VARIANTS: the LOG_ADDs as branches) and, with
           --parent DIR, the kernels of the package unpacked in DIR (its
           csrc built here), in turns (parent, this, variants, then back);
--stages   with --rung512, each of those built with clock64 marks
           between the row loop's barriers (tools/stage_marks.py): mean
           cycles a row of each stage of block 0 (pair 0, 512 x 512);
           with a timing run, the wave kernels marked the same way (block
           0: some group);
--sass     the SASS instruction count of each kernel instance of the two
           libraries (cuobjdump), with its barriers, shuffles and
           branches.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import stage_marks  # noqa: E402

LOOPS = {"pairhmm_fwd": {"pairhmm_fwd.cuh": "for (int i = 0; i < lx; ++i) {"},
         "pairhmm_bwd_post": {
             "pairhmm_bwd_post.cuh": "for (int u = u0; u < Lx; ++u) {"}}
# source edits of the block kernels the probe can time beside them
# (--variants): "branches", every LOG_ADD of the block kernels and of
# their carry chain as a branch around its fit (the kernels before the
# selects, kBF)
_BF = re.compile(r"\b(log_add5|log_add_p|log_add|seg_scan|carry_chain)<kBF>\(")


def _branches(src):
    return _BF.sub(r"\1<false>(", src)


VARIANTS = {"branches": {"pairhmm_fwd.cuh": [_branches],
                         "pairhmm_bwd_post.cuh": [_branches]}}
WAVE_LOOPS = {"pairhmm_fwd": {"pairhmm_wave.cuh":
                              "for (int i = 0; i < lx; ++i) {"},
              "pairhmm_bwd_post": {"pairhmm_wave.cuh":
                                   "for (int u = u0; u < Lx; ++u) {"}}


def real(t, lx, ly):
    """t (B, Lx, Ly) with cells outside (lx, ly) zeroed."""
    import torch
    r = torch.arange(t.shape[1], device=t.device)[None, :, None]
    c = torch.arange(t.shape[2], device=t.device)[None, None, :]
    return t.where((r < lx[:, None, None]) & (c < ly[:, None, None]), 0.0)


def hold(pc, args, schedule, g):
    """Max |d| of kernels A and B against the plain versions."""
    import torch
    x, y, lxt, lyt, match, insert, params = args
    fm, fend = pc.pairhmm_fwd(*args, schedule=schedule, g=g)
    tot = pc._total_prob(fend, params).contiguous()
    post, mea = pc.pairhmm_bwd_post(*args, tot, fm, schedule=schedule, g=g)
    torch.cuda.synchronize()
    pc.wavefront.check_waits(x.device)
    fm2, fend2 = pc.fwd_plain(*args)
    post2, mea2 = pc.bwd_post_plain(*args, tot, fm)
    return max(float((real(fm, lxt, lyt) - real(fm2, lxt, lyt)).abs().max()),
               float((fend - fend2).abs().max()),
               float((post - post2).abs().max()),
               float((mea - mea2).abs().max()))


def check(pc, dev, tabs, groups):
    import torch
    widths = (512,) + cs.AB_CHECK_WIDTHS
    bad = 0
    for width in widths:
        args = tuple(torch.from_numpy(a).to(dev) for a in cs.batch_of(
            [192, 150], [width, width - 131], 192, width, 20,
            seed=width)) + tabs
        nseg = width // 64
        for schedule, g in [("block", None)] + [("wave", g) for g in groups
                                                if nseg % g == 0]:
            d = hold(pc, args, schedule, g)
            bad += d != 0
            print(f"check Ly={width} {schedule}"
                  f"{'' if g is None else f' G={g}'}: max |d| {d:.3e} "
                  f"{'equal' if d == 0 else 'FAIL'}", flush=True)
    lxs = [11000, 9000, 10000, 4000, 10999, 7000, 2000, 9500]
    lys = [9800, 10240, 9731, 8000, 10000, 9000, 3000, 6000]
    args = tuple(torch.from_numpy(a).to(dev) for a in cs.batch_of(
        [v // 8 for v in lxs], lys, 1408, 10240, 20, seed=8)) + tabs
    for g in groups:
        d = hold(pc, args, "wave", g)
        bad += d != 0
        print(f"check B=8 ragged Lx<=1375 Ly=10240 wave G={g}: max |d| "
              f"{d:.3e} {'equal' if d == 0 else 'FAIL'}", flush=True)
    print(f"check: {'all equal' if not bad else f'{bad} FAIL'}", flush=True)


def time_ab(pc, args, schedule, g, reps=3):
    fm, fend = pc.pairhmm_fwd(*args, schedule=schedule, g=g)
    tot = pc._total_prob(fend, args[6]).contiguous()
    ms_a = cs.time_cuda(lambda: pc.pairhmm_fwd(*args, schedule=schedule,
                                               g=g), reps=reps)
    ms_b = cs.time_cuda(lambda: pc.pairhmm_bwd_post(
        *args, tot, fm, schedule=schedule, g=g), reps=reps)
    pc.wavefront.check_waits(args[0].device)
    return ms_a, ms_b


def schedules(opts, nseg):
    out = []
    for s in opts.schedule.split(","):
        if s == "block":
            out.append(("block", None))
        else:
            out += [("wave", g) for g in opts.groups if nseg % g == 0]
    return out


def timing(pc, dev, tabs, opts):
    import torch
    x, y, lxt, lyt = (torch.from_numpy(a).to(dev) for a in cs.batch_of(
        [opts.lx] * opts.batch, [opts.ly] * opts.batch,
        -(-opts.lx // 128) * 128, opts.width, 20, seed=11))
    args = (x, y, lxt, lyt) + tabs
    clock = cs.max_sm_clock_hz()
    marked = (lib_set(pc, "wave-marked", with_marks({}, WAVE_LOOPS))
              if opts.stages else None)
    for schedule, g in schedules(opts, opts.width // 64):
        if marked and schedule == "wave":
            pc._libs.update(marked)
        ms_a, ms_b = time_ab(pc, args, schedule, g,
                             reps=1 if schedule == "block" else 3)
        floor = ""
        if g:
            floor = (f", dependency floor {cs.row_floor_ms(opts.lx, g, clock, False):.2f}"
                     f" / {cs.row_floor_ms(opts.lx, g, clock, True):.2f} ms")
        print(f"B={opts.batch} {opts.lx} x {opts.ly} at "
              f"{x.shape[1]} x {opts.width} {schedule}"
              f"{'' if g is None else f' G={g}'} R="
              f"{pc.wavefront.ROWS_PER_PUBLISH}: A {ms_a:.3f} ms, B "
              f"{ms_b:.3f} ms ({ms_a * 1e3 / opts.lx:.3f} / "
              f"{ms_b * 1e3 / opts.lx:.3f} us a row){floor}", flush=True)
        if opts.stages and schedule == "wave":
            for name in ("pairhmm_fwd", "pairhmm_bwd_post"):
                print(f"  {name} wave G={g}: cycles a row between marks "
                      f"{stage_marks.stage_cycles(pc._libs[name], opts.lx)}",
                      flush=True)
            pc._libs.clear()


def crossover(pc, dev, tabs):
    import torch
    for width in (2176, 4352, 10240):
        for b in (1, 8, 33, 66, 132, 264):
            args = tuple(torch.from_numpy(a).to(dev) for a in cs.batch_of(
                [1024] * b, [width - 64] * b, 1024, width, 20,
                seed=b)) + tabs
            row = []
            for schedule in ("block", "wave"):
                ms_a, ms_b = time_ab(pc, args, schedule, None, reps=1)
                row.append(f"{schedule} A {ms_a:.3f} B {ms_b:.3f} ms")
            print(f"crossover Ly={width} B={b} (Lx 1024): " + "; ".join(row),
                  flush=True)
            del args
            torch.cuda.empty_cache()


def parent_libs(parent_dir):
    """The parent package's kernel A and B libraries, built here from its
    csrc, with the parent's C interfaces."""
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, build_dir, nvcc
    out = os.path.join(build_dir(), "parent")
    os.makedirs(out, exist_ok=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    types = {"pairhmm_fwd": [vp] * 7 + [ci] * 5 + [vp] * 3,
             "pairhmm_bwd_post": [vp] * 7 + [ci] + [vp] + [ci] * 5 + [vp] * 4}
    libs = {}
    for name, argtypes in types.items():
        so = os.path.join(out, f"lib{name}.so")
        subprocess.run([nvcc(), *CUDA_FLAGS, "-o", so, os.path.join(
            parent_dir, "muscle_tpu_torch", "csrc", f"{name}.cu")],
            check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(so), name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes

        def call(*a, fn=fn, name=name):
            if fn(*a):
                raise RuntimeError(f"the parent's {name} launch failed")
        libs[name] = call
    return libs


def lib_set(pc, tag, edits):
    """Kernels A and B built with `edits` ({file: [edit]}, applied to
    both libraries; tools/stage_marks.py), with the kernels' argtypes."""
    pc._libs.clear()
    pc._lib("pairhmm_fwd")
    out = {}
    for name in ("pairhmm_fwd", "pairhmm_bwd_post"):
        lib = stage_marks.variant_library(name, tag, edits)
        fn, ref = getattr(lib, name), getattr(pc._libs[name], name)
        fn.restype, fn.argtypes = ref.restype, ref.argtypes
        out[name] = lib
    pc._libs.clear()
    return out


def with_marks(edits, loops):
    out = {f: list(fns) for f, fns in edits.items()}
    for name, heads in loops.items():
        for f, head in heads.items():
            out.setdefault(f, []).append(stage_marks.mark(head))
    return out


def rung512(pc, dev, tabs, opts):
    """Phase 2's shape on one block a pair: this tree's kernels, the
    --variants and the --parent's, in turns; with --stages their
    marked rows instead."""
    import torch
    xb, yb, lx, ly = cs.ragged_batch(512, 512 // 3, 512, 512, seed=20261016)
    full = tuple(torch.from_numpy(a).to(dev) for a in (xb, yb, lx, ly)) + tabs
    edits = {"this": {}}
    edits.update((v, VARIANTS[v]) for v in opts.variants)
    sets = {}
    for tag, e in edits.items():
        if opts.stages:
            sets[tag] = lib_set(pc, f"{tag}-marked", with_marks(e, LOOPS))
        elif tag != "this":
            sets[tag] = lib_set(pc, tag, e)
    parent = parent_libs(opts.parent) if opts.parent and not opts.stages \
        else None
    for b in (512, 132):
        args = tuple(t[:b].contiguous() for t in full[:4]) + tabs
        fm, fend = pc.pairhmm_fwd(*args, schedule="block")
        tot = pc._total_prob(fend, tabs[2]).contiguous()
        if opts.stages:
            for tag, libs in sets.items():
                pc._libs.clear()
                pc._libs.update(libs)
                for name, run in (("pairhmm_fwd", lambda: pc.pairhmm_fwd(
                        *args, schedule="block")),
                        ("pairhmm_bwd_post", lambda: pc.pairhmm_bwd_post(
                            *args, tot, fm, schedule="block"))):
                    run()
                    torch.cuda.synchronize()
                    print(f"B={b} at 512 block, {tag}, marked: {name} cycles "
                          "a row between marks (block 0, 512 rows) "
                          f"{stage_marks.stage_cycles(libs[name], 512)}",
                          flush=True)
            pc._libs.clear()
            continue
        out = {}

        def ours(tag):
            pc._libs.clear()
            if tag in sets:
                pc._libs.update(sets[tag])
            ms_a = cs.time_cuda(lambda: pc.pairhmm_fwd(
                *args, schedule="block"), per=5)
            ms_b = cs.time_cuda(lambda: pc.pairhmm_bwd_post(
                *args, tot, fm, schedule="block"), per=5)
            out.setdefault(tag, []).append((ms_a, ms_b))
            pc._libs.clear()

        def par():
            post = torch.empty_like(fm)
            mea = torch.empty((b,), dtype=torch.float32, device=dev)
            p = [ctypes.c_void_p(t.data_ptr()) for t in args]
            st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            kk = tabs[1].shape[0]
            fm_p = torch.empty_like(fm)
            fend_p = torch.empty_like(fend)
            ms_a = cs.time_cuda(lambda: parent["pairhmm_fwd"](
                *p, 0, b, 512, 512, kk, ctypes.c_void_p(fm_p.data_ptr()),
                ctypes.c_void_p(fend_p.data_ptr()), st), per=5)
            ms_b = cs.time_cuda(lambda: parent["pairhmm_bwd_post"](
                *p, 0, ctypes.c_void_p(tot.data_ptr()), b, 512, 512, kk, 1,
                ctypes.c_void_p(fm.data_ptr()),
                ctypes.c_void_p(post.data_ptr()),
                ctypes.c_void_p(mea.data_ptr()), st), per=5)
            out.setdefault("parent", []).append((ms_a, ms_b))

        order = [par] if parent else []
        order += [lambda t=t: ours(t) for t in edits]
        for run in order + order[::-1]:
            run()
        for who, times in out.items():
            print(f"B={b} at 512 block, {who}: A "
                  f"{[round(a, 4) for a, _ in times]} ms, B "
                  f"{[round(b_, 4) for _, b_ in times]} ms", flush=True)


def sass(pc):
    """SASS instruction counts of each kernel instance."""
    import shutil
    from muscle_tpu_torch.utils.build import ensure_built, nvcc
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc()), "cuobjdump")
    paths = ensure_built(pc.kernel_specs(("pairhmm_fwd", "pairhmm_bwd_post")))
    for name, path in paths.items():
        text = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        for fn in re.split(r"\n\s*Function : ", text)[1:]:
            fname = fn.split("\n", 1)[0].strip()
            ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn)
            ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0] for i in ins
                   if i.strip()]
            count = {k: sum(o.startswith(k) for o in ops)
                     for k in ("BAR", "SHFL", "BRA", "FADD", "FMUL", "FSEL",
                               "FSETP", "FMNMX", "LDG", "STG", "LDS", "STS")}
            print(f"sass {name}: {fname}: {len(ops)} instructions {count}",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--lx", type=int, default=11000)
    ap.add_argument("--ly", type=int, default=9800)
    ap.add_argument("--width", type=int, default=10240)
    ap.add_argument("--schedule", default="block,wave")
    ap.add_argument("--g", default="2,4,8")
    ap.add_argument("--rows-per-publish", type=int, default=None)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--rung512", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="")
    ap.add_argument("--no-timing", action="store_true")
    opts = ap.parse_args()
    opts.groups = [int(g) for g in opts.g.split(",")]
    opts.variants = [v for v in opts.variants.split(",") if v]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.utils.build import ensure_built
    if opts.rows_per_publish:
        pc.wavefront.ROWS_PER_PUBLISH = opts.rows_per_publish
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    ensure_built(pc.kernel_specs())
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    for line in cs.ptxas_lines(["pairhmm_fwd", "pairhmm_bwd_post"]):
        print(f"ptxas: {line}", flush=True)
    tabs = pc.tables(HMMParams.from_defaults(nucleo=False).to_scores(), dev)
    if opts.sass:
        sass(pc)
    if opts.check:
        check(pc, dev, tabs, opts.groups)
    if opts.crossover:
        crossover(pc, dev, tabs)
    if opts.rung512:
        rung512(pc, dev, tabs, opts)
        if opts.stages:
            pc._libs.clear()
    if not opts.no_timing:
        timing(pc, dev, tabs, opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
