#!/usr/bin/env python3
"""The NW Viterbi and SW score kernels on the card (ops/dp_cuda.py).

    python tools/torch_dp_probe.py --check            # build, hold, time
    python tools/torch_dp_probe.py --grid [--parent DIR]
    python tools/torch_dp_probe.py --wide             # 1024 rows, wide
    python tools/torch_dp_probe.py --variants         # other geometries
    python tools/torch_dp_probe.py --super6 400 [--super7]

--check builds the two libraries alone and runs
chip_smoke.phase_dp_kernels: their ptxas lines, each kernel against its
plain version on the real cells at 64 pairs at pads 384 and 2048 and at
4 pairs of 1024 rows at 24576 and 32768 lanes (bits equal, max |d| = 0),
timed by CUDA events beside its bound and its dependency floor
(chip_smoke.dp_floor_ms). --grid times each kernel (steady: 20 launches
first, 5 between the events) at B = 1, 16, 64, 256 pairs at pads 128,
384, 1024 and 2048; with --parent DIR also the kernels of the package
unpacked in DIR (its csrc/dp_rows.cuh, nw_viterbi.cu and sw_scores.cu,
built here into build/muscle_tpu_torch/parent; the same C entries), in
turns (parent, this, this, parent), each parent launch's real cells
required equal to this one's. --wide times both at 4 ragged pairs of
1024 rows at 24576 and at 32768 lanes (a cluster of 4 / 5 blocks a
pair). --variants builds copies of the kernels with other geometry
constants (VARIANTS) and times them against this build at B = 64, pads
384 and 2048, in turns. --super6 N builds every library and runs Super6 with default
settings on the first N rows of chip_smoke.super5_set(), printing its
stage walls, its cluster sizes, the NW launches and their summed device
time (CUDA events around each launch); --super7 runs Super7 on
chip_smoke's mega-128 set at shrubs of 32 likewise (the SW launches).
Prints the card (nvidia-smi) first; exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRID_WIDTHS = (128, 384, 1024, 2048)
GRID_PAIRS = (1, 16, 64, 256)


# --variants: copies of csrc/dp_rows.cuh with other geometry constants
# (text replacements), built beside the kernels and timed in turns with
# this build at B = 64, pads 384 and 2048
VARIANTS = {
    "block8": {"kBlockCols = 4;": "kBlockCols = 8;"},
    "warp512": {"kWarpLanes = 128;": "kWarpLanes = 512;"},
}


def parent_kernels(parent_dir):
    """The parent's nw_viterbi and sw_scores, built from DIR's csrc."""
    return built_kernels("parent", os.path.join(
        parent_dir, "muscle_tpu_torch", "csrc"), {})


def built_kernels(tag, csrc, edits):
    """nw_viterbi and sw_scores built from the sources in `csrc` (copied,
    with dp_rows.cuh's text replacements `edits`) into
    build/muscle_tpu_torch/<tag>, wrapped as ops/dp_cuda's wrappers
    (outputs allocated alike, zeroed where the wrappers zero them; the
    same C entries)."""
    import shutil
    import torch
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, build_dir, nvcc
    out = os.path.join(build_dir(), tag)
    os.makedirs(out, exist_ok=True)
    for f in ("dp_rows.cuh", "nw_viterbi.cu", "sw_scores.cu"):
        shutil.copy(os.path.join(csrc, f), out)
    with open(os.path.join(out, "dp_rows.cuh")) as f:
        text = f.read()
    for a, b in edits.items():
        if a not in text:
            raise RuntimeError(f"variant {tag}: {a!r} not in dp_rows.cuh")
        text = text.replace(a, b)
    with open(os.path.join(out, "dp_rows.cuh"), "w") as f:
        f.write(text)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    types = {"nw_viterbi": [vp] * 5 + [ci] * 4 + [vp] * 4,
             "sw_scores": [vp] * 5 + [ci] * 4 + [vp] * 2}
    procs = {}
    for name in types:
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc(), *CUDA_FLAGS, "-o", so, os.path.join(out, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}'s {name}: {log}")
        fn = getattr(ctypes.CDLL(so), name)
        fn.restype, fn.argtypes = ctypes.c_int, types[name]
        fns[name] = fn

    def run(name, xb, yb, lxb, lyb, subst):
        b, bx = xb.shape
        by = yb.shape[1]
        st = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (xb, yb, lxb, lyb, subst)]
        dims = [subst.shape[0], b, bx, by]
        if name == "nw_viterbi":
            bits = torch.empty((b, bx, by + 1), dtype=torch.uint8,
                               device=xb.device)
            final = torch.zeros((b, 3, by + 1), device=xb.device)
            scores = torch.zeros(b, device=xb.device)
            rc = fns[name](*ptrs, *dims, bits.data_ptr(), final.data_ptr(),
                           scores.data_ptr(), st)
            got = (bits, final, scores)
        else:
            got = torch.zeros(b, device=xb.device)
            rc = fns[name](*ptrs, *dims, got.data_ptr(), st)
        if rc:
            raise RuntimeError(f"{tag}'s {name} launch failed ({rc})")
        return got
    return run


def grid(cs, dev, parent) -> None:
    """ms by pairs and pad, this build and (in turns) the parent's."""
    import torch
    from muscle_tpu_torch.ops import dp_cuda
    for width in GRID_WIDTHS:
        for b in GRID_PAIRS:
            a = cs.dp_args(b, width, width + b, dev)
            for name in dp_cuda.LAUNCHES:
                this = getattr(dp_cuda, name)
                bnd = cs.dp_bound(name, a)
                floor = cs.dp_floor_ms(name, a, cs.max_sm_clock_hz())
                line = (f"{name} B={b} pad {width}: bound {bnd[0]:.5f} by "
                        f"{bnd[1]}, floor {floor:.4f}")
                if parent is None:
                    ms = cs.steady_ms(lambda: this(*a))
                    print(f"{line}: {ms:.4f} ms", flush=True)
                    continue
                got = cs.real_dp(name, a, this(*a))
                want = cs.real_dp(name, a, parent(name, *a))
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                runs = {"parent": [], "this": []}
                for tag in ("parent", "this", "this", "parent"):
                    fn = (this if tag == "this" else
                          lambda *x: parent(name, *x))
                    runs[tag].append(cs.steady_ms(lambda: fn(*a)))
                p, t = (statistics.mean(runs[k]) for k in ("parent", "this"))
                print(f"{line}: this {t:.4f} ms {runs['this']}, parent "
                      f"{p:.4f} ms {runs['parent']} ({p / t:.2f}x); real "
                      f"cells equal to the parent's: {same}", flush=True)
                if not same:
                    raise RuntimeError(f"{name} differs from the parent's")


def variants(cs, dev) -> None:
    """VARIANTS against this build at B = 64, pads 384 and 2048, in turns
    (this, variant, variant, this), each variant's real cells required
    equal to this build's."""
    import torch
    from muscle_tpu_torch.ops import dp_cuda
    here = os.path.join(ROOT, "muscle_tpu_torch", "csrc")
    built = {tag: built_kernels(tag, here, e) for tag, e in VARIANTS.items()}
    for width in (384, 2048):
        a = cs.dp_args(64, width, width + 64, dev)
        for name in dp_cuda.LAUNCHES:
            this = getattr(dp_cuda, name)
            want = cs.real_dp(name, a, this(*a))
            for tag, run in built.items():
                got = cs.real_dp(name, a, run(name, *a))
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                runs = {"this": [], tag: []}
                for t in ("this", tag, tag, "this"):
                    fn = this if t == "this" else (lambda *x: run(name, *x))
                    runs[t].append(cs.steady_ms(lambda: fn(*a)))
                m0, m1 = (statistics.mean(runs[k]) for k in ("this", tag))
                print(f"{name} B=64 pad {width}: this {m0:.4f} ms, {tag} "
                      f"{m1:.4f} ms ({m0 / m1:.2f}x); real cells equal: "
                      f"{same}", flush=True)


def timed_launches(dp_cuda, nw, sw):
    """Wraps the NW / SW entry points of ops/nw and ops/sw: each launch
    timed by CUDA events (synchronised), summed by kernel."""
    import torch
    total = {"nw_viterbi": [0, 0.0], "sw_scores": [0, 0.0]}

    def timed(name, fn):
        def call(*args):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*args)
            e.record()
            torch.cuda.synchronize()
            total[name][0] += 1
            total[name][1] += s.elapsed_time(e)
            return out
        return call
    nw.nw_viterbi_batch = timed("nw_viterbi", dp_cuda.nw_viterbi)
    sw.sw_scores_batch = timed("sw_scores", dp_cuda.sw_scores)
    return total


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--parent", default=None, metavar="DIR")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--super6", type=int, default=0, metavar="N")
    ap.add_argument("--super7", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dp_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_tpu_torch.ops import dp_cuda, nw, sw
    from muscle_tpu_torch.utils.build import build_all, ensure_built

    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if args.super6 or args.super7:
        build_all()
    else:
        ensure_built(dp_cuda.kernel_specs())
    parent = parent_kernels(args.parent) if args.parent else None
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    if args.check:
        print(json.dumps(cs.phase_dp_kernels(dev)), flush=True)
    if args.grid:
        grid(cs, dev, parent)
    if args.variants:
        variants(cs, dev)
    if args.wide:
        for width in cs.DP_WIDE_LANES:
            a = cs.dp_wide_args(width, dev)
            for name in dp_cuda.LAUNCHES:
                fn = getattr(dp_cuda, name)
                ms = cs.steady_ms(lambda: fn(*a))
                bnd = cs.dp_bound(name, a)
                floor = cs.dp_floor_ms(name, a, cs.max_sm_clock_hz())
                print(f"{name} 4 pairs of 1024 rows at {width} lanes "
                      f"{dp_cuda.geometry(width + (name == 'nw_viterbi'))}: "
                      f"{ms:.4f} ms (bound {bnd[0]:.5f} by {bnd[1]}, floor "
                      f"{floor:.4f})", flush=True)
    if args.super6 or args.super7:
        import tempfile
        from muscle_tpu_torch import MultiSequence
        from muscle_tpu_torch.pipeline import super6
        from muscle_tpu_torch.pipeline.ensemble import run_align_command
        from muscle_tpu_torch.utils import logging as mlog
        total = timed_launches(dp_cuda, nw, sw)
        work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        runs = []
        if args.super6:
            inp = os.path.join(work, "super6.fa")
            MultiSequence(list(cs.super5_set())[:args.super6]).write_fasta(
                inp)
            runs.append((f"super6 synthetic-{args.super6}", "super6", inp,
                         {}))
        if args.super7:
            cs.mega_set(*cs.MEGA_128)
            n, _, _, seed = cs.MEGA_128
            runs.append(("super7 mega-128 shrub 32", "super7", os.path.join(
                ROOT, "build", "chip_smoke", f"mega-{n}-{seed}.mega"),
                {"shrub_size": "32"}))
        for what, cmd, inp, opts in runs:
            mlog.STAGE_TIMES.clear()
            for v in total.values():
                v[:] = [0, 0.0]
            t0 = time.perf_counter()
            run_align_command(cmd, inp, os.path.join(work, "out.afa"), opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = f" run={json.dumps(super6.LAST_RUN)}" if cmd == "super6" \
                else ""
            print(f"{what}: wall={wall:.2f}s (launches timed one by one) "
                  f"stages={json.dumps(mlog.STAGE_TIMES)}{run} dp launches "
                  f"and summed device ms={json.dumps(total)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
