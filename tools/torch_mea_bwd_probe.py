#!/usr/bin/env python3
"""Probe of the MEA direction kernel (mea_dirs) and kernel 3 (the legacy
backward) on the card.

    python tools/torch_mea_bwd_probe.py [--check] [--time] [--parent DIR]

--check: mea_dirs against mea_dirs_plain (max |d| = 0 required) on
         random and tie-heavy posteriors (mostly zeros, values from
         {0, 0.25, 0.5}) at the odd shapes, the rows past 512 that wrap
         the bands (the link row) and wide rows; kernel 3 (the wave)
         against bwd_plain at 128, 2048, 2176 and 12288 (2 pairs, 96
         rows), rows u >= lx zero.
--time:  mea_dirs at 768 x 768 and the main path's shapes (MEA_TIMED;
         random, tie-heavy) and kernel 3 on
         mega-long's chunk (8 pairs at 12288, chip_smoke.mega_set),
         CUDA events (median of 5 after a warm-up;
         mea_dirs with 20 launches between the events).
--parent DIR: with --time, the kernels of the package unpacked in DIR
         (its csrc built here, its C interfaces) timed in the same call,
         in turns: parent, this, this, parent (the parent's kernel 3:
         one block a pair).
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


def check(dev) -> bool:
    import torch
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    from chip_smoke import tie_heavy
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
    return ok


def parent_libs(parent_dir):
    """The parent package's mea_dirs and kernel 3 libraries, built here
    from its csrc, with its C interfaces (mea_dirs(post, cc1, cc2,
    threads, wpt, packed, scores, stream); pairhmm_bwd(e, ins_x, ins_y,
    lxb, lyb, params, per_pair, B, Lx, Ly, rbm, stream))."""
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, build_dir, nvcc
    out = os.path.join(build_dir(), "parent")
    os.makedirs(out, exist_ok=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    types = {"mea_dirs": [vp] + [ci] * 4 + [vp] * 3,
             "pairhmm_bwd": [vp] * 6 + [ci] * 4 + [vp] * 2}
    procs = {}
    for name in types:
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc(), *CUDA_FLAGS, "-o", so, os.path.join(
                parent_dir, "muscle_tpu_torch", "csrc", f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"the parent's {name}: {proc.stdout.read()}")
        fn = getattr(ctypes.CDLL(so), name)
        fn.restype, fn.argtypes = ctypes.c_int, types[name]

        def call(*a, fn=fn, name=name):
            if fn(*a):
                raise RuntimeError(f"the parent's {name} launch failed")
        libs[name] = call
    return libs


def time_all(dev, parent_dir) -> None:
    import torch

    import chip_smoke as cs
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    parent = parent_libs(parent_dir) if parent_dir else None

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for cc1, cc2 in MEA_TIMED:
        for kind, make in (("random", random_post),
                           ("tie-heavy", cs.tie_heavy)):
            post = make((cc1, cc2), cc1 + cc2, dev)
            turns = {"this": lambda: djc.mea_dirs(post)}
            if parent:
                w = -(-cc2 // 16)
                wpt = next((p for p in (1, 2, 4) if -(-w // p) <= 1024), 4)
                threads = 32 * -(-w // (32 * wpt))
                packed = torch.empty((cc1, w), dtype=torch.int32, device=dev)
                scores = torch.empty(cc1, dtype=torch.float32, device=dev)
                turns["parent"] = lambda: parent["mea_dirs"](
                    ptr(post), cc1, cc2, threads, wpt, ptr(packed),
                    ptr(scores), stream)
            order = (["parent", "this", "this", "parent"] if parent
                     else ["this"])
            times = {k: [] for k in turns}
            for k in order:
                times[k].append(cs.time_cuda(turns[k], per=20))
            print(f"mea_dirs at {cc1} x {cc2} ({kind}), ms a launch: "
                  + "; ".join(f"{k} {v}" for k, v in times.items()),
                  flush=True)
            del post

    ms_set = cs.mega_set(*cs.MEGA_LONG)[0]
    nl = len(ms_set.labels)
    pairs = [(x, y) for x in range(nl) for y in range(x + 1, nl)]
    pairs += [pairs[0]] * (8 - len(pairs))
    params = pc.params_vec(HMMParams.from_defaults(nucleo=False).to_scores(),
                           dev)
    largs = cs.mega_batch(ms_set, pairs, cs.MEGA_LONG_PAD, dev) + (params,)
    b, lx_pad, ly_pad = largs[0].shape
    turns = {"this": lambda: pe.pairhmm_bwd(*largs)}
    if parent:
        rbm = torch.empty((b, lx_pad, ly_pad), dtype=torch.float32,
                          device=dev)
        turns["parent"] = lambda: parent["pairhmm_bwd"](
            *(ptr(t) for t in largs), 0, b, lx_pad, ly_pad, ptr(rbm), stream)
    order = (["parent", "this", "this", "parent"] if parent
             else ["this"])
    times = {k: [] for k in turns}
    for k in order:
        times[k].append(cs.time_cuda(turns[k], reps=3))
    pc.wavefront.check_waits(dev)
    print(f"kernel 3 on mega-long's chunk ({b} x {lx_pad} x {ly_pad}, lx "
          f"{int(largs[3].min())}-{int(largs[3].max())}), ms: "
          + "; ".join(f"{k} {v}" for k, v in times.items()), flush=True)


# mea_dirs diagnostics: (tag, [(old, new)]) edits of csrc/mea_dirs.cu
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
    """mea_dirs.cu under `edits`, built beside the kernels; (fn, lib)."""
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.utils.build import (CUDA_FLAGS, build_dir, nvcc,
                                              package_path)
    with open(package_path("csrc", "mea_dirs.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {tag}: edit not found: {old[:60]}")
        src = src.replace(old, new)
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
    ap.add_argument("--variants", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mea_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.utils.build import ensure_built
    print(cs.card_line(), flush=True)
    ensure_built(djc.kernel_specs() + pe.kernel_specs())
    for line in cs.ptxas_lines(["mea_dirs", "pairhmm_bwd"]):
        print(f"ptxas: {line}", flush=True)
    dev = torch.device("cuda")
    ok = check(dev) if opts.check else True
    if opts.time:
        time_all(dev, opts.parent)
    if opts.variants:
        time_variants(dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
