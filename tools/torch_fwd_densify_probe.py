#!/usr/bin/env python3
"""Probe of kernel 1E (the Muscle-3D forward) and kernel 8 (the Gram
panel densify) on the card.

    python tools/torch_fwd_densify_probe.py [--check] [--time]
        [--variants] [--diagnose] [--parent DIR]

--check:    kernel 1E on the wave against fwd_emis_plain (4 ragged pairs,
            64 rows) at 256, 640, 2176 and 4352 lanes and several G, and
            against kernel A on the wave on the letter lattice at 4096
            and 10240 (3 pairs, 192 rows); kernel 8 against
            densify_panel_plain at L = 128, 384, 512, 1536, 3072 in f32
            and bf16 and at 12288 in f32 (every flag, the dump row, a
            pid below 0). Each must be equal (max |d| = 0).
--time:     kernel 1E and kernel 3 on mega-long's chunk (8 pairs at
            12288, chip_smoke.mega_set), kernel 8 on chip_smoke's n = 200
            z-tile (bf16, f32) and on long mixed's 12288 f32 z-tile; CUDA
            events, median of 3-5 after a warm-up; kernel 8 also as
            chip_smoke.py times it (20 launches first, 5 between the
            events).
--parent DIR: with --time and --variants, the kernels of the package
            unpacked in DIR (its csrc built here, its C interfaces)
            timed in the same call, in turns: parent, this, this, parent
            (the parent's 1E: one block a pair; its kernel 8: one block
            a slab).
--variants: kernel 1E on mega-long's chunk as shipped (the lattice read
            a row ahead), with the lattice read at the row (the loads on
            the row's chain) and with a constant lattice (no loads: a
            diagnostic, wrong results); kernel 8's alternatives (tiles of
            64 KB, 256 threads a block, stores kept in L2, the TMA's bulk
            copies for the write-out), each held to the plain version, on
            both z-tiles; with --parent,
            the parent's kernel 8 as it is and built with its scatter
            pass cut (its zero pass alone: a diagnostic) on the n = 200
            z-tile.
--diagnose: kernel 1E's wave on 1, 2, 4 and 8 of mega-long's pairs, and
            kernel A's wave on 1 and 8 letter pairs at 10240: ms and us
            a row.
Prints the card (nvidia-smi name and power limit) first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_of(dev):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def mega_long_chunk(dev):
    """Kernel 1E's and 3's arguments on mega-long's chunk: its 6 pairs and
    2 copies of the first, 8 x 12288 x 12288 (as chip_smoke.py)."""
    import chip_smoke as cs
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    ms_set = cs.mega_set(*cs.MEGA_LONG)[0]
    nl = len(ms_set.labels)
    pairs = [(x, y) for x in range(nl) for y in range(x + 1, nl)]
    pairs += [pairs[0]] * (8 - len(pairs))
    params = pc.params_vec(HMMParams.from_defaults(nucleo=False).to_scores(),
                           dev)
    return cs.mega_batch(ms_set, pairs, cs.MEGA_LONG_PAD, dev) + (params,)


def n200_tile(dev):
    """chip_smoke.py's n = 200 store and z-tile 6 maps (L 512, K 24)."""
    import torch

    import chip_smoke as cs
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.pipeline.posteriors import store_rows
    n, l, k, blk = 200, 512, 24, 16
    p1 = store_rows(n * (n - 1) // 2)
    vals, cols = cs.synthetic_store(dev, p1, l, k, seed=200)
    nblk = -(-n // blk)
    nbp = (nblk + min(max(1, 16384 // (blk * l)), nblk) - 1) * blk
    pid, flag = cons._block_maps(n, nbp, p1 - 1)
    return (vals, cols, torch.as_tensor(pid[6 * blk:7 * blk], device=dev),
            torch.as_tensor(flag[6 * blk:7 * blk], device=dev))


def long_tile(dev):
    """Long mixed's f32 z-tile 3 (n = 6, L 12288, one sequence a block)."""
    import torch

    import chip_smoke as cs
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.pipeline.posteriors import store_rows
    n, l = len(cs.LONG_MIXED), 12288
    vals, cols = cs.synthetic_store(dev, store_rows(n * (n - 1) // 2), l, 24,
                                    seed=6)
    pid, flag = cons._block_maps(n, n, vals.shape[0] - 1)
    return (vals, cols, torch.as_tensor(pid[3:4], device=dev),
            torch.as_tensor(flag[3:4], device=dev))


def check(dev) -> bool:
    import torch
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.ops import densify_cuda as dc
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    from chip_smoke import real_cells, synthetic_store
    ok = True
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), dev)
    for width, g in ((256, 1), (256, 4), (640, 2), (640, 5), (2176, None),
                     (4352, None), (4352, 1)):
        rng = np.random.default_rng(width + (g or 0))
        b, rows = 4, 64
        lx = np.array([64, 1, 37, 63], np.int32)
        ly = np.array([width, width - 63, 1, width - 64], np.int32)
        arrs = (rng.random((b, rows, width), dtype=np.float32) * 4 - 3,
                -1 - rng.random((b, rows), dtype=np.float32),
                -1 - rng.random((b, width), dtype=np.float32), lx, ly)
        args = tuple(torch.as_tensor(a, device=dev) for a in arrs)
        fm, fend = pe.pairhmm_fwd_emis(*args, params, schedule="wave", g=g)
        torch.cuda.synchronize()
        wavefront.check_waits(dev)
        fm2, fend2 = pe.fwd_emis_plain(*args, params)
        d = max(float((real_cells(fm, args[3], args[4])
                       - real_cells(fm2, args[3], args[4])).abs().max()),
                float((fend - fend2).abs().max()))
        ok &= d == 0
        geo = pc.ab_geometry(b, width, "wave", g)
        print(f"kernel 1E on the wave at {width} (G = {geo.g}) vs plain: "
              f"max |d| {d:.3e} {'equal' if d == 0 else 'FAIL'}", flush=True)
    match, insert, _ = pc.tables(HMMParams.from_defaults().to_scores(), dev)
    for width in (4096, 10240):
        rng = np.random.default_rng(width)
        b, rows = 3, 192
        lx = rng.integers(96, rows + 1, size=b).astype(np.int32)
        ly = rng.integers(width - 700, width + 1, size=b).astype(np.int32)
        lx[0], ly[0] = rows, width
        xb = np.full((b, rows), 20, np.int32)
        yb = np.full((b, width), 20, np.int32)
        for i in range(b):
            xb[i, :lx[i]] = rng.integers(0, 21, size=lx[i])
            yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
        x, y, lxt, lyt = (torch.as_tensor(a, device=dev)
                          for a in (xb, yb, lx, ly))
        fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
        e = match[x.long()[:, :, None], y.long()[:, None, :]].contiguous()
        fm2, fend2 = pe.pairhmm_fwd_emis(e, insert[x.long()].contiguous(),
                                         insert[y.long()].contiguous(), lxt,
                                         lyt, params)
        torch.cuda.synchronize()
        wavefront.check_waits(dev)
        same = (torch.equal(real_cells(fm, lxt, lyt),
                            real_cells(fm2, lxt, lyt))
                and torch.equal(fend, fend2))
        ok &= same
        print(f"kernel 1E on the wave vs kernel A on the wave, letter "
              f"lattice at {width}: {'equal' if same else 'FAIL'}",
              flush=True)
    for l, n, nbp in ((128, 5, 8), (384, 4, 6), (512, 4, 6), (1536, 3, 4),
                      (3072, 3, 4), (12288, 2, 3)):
        p1 = n * (n - 1) // 2 + 1
        vals, cols = synthetic_store(dev, p1, l, 24, seed=l)
        pid, flag = cons._block_maps(n, nbp, p1 - 1)
        pid[0, -1] = -1    # a dump column
        dtypes = ((torch.float32,) if l > 3072
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            same = True
            for zi in range(0, n, 2):
                p = torch.as_tensor(pid[zi:zi + 2].copy(), device=dev)
                f = torch.as_tensor(flag[zi:zi + 2].copy(), device=dev)
                got = dc.densify_panel(vals, cols, p, f, dtype)
                want = dc.densify_panel_plain(vals, cols, p, f, dtype)
                torch.cuda.synchronize()
                same &= torch.equal(got, want)
                del got, want
                torch.cuda.empty_cache()
            ok &= same
            print(f"kernel 8 at L={l} ({dtype}, tile "
                  f"{dc.tile_shape(l, dtype)}) vs plain: "
                  f"{'equal' if same else 'FAIL'}", flush=True)
    return ok


def build(tag, src_dir, name, edits=(), headers_from=None):
    """csrc/<name>.cu of `src_dir` copied beside the kernels with its
    headers, under `edits` ((file, old, new)), and built; the library
    path and ptxas's register lines."""
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, build_dir, nvcc
    out = os.path.join(build_dir(), "variants", tag.replace(" ", "_"))
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(src_dir, "muscle_tpu_torch", "csrc"), out)
    for fname, old, new in edits:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {tag}: edit not found in {fname}: "
                               f"{old[:60]}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    so = os.path.join(out, f"lib{name}.so")
    proc = subprocess.run([nvcc(), *CUDA_FLAGS, "-o", so,
                           os.path.join(out, f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {tag}: {proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return so, regs


def load(so, name, argtypes):
    fn = getattr(ctypes.CDLL(so), name)
    fn.restype, fn.argtypes = ctypes.c_int, argtypes

    def call(*a):
        if fn(*a):
            raise RuntimeError(f"{so}: {name} launch failed")
    return call


VP, CI, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C interfaces of the parent (commit 3a0d2bf) and of this tree
PARENT_TYPES = {"pairhmm_fwd_emis": [VP] * 6 + [CI] * 4 + [VP] * 3,
                "pairhmm_bwd": [VP] * 6 + [CI] * 6 + [LL] + [VP] * 6,
                "densify": [VP] * 4 + [CI] * 6 + [VP] * 2}
THIS_1E = [VP] * 6 + [CI] * 6 + [LL] + [VP] * 7
DENSIFY_TYPES = PARENT_TYPES["densify"]  # the same C interface

# kernel 1E diagnostics: (tag, [(file, old, new)])
LATTICE_AT_ROW = [("pairhmm_fwd_emis.cu", "launch_fwd_wave<LatticeAhead>",
                   "launch_fwd_wave<LatticeEmission>")]
CONSTANT_LATTICE = [("pairhmm_common.cuh",
                     "    e_next = __ldg(reinterpret_cast<const float2*>"
                     "(e_b + (size_t)i * Ly + j));\n"
                     "    insx_next = __ldg(insx_b + i);\n",
                     "    e_next = make_float2(-1.0f, -1.0f);\n"
                     "    insx_next = -1.0f;\n")]
# the parent's kernel 8 without its scatter pass (its zero pass alone)
ZERO_PASS_ALONE = [("densify.cu",
                    "  if (flag == FLAG_EYE || pid < 0 || pid >= P1) return;",
                    "  return;")]


def turns(fns, reps=3, per=1, rounds=1, warm=0):
    """Each of `fns` timed (chip_smoke.time_cuda, after `warm` more
    calls) in turns: with a "parent", parent, the others, the others,
    parent; else `rounds` passes over them in order."""
    import chip_smoke as cs
    names = list(fns)
    order = (["parent"] + [k for k in names if k != "parent"] * 2
             + ["parent"]) if "parent" in fns else names * rounds
    times = {k: [] for k in names}
    for k in order:
        for _ in range(warm):
            fns[k]()
        times[k].append(round(cs.time_cuda(fns[k], reps=reps, per=per), 4))
    return times


def time_all(dev, parent_dir) -> None:
    import torch
    from muscle_tpu_torch.ops import densify_cuda as dc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    stream = stream_of(dev)
    parent = {}
    if parent_dir:
        for name, types in PARENT_TYPES.items():
            so, regs = build(f"parent {name}", parent_dir, name)
            parent[name] = load(so, name, types)
            print(f"parent {name}: {regs}", flush=True)
    largs = mega_long_chunk(dev)
    b, lx_pad, ly_pad = largs[0].shape
    fm = torch.empty((b, lx_pad, ly_pad), dtype=torch.float32, device=dev)
    fend = torch.empty((b, 5), dtype=torch.float32, device=dev)
    fns = {"this": lambda: pe.pairhmm_fwd_emis(*largs)}
    if parent:
        fns["parent"] = lambda: parent["pairhmm_fwd_emis"](
            *(ptr(t) for t in largs), 0, b, lx_pad, ly_pad, ptr(fm),
            ptr(fend), stream)
    print(f"kernel 1E on mega-long's chunk ({b} x {lx_pad} x {ly_pad}), ms: "
          f"{turns(fns)}", flush=True)
    del fm
    fns = {"this": lambda: pe.pairhmm_bwd(*largs)}
    if parent:
        from muscle_tpu_torch.ops import pairhmm_cuda as pc
        rbm = torch.empty((b, lx_pad, ly_pad), dtype=torch.float32,
                          device=dev)
        geo = pe.bwd_geometry(b, ly_pad)

        def parent_bwd():
            wave, bufs = pc._wave_args(geo, b, lx_pad, ly_pad, "bwd", dev)
            parent["pairhmm_bwd"](*(ptr(t) for t in largs), 0, b, lx_pad,
                                  ly_pad, *wave, ptr(rbm), stream)
        fns["parent"] = parent_bwd
    print(f"kernel 3 on mega-long's chunk, ms: {turns(fns)}", flush=True)
    wavefront.check_waits(dev)
    del largs, fns
    torch.cuda.empty_cache()
    for what, make in (("the n = 200 z-tile", n200_tile),
                       ("long mixed's 12288 z-tile", long_tile)):
        vals, cols, pids, flags = make(dev)
        p1, l, k = vals.shape
        t, nb = pids.shape
        for dtype in ((torch.bfloat16, torch.float32)
                      if l <= 512 else (torch.float32,)):
            out = torch.empty((t * l, nb * l), dtype=dtype, device=dev)
            fns = {"this": lambda: dc.densify_panel(vals, cols, pids, flags,
                                                    dtype)}
            if parent:
                fns["parent"] = lambda: parent["densify"](
                    ptr(vals), ptr(cols), ptr(pids), ptr(flags), p1, l, k, t,
                    nb, int(dtype == torch.bfloat16), ptr(out), stream)
            # first after one warm-up, one launch between the events; then
            # as chip_smoke.densify_case times it (20 launches first, 5
            # between the events)
            first = turns(fns, reps=5 if l <= 512 else 1)
            steady = turns(fns, reps=5, per=5, warm=20)
            print(f"kernel 8 on {what} ({dtype}), ms: one warm-up, one "
                  f"launch between the events {first}; 20 launches first, "
                  f"5 between the events {steady}", flush=True)
            del out
            torch.cuda.empty_cache()


def time_variants(dev, parent_dir) -> None:
    import torch
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import wavefront
    stream = stream_of(dev)
    variants = {"as shipped": [], "lattice at the row": LATTICE_AT_ROW,
                "constant lattice": CONSTANT_LATTICE}
    fns = {}
    largs = mega_long_chunk(dev)
    b, lx_pad, ly_pad = largs[0].shape
    geo = pc.ab_geometry(b, ly_pad)
    fm = torch.empty((b, lx_pad, ly_pad), dtype=torch.float32, device=dev)
    fend = torch.empty((b, 5), dtype=torch.float32, device=dev)
    for tag, edits in variants.items():
        so, regs = build(f"1E {tag}", ROOT, "pairhmm_fwd_emis", edits)
        print(f"variant 1E {tag}: {regs}", flush=True)
        fn = load(so, "pairhmm_fwd_emis", THIS_1E)

        def go(fn=fn):
            wave, bufs = pc._wave_args(geo, b, lx_pad, ly_pad, "fwd", dev)
            fn(*(ptr(t) for t in largs), 0, b, lx_pad, ly_pad, *wave,
               ptr(fm), ptr(fend), stream)
        fns[tag] = go
    print(f"kernel 1E variants on mega-long's chunk (G = {geo.g}), ms: "
          f"{turns(fns, reps=5, rounds=2)}", flush=True)
    wavefront.check_waits(dev)
    del largs, fm
    torch.cuda.empty_cache()
    densify_variants(dev)
    if not parent_dir:
        return
    vals, cols, pids, flags = n200_tile(dev)
    p1, l, k = vals.shape
    t, nb = pids.shape
    fns = {}
    for tag, edits in (("parent", []), ("parent, zero pass alone",
                                        ZERO_PASS_ALONE)):
        so, regs = build(f"8 {tag}", parent_dir, "densify", edits)
        fns[tag] = load(so, "densify", PARENT_TYPES["densify"])
    for dtype in (torch.bfloat16, torch.float32):
        out = torch.empty((t * l, nb * l), dtype=dtype, device=dev)
        calls = {tag: (lambda fn=fn: fn(
            ptr(vals), ptr(cols), ptr(pids), ptr(flags), p1, l, k, t, nb,
            int(dtype == torch.bfloat16), ptr(out), stream))
            for tag, fn in fns.items()}
        print(f"the parent's kernel 8 on the n = 200 z-tile ({dtype}), ms: "
              f"{turns(calls, reps=5)}", flush=True)
        del out


# kernel 8 alternatives: (tag, [(file, old, new)])
_WRITE_OUT = """  for (int q = threadIdx.x; q < nrows * per_row; q += kThreads) {
    const int r = q / per_row, p = q - r * per_row;
    __stcs(reinterpret_cast<uint4*>(slab_out + (size_t)(r0 + r) * ld + col0 +
                                    p * VEC),
           smem[q]);
  }"""
# the write-out with plain 16-byte stores (kept in L2)
PLAIN_STORES = [("densify.cu", _WRITE_OUT, """  for (int q = threadIdx.x; q < nrows * per_row; q += kThreads) {
    const int r = q / per_row, p = q - r * per_row;
    *reinterpret_cast<uint4*>(slab_out + (size_t)(r0 + r) * ld + col0 +
                              p * VEC) = smem[q];
  }""")]
# tiles of 64 KB (C = 512 columns; two blocks an SM), beyond the
# default 48 KB of dynamic shared memory
TILES_64K = [("densify.cu", "constexpr int kTileBytes = 32 * 1024;\n"
              "static_assert(kTileBytes <= 48 * 1024, "
              "\"a tile fits the default smem\");",
              "constexpr int kTileBytes = 64 * 1024;"),
             ("densify.cu", "  const size_t items",
              "  cudaFuncSetAttribute(densify_panel_kernel<T>, "
              "cudaFuncAttributeMaxDynamicSharedMemorySize, "
              "static_cast<int>(smem));\n  const size_t items")]
THREADS_256 = [("densify.cu", "constexpr int kThreads = 512;",
                "constexpr int kThreads = 256;")]
# the tile's output rows written by the TMA (cp.async.bulk, one copy a
# row started by one thread) instead of 16-byte stores
TMA_STORES = [("densify.cu", _WRITE_OUT, """  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  bool started = false;
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    T* dst = slab_out + (size_t)(r0 + r) * ld + col0;
    const unsigned src =
        static_cast<unsigned>(__cvta_generic_to_shared(smem + r * per_row));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            dst),
        "r"(src), "r"(per_row * 16)
        : "memory");
    started = true;
  }
  if (started) {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }""")]
DENSIFY_VARIANTS = (("as shipped", []), ("64 KB tiles", TILES_64K),
                    ("256 threads", THREADS_256),
                    ("stores kept in L2", PLAIN_STORES),
                    ("TMA stores", TMA_STORES))


def densify_variants(dev) -> None:
    """Kernel 8's alternatives in turns on the n = 200 z-tile (both
    dtypes) and long mixed's 12288 f32 tile; each variant held to the
    plain version once."""
    import torch
    from muscle_tpu_torch.ops import densify_cuda as dc
    stream = stream_of(dev)
    libs = {}
    for tag, edits in DENSIFY_VARIANTS:
        try:
            so, regs = build(f"8 {tag}", ROOT, "densify", edits)
        except RuntimeError as e:
            print(f"variant 8 {tag}: not built: {e}", flush=True)
            continue
        libs[tag] = load(so, "densify", DENSIFY_TYPES)
        print(f"variant 8 {tag}: {regs}", flush=True)
    for what, make in (("the n = 200 z-tile", n200_tile),
                       ("long mixed's 12288 z-tile", long_tile)):
        vals, cols, pids, flags = make(dev)
        p1, l, k = vals.shape
        t, nb = pids.shape
        for dtype in ((torch.bfloat16, torch.float32)
                      if l <= 512 else (torch.float32,)):
            out = torch.empty((t * l, nb * l), dtype=dtype, device=dev)
            want = dc.densify_panel_plain(vals, cols, pids, flags, dtype)
            fns, same = {}, {}
            for tag, lib in libs.items():
                fn = (lambda lib=lib: lib(
                    ptr(vals), ptr(cols), ptr(pids), ptr(flags), p1, l, k, t,
                    nb, int(dtype == torch.bfloat16), ptr(out), stream))
                fn()
                torch.cuda.synchronize()
                same[tag] = torch.equal(out, want)
                fns[tag] = fn
            del want
            torch.cuda.empty_cache()
            print(f"kernel 8 variants on {what} ({dtype}): equal {same}; "
                  f"ms {turns(fns, reps=5, rounds=2)}", flush=True)
            del out


def diagnose(dev) -> None:
    """What sets the wave's row: kernel 1E on the first B of mega-long's
    8 pairs (B = 1, 2, 4, 8: 48 B blocks of G = 4 warps on 132 SMs), and
    kernel A on the wave on B = 1 and 8 letter pairs of 4096 rows at
    10240; ms and us a row (over the batch's longest pair)."""
    import torch
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    import chip_smoke as cs
    largs = mega_long_chunk(dev)
    for b in (1, 2, 4, 8):
        sub = tuple(a[:b].contiguous() for a in largs[:5]) + (largs[5],)
        ms = cs.time_cuda(lambda: pe.pairhmm_fwd_emis(*sub), reps=3)
        rows = int(sub[3].max())
        print(f"kernel 1E on the wave, {b} of mega-long's pairs ({48 * b} "
              f"blocks): {ms:.3f} ms, {ms * 1e3 / rows:.3f} us a row over "
              f"{rows} rows", flush=True)
    del largs
    torch.cuda.empty_cache()
    match, insert, params = pc.tables(
        HMMParams.from_defaults(nucleo=False).to_scores(), dev)
    rng = np.random.default_rng(5)
    width, rows = 10240, 4096
    xb = rng.integers(0, 20, size=(8, rows)).astype(np.int32)
    yb = rng.integers(0, 20, size=(8, width)).astype(np.int32)
    lx = np.full(8, rows, np.int32)
    ly = np.full(8, width, np.int32)
    for b in (1, 8):
        x, y, lxt, lyt = (torch.as_tensor(a[:b], device=dev)
                          for a in (xb, yb, lx, ly))
        ms = cs.time_cuda(lambda: pc.pairhmm_fwd(x, y, lxt, lyt, match,
                                                 insert, params), reps=3)
        print(f"kernel A on the wave, {b} letter pair(s) of {rows} x {width} "
              f"({40 * b} blocks): {ms:.3f} ms, {ms * 1e3 / rows:.3f} us a "
              "row", flush=True)
    wavefront.check_waits(dev)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--diagnose", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_densify_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muscle_tpu_torch.ops import densify_cuda as dc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.utils.build import ensure_built
    print(cs.card_line(), flush=True)
    ensure_built(pe.kernel_specs() + dc.kernel_specs())
    for line in cs.ptxas_lines(["pairhmm_fwd_emis", "pairhmm_bwd"]):
        print(f"ptxas: {line}", flush=True)
    dev = torch.device("cuda")
    ok = check(dev) if opts.check else True
    if opts.time:
        time_all(dev, opts.parent)
    if opts.variants:
        time_variants(dev, opts.parent)
    if opts.diagnose:
        diagnose(dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
