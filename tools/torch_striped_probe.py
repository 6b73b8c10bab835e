#!/usr/bin/env python3
"""Kernels 5 and 6 (ops/pairhmm_striped.py) on the card, group by group.

    python tools/torch_striped_probe.py [--check] [--groups 1,2,4,8,16,32]
                                        [--batch 1] [--rows-per-publish 16]
                                        [--single] [--stages]

Prints the card, the kernels' ptxas registers and spills; with --check,
holds one whole pass of each against its plain twin (max |d| = 0) on 8
ragged pairs (Lx 512, By 2 x 2048) at every G of --groups; then times one
whole pass of each, CUDA events around one call (median of 3 after a
warm-up), at the long pair's shape (19000 x 18900 nt padded 19456 x
20480, 10 stripes of 2048), --batch copies of it, at every G; with
--single, on a row of one group instead (By = W = 64 G, the long pair's
first 64 G columns): the row time of a group with no hand-over; with
--stages, each kernel's copy with a clock64() mark after every block
barrier of its row loop and at the loop's top (built here, beside the
kernels, by `stage_libs`) replaces it, and block 0's thread 0 prints
the mean cycles a row between consecutive marks (the stage that ends at
each barrier, the slowest warp's). The
backward pass writes its posterior over the forward's M lattice, so its
timed repeats run on their own output: the work does not depend on the
values.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--groups", default="1,2,4,8,16,32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--rows-per-publish", type=int, default=None)
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--stages", action="store_true")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_striped as ps
    if opts.rows_per_publish:
        ps.ROWS_PER_PUBLISH = opts.rows_per_publish
    dev = torch.device("cuda")
    groups = [int(g) for g in opts.groups.split(",")]
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    from muscle_tpu_torch.utils.build import ensure_built
    ensure_built(ps.kernel_specs())
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    for line in cs.ptxas_lines(["pairhmm_fwd_stripe", "pairhmm_bwd_stripe"]):
        print(f"ptxas: {line}", flush=True)
    w = ps.MAX_W

    def cuda(*arrs):
        return tuple(torch.from_numpy(a).to(dev) for a in arrs)

    if opts.check:
        amino = pc.tables(HMMParams.from_defaults(nucleo=False).to_scores(),
                          dev)
        args = cuda(*cs.batch_of(cs.STRIPE_CHECK_LX, cs.STRIPE_CHECK_LY, 512,
                                 2 * w, 20, seed=2048)) + amino
        iy0, jy0, iy0b, jy0b = ps.row0_closed_forms(args[1], args[3],
                                                    amino[1], amino[2])
        fm2, fend2 = ps.fwd_striped_plain(*args, iy0, jy0, w)
        tot = pc._total_prob(fend2, amino[2]).contiguous()
        post2, mea2 = ps.bwd_striped_plain(*args, tot, iy0b, jy0b,
                                           fm2.clone(), w)
        for g in groups:
            fm, fend = ps.pairhmm_fwd_striped(*args, iy0, jy0, w, g)
            d5 = max(float((fm - fm2).abs().max()),
                     float((fend - fend2).abs().max()))
            post, mea = ps.pairhmm_bwd_striped(*args, tot, iy0b, jy0b,
                                               fm2.clone(), w, g)
            d6 = max(float((post - post2).abs().max()),
                     float((mea - mea2).abs().max()))
            ps.check_waits(dev)
            print(f"G={g}: kernel 5 max |d| {d5:.3e}, kernel 6 max |d| "
                  f"{d6:.3e} {'equal' if d5 == d6 == 0 else 'FAIL'}",
                  flush=True)

    if opts.stages:
        stage_libs(ps)
    nt = pc.tables(HMMParams.from_defaults(nucleo=True).to_scores(), dev)
    b = opts.batch
    lx1, ly1, px, py = 19000, 18900, 19456, 10 * w
    for g in groups:
        wg = 64 * g if opts.single else w
        byg = wg if opts.single else py
        x, y, lxt, lyt = cuda(*cs.batch_of([lx1] * b, [min(ly1, byg)] * b,
                                           px, byg, 4, seed=19))
        args = (x, y, lxt, lyt) + nt
        iy0, jy0, iy0b, jy0b = ps.row0_closed_forms(y, lyt, nt[1], nt[2])
        geo = ps._geometry(b, byg, wg, g)
        fm, fend = ps.pairhmm_fwd_striped(*args, iy0, jy0, wg, g)
        tot = pc._total_prob(fend, nt[2]).contiguous()
        ms5 = cs.time_cuda(lambda: ps.pairhmm_fwd_striped(*args, iy0, jy0,
                                                          wg, g), reps=3)
        ms6 = cs.time_cuda(lambda: ps.pairhmm_bwd_striped(*args, tot, iy0b,
                                                          jy0b, fm, wg, g),
                           reps=3)
        ps.check_waits(dev)
        if opts.stages:
            for name in ps._KERNELS:
                print(f"  {name}: cycles a row between marks "
                      f"{stage_cycles(ps, name, lx1)}", flush=True)
        print(f"B={b} By={byg} W={wg} G={g} ({geo.groups} groups a pair, "
              f"{b * geo.groups} blocks of {32 * g} threads, R "
              f"{ps.ROWS_PER_PUBLISH}): kernel 5 {ms5:.3f} ms, kernel 6 "
              f"{ms6:.3f} ms ({ms5 * 1e3 / lx1:.3f} / {ms6 * 1e3 / lx1:.3f} "
              "us a row)", flush=True)
        del fm
        torch.cuda.empty_cache()
    print(f"default G at B={b}: {ps._geometry(b, py, w).g}", flush=True)
    return 0


# the marks: after each block barrier of the row loop, and at its top
_PROF_HEAD = """
__device__ long long g_stage_cycles[8];
#define STAGE_MARK(k)                                       \\
  if (threadIdx.x == 0 && blockIdx.x == 0) {                \\
    const long long t_ = clock64();                         \\
    if (stage_last) stage_acc[k] += t_ - stage_last;        \\
    stage_last = t_;                                        \\
  }
extern "C" int stage_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stage_cycles, sizeof(g_stage_cycles));
}
"""


def _instrument(src: str, loop_head: str) -> str:
    """The kernel source with STAGE_MARKs (see _PROF_HEAD)."""
    head, body = src.split(loop_head, 1)
    kernel_end = body.index("\n}\n\nextern \"C\"")
    loop, tail = body[:kernel_end], body[kernel_end:]
    k = 1
    while "__syncthreads();\n" in loop:
        loop = loop.replace("__syncthreads();\n",
                            f"__syncthreads(); STAGE_MARK({k});\n", 1)
        k += 1
    head = head.replace("using namespace ph;", "using namespace ph;\n"
                        + _PROF_HEAD, 1)
    head = head.replace("  extern __shared__ float smem[];",
                        "  extern __shared__ float smem[];\n"
                        "  long long stage_acc[8] = {0}, stage_last = 0;", 1)
    dump = ("\n  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
            "    for (int k_ = 0; k_ < 8; ++k_) "
            "g_stage_cycles[k_] = stage_acc[k_];")
    return (head + loop_head + " STAGE_MARK(0);" + loop + dump + tail)


def stage_libs(ps) -> None:
    """Build the instrumented copies and load them in place of kernels
    5 and 6 (same C entries and arguments)."""
    import ctypes
    import shutil
    import subprocess
    from muscle_tpu_torch.utils.build import (CUDA_FLAGS, build_dir, nvcc,
                                              package_path)
    out = os.path.join(build_dir(), "stages")
    os.makedirs(out, exist_ok=True)
    for h in ("pairhmm_common.cuh", "stripe_wavefront.cuh"):
        shutil.copy(package_path("csrc", h), out)
    heads = {"pairhmm_fwd_stripe": "for (int i = 0; i < lx; ++i) {",
             "pairhmm_bwd_stripe": "for (int u = u0; u < Lx; ++u) {"}
    libs = {}
    for name, loop_head in heads.items():
        with open(package_path("csrc", f"{name}.cu")) as fh:
            src = _instrument(fh.read(), loop_head)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(out, f"lib{name}.so")
        subprocess.run([nvcc(), *CUDA_FLAGS, "-o", so, cu], check=True,
                       capture_output=True)
        libs[name] = ctypes.CDLL(so)
    ps._libs.clear()
    ps._lib("pairhmm_fwd_stripe")      # argtypes as the kernels'
    for name, lib in libs.items():
        fn = getattr(lib, name)
        ref = getattr(ps._libs[name], name)
        fn.restype, fn.argtypes = ref.restype, ref.argtypes
        lib.pairhmm_error_string.restype = ctypes.c_char_p
        lib.pairhmm_error_string.argtypes = [ctypes.c_int]
        lib.stage_cycles.argtypes = [ctypes.c_void_p]
        ps._libs[name] = lib


def stage_cycles(ps, name, rows) -> list[float]:
    import ctypes
    buf = (ctypes.c_longlong * 8)()
    ps._libs[name].stage_cycles(ctypes.cast(buf, ctypes.c_void_p))
    return [round(v / rows, 1) for v in buf if v]


if __name__ == "__main__":
    sys.exit(main())
