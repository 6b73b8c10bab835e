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
kernels, by tools/stage_marks.py) replaces it, and block 0's thread 0 prints
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
sys.path.insert(0, os.path.join(ROOT, "tools"))

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
        ps.wavefront.ROWS_PER_PUBLISH = opts.rows_per_publish
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
            ps.wavefront.check_waits(dev)
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
        ps.wavefront.check_waits(dev)
        if opts.stages:
            for name in ps._KERNELS:
                print(f"  {name}: cycles a row between marks "
                      f"{stage_cycles(ps, name, lx1)}", flush=True)
        print(f"B={b} By={byg} W={wg} G={g} ({geo.groups} groups a pair, "
              f"{b * geo.groups} blocks of {32 * g} threads, R "
              f"{ps.wavefront.ROWS_PER_PUBLISH}): kernel 5 {ms5:.3f} ms, kernel 6 "
              f"{ms6:.3f} ms ({ms5 * 1e3 / lx1:.3f} / {ms6 * 1e3 / lx1:.3f} "
              "us a row)", flush=True)
        del fm
        torch.cuda.empty_cache()
    print(f"default G at B={b}: {ps._geometry(b, py, w).g}", flush=True)
    return 0


def stage_libs(ps) -> None:
    """Build the marked copies (tools/stage_marks.py: the row loops of
    csrc/pairhmm_wave.cuh, the kernels' body) and load them in place of
    kernels 5 and 6 (same C entries and arguments)."""
    import stage_marks
    heads = {"pairhmm_fwd_stripe": "for (int i = 0; i < lx; ++i) {",
             "pairhmm_bwd_stripe": "for (int u = u0; u < Lx; ++u) {"}
    ps._libs.clear()
    ps._lib("pairhmm_fwd_stripe")      # argtypes as the kernels'
    for name, loop_head in heads.items():
        lib = stage_marks.variant_library(
            name, "stages", {"pairhmm_wave.cuh": [stage_marks.mark(loop_head)]})
        fn, ref = getattr(lib, name), getattr(ps._libs[name], name)
        fn.restype, fn.argtypes = ref.restype, ref.argtypes
        ps._libs[name] = lib


def stage_cycles(ps, name, rows) -> list[float]:
    import stage_marks
    return stage_marks.stage_cycles(ps._libs[name], rows)


if __name__ == "__main__":
    sys.exit(main())
