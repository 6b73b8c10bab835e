#!/usr/bin/env python3
"""Kernel 3K (pairhmm_bwd_codes) with and without its corner output,
against another commit's kernel 3K, on the card.

    python tools/torch_bwd_codes_corner_probe.py --parent DIR [--turns N]

At chip_smoke.py's phase-2 shape (512 pairs, 512 x 512, per-pair tables
of four HMMs, the same lengths) and on the wave at 4 x 4096 (its
bwd_codes_wide shape): builds DIR's muscle_tpu_torch/csrc/
pairhmm_bwd_codes.cu (DIR: another commit unpacked, whose C interface is
as at commit f729287, without the corner pointer) beside this checkout's
kernel, holds this kernel's RB_M with the corner output off and on to the
parent's (max |d| = 0 on the real cells and the zero rows u >= lx) and
to the plain version's (with its corner), and times them steady
(chip_smoke.steady_ms: 20 launches first, 5 between the events) in turns
N times: parent, this, this, parent, and this with the corner output once
a turn. Prints the card (nvidia-smi name and power limit) first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((512, 512, 20261017), (4, 4096, 4096))   # (B, width, seed)


def parent_kernel(parent_dir):
    """The parent's kernel 3K, built here: call(args, rbm, geo, bufs)."""
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, build_dir, nvcc
    out = os.path.join(build_dir(), "parent")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libpairhmm_bwd_codes.so")
    proc = subprocess.run(
        [nvcc(), *CUDA_FLAGS, "-o", so, os.path.join(
            parent_dir, "muscle_tpu_torch", "csrc", "pairhmm_bwd_codes.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, check=False)
    log = proc.stdout.decode()
    if proc.returncode:
        raise RuntimeError(f"the parent's kernel 3K: {log}")
    print("the parent's kernel 3K: "
          f"{[ln.strip() for ln in log.splitlines() if 'registers' in ln]}",
          flush=True)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = ctypes.CDLL(so).pairhmm_bwd_codes
    fn.restype = ci
    fn.argtypes = [vp] * 7 + [ci] * 5 + [ci] * 2 + [ll] + [vp] * 4 + [vp] * 2
    return fn


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--turns", type=int, default=3)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import wavefront
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    parent = parent_kernel(opt.parent)
    ptr = pc._ptr
    ok = True
    for b, width, seed in SHAPES:
        xb, yb, lx, ly = cs.ragged_batch(b, width // 3, width, width, seed)
        x, y, lxt, lyt = (torch.from_numpy(a).to(dev)
                          for a in (xb, yb, lx, ly))
        _, (m, i, s, t) = cs.ensemble_tables(
            dev, [k % len(cs.ENSEMBLE_SEEDS) for k in range(b)])
        args = (x, y, lxt, lyt, m.contiguous(), i.contiguous(),
                pc.params_rows(s, t))
        geo = pc.bwd_codes_geometry(b, width)
        rbm_p = torch.empty((b, width, width), dtype=torch.float32,
                            device=dev)

        def run_parent():
            wave, bufs = pc._wave_args(geo, b, width, width, "bwd", dev)
            rc = parent(*(ptr(a) for a in args), 1, b, width, width,
                        i.shape[-1], *wave, ptr(rbm_p), pc._stream(x))
            if rc:
                raise RuntimeError("the parent's kernel 3K launch failed")
            return bufs

        run_parent()
        rb = pc.pairhmm_bwd_codes(*args)
        rb_on, far = pc.pairhmm_bwd_codes(*args, corner=True)
        want_rb, want_far = pc.bwd_codes_plain(*args, corner=True)
        torch.cuda.synchronize()
        wavefront.check_waits(dev)
        d = {"this vs parent": cs.rbm_err(rb, rbm_p, lxt, lyt),
             "corner on vs parent": cs.rbm_err(rb_on, rbm_p, lxt, lyt),
             "this vs plain": cs.rbm_err(rb, want_rb, lxt, lyt),
             "corner vs plain": float((far - want_far).abs().max())}
        same = not any(d.values())
        ok = ok and same
        del rb, rb_on, want_rb
        times = {"parent": [], "this": [], "this, corner on": []}
        for _ in range(opt.turns):
            for who in ("parent", "this", "this", "parent",
                        "this, corner on"):
                fn = {"parent": run_parent,
                      "this": lambda: pc.pairhmm_bwd_codes(*args),
                      "this, corner on": lambda: pc.pairhmm_bwd_codes(
                          *args, corner=True)}[who]
                times[who].append(cs.steady_ms(fn))
        wavefront.check_waits(dev)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"kernel 3K at {b} x {width} x {width} ({geo.schedule}, "
              f"per-pair tables): max |d| {d} "
              f"{'equal' if same else 'FAIL'}; steady ms, median of "
              f"{len(times['this'])} (all: "
              f"{ {k: [round(x, 4) for x in v] for k, v in times.items()} }"
              f"): parent {med['parent']:.4f}, this {med['this']:.4f} "
              f"({med['this'] / med['parent']:.4f}x), corner on "
              f"{med['this, corner on']:.4f}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
