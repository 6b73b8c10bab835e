#!/usr/bin/env python3
"""The NW Viterbi and SW score kernels on the card (ops/dp_cuda.py).

    python tools/torch_dp_probe.py --check            # build, hold, time
    python tools/torch_dp_probe.py --grid             # ms by pairs and pad
    python tools/torch_dp_probe.py --super6 400       # Super6's stages

--check builds the two libraries alone and runs
chip_smoke.phase_dp_kernels: their ptxas lines, each kernel against its
plain version at 64 pairs at pads 384 and 2048 (bits equal, max |d| =
0), timed by CUDA events beside its bound. --grid times each kernel (20 launches
first, 5 between the events) at B = 1, 16, 64, 256 pairs at pads 128,
384, 1024 and 2048. --super6 N builds every library and runs Super6 with
default settings on the first N rows of chip_smoke.super5_set(),
printing its stage walls, its cluster sizes and the DP launches. Prints
the card (nvidia-smi) first; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--super6", type=int, default=0, metavar="N")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dp_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_tpu_torch.ops import dp_cuda
    from muscle_tpu_torch.utils.build import build_all, ensure_built

    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if args.super6:
        build_all()
    else:
        ensure_built(dp_cuda.kernel_specs())
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    if args.check:
        print(json.dumps(cs.phase_dp_kernels(dev)), flush=True)
    if args.grid:
        for width in (128, 384, 1024, 2048):
            for b in (1, 16, 64, 256):
                a = cs.dp_args(b, width, width + b, dev)
                for name in dp_cuda.LAUNCHES:
                    fn = getattr(dp_cuda, name)
                    ms = cs.steady_ms(lambda: fn(*a))
                    bnd = cs.dp_bound(name, a)
                    print(f"{name} B={b} pad {width}: {ms:.4f} ms (bound "
                          f"{bnd[0]:.5f} by {bnd[1]})", flush=True)
    if args.super6:
        from muscle_tpu_torch import MultiSequence
        from muscle_tpu_torch.alphabet import ALPHA_AMINO
        from muscle_tpu_torch.hmm.params import HMMParams
        from muscle_tpu_torch.pipeline.super6 import LAST_RUN, Super6
        from muscle_tpu_torch.utils import logging as mlog
        seqs = MultiSequence(list(cs.super5_set())[:args.super6])
        mlog.STAGE_TIMES.clear()
        dp_cuda.reset_launches()
        t0 = time.perf_counter()
        msa = Super6(device=dev).run(seqs, HMMParams.from_defaults(),
                                     ALPHA_AMINO)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cs.check_alignment(seqs, msa, "super6")
        print(f"super6 n={len(seqs)}: wall={wall:.2f}s "
              f"stages={json.dumps(mlog.STAGE_TIMES)} "
              f"run={json.dumps(LAST_RUN)} "
              f"dp launches={json.dumps(dp_cuda.LAUNCHES)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
