#!/usr/bin/env python3
"""sha256 of the long families' alignments on the card.

    python tools/torch_long_family_sha.py [--root DIR] [--repeat N]
        [--family NAME ...]

Aligns chip_smoke.py's "long mixed" (six proteins of 8,700-11,000
residues, refine cut as there) and "long pair" (two ~19 kb nucleotide
sequences), or the families named by --family (also "mega-long": four
synthetic `.mega` chains of 8,300-9,800 residues at pad 12288, the
Muscle-3D legacy route, refine cut as there), with
`muscle_tpu_torch.align(..., device="cuda")` and prints the sha256 of
each alignment's FASTA text. The families come from this
checkout's chip_smoke.py; the package comes from DIR (default: this
checkout), so that the same families can be run through another
commit's package, unpacked into a directory that .gitignore lists, and
the texts compared by their digests.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--family", action="append",
                    choices=["long mixed", "long pair", "mega-long"])
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_families", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import muscle_tpu_torch
    from muscle_tpu_torch import align
    print(f"package {os.path.dirname(muscle_tpu_torch.__file__)}",
          flush=True)
    wanted = opts.family or ["long mixed", "long pair"]
    families = []
    for name in wanted:
        if name == "mega-long":
            ms = cs.mega_set(*cs.MEGA_LONG)[0]
            families.append((name, cs.mega_seqs(ms),
                             cs.MEGA_LONG_REFINE_ITERS, {"mega": ms}))
        elif name == "long mixed":
            families.append((name, cs.family_of_lengths(
                cs.LONG_MIXED, cs.AMINO_LETTERS, 6),
                cs.LONG_MIXED_REFINE_ITERS, {}))
        else:
            families.append((name, cs.family_of_lengths(
                cs.LONG_PAIR, b"ACGT", 2), 100, {}))
    for k in range(opts.repeat):
        for name, seqs, iters, kw in families:
            t0 = time.perf_counter()
            msa = align(seqs, device="cuda", refine_iters=iters, **kw)
            torch.cuda.synchronize()
            digest = hashlib.sha256(msa.to_fasta_text().encode()).hexdigest()
            print(f"{name} (run {k + 1}): sha256 {digest} wall "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
