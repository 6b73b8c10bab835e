"""Profile one `muscle_tpu_torch.align` call on the GPU with torch.profiler.

    python tools/torch_profile_align.py [--n 32 --lo 400 --hi 512]
                                        [--long mixed|pair]
                                        [--super5 synthetic|rdrp16]
                                        [--mega 8|128|long]
                                        [--ensemble 48|bb11002]
                                        [--trace build/align_trace.json]

Aligns a synthetic family of chip_smoke.py (n mutated copies of one
random protein, lengths lo-hi; by default n = 32, lengths 400-512, the
top of the dense branch; n = 200 takes the blocked Gram branch with
device refine), or with --long one of its long families ("mixed": six
proteins of 8,700-11,000 residues on kernels A/B and the striped
kernels, refine cut as chip_smoke.py cuts it; "pair": two ~19 kb
nucleotide sequences on the striped kernels), once to warm up, then
once under the profiler. With --super5 it runs `muscle_tpu_torch.super5`
once on chip_smoke.py's synthetic-1000 set or on the degapped rdrp-16
golden instead, after building every kernel, tracing the device only
(the host side of a Super5 run is millions of small operations). With
--mega it aligns one of chip_smoke.py's Muscle-3D `.mega` sets ("8",
"128" or "long", refine cut for "long" as chip_smoke.py cuts it).
With --ensemble it runs one ensemble through
`pipeline.ensemble.run_align_command`, as the CLI does, tracing the
device only: chip_smoke.py's ensemble-48 under -stratified ("48") or
the degapped BB11002 golden under -diversified ("bb11002").
Prints the device kernels by total time, the device busy time (the
union of kernel intervals), the wall of the profiled call and the
device's idle share of it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_us(events) -> float:
    """Union of the device kernels' [start, end) intervals, microseconds."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32, help="sequences")
    ap.add_argument("--lo", type=int, default=400, help="shortest length")
    ap.add_argument("--hi", type=int, default=512, help="longest length")
    ap.add_argument("--long", choices=("mixed", "pair"), default=None,
                    help="one of chip_smoke.py's long families instead")
    ap.add_argument("--super5", choices=("synthetic", "rdrp16"),
                    default=None, help="profile super5() on one of "
                    "chip_smoke.py's Super5 sets instead")
    ap.add_argument("--mega", choices=("8", "128", "long"), default=None,
                    help="one of chip_smoke.py's .mega sets instead")
    ap.add_argument("--ensemble", choices=("48", "bb11002"), default=None,
                    help="one of chip_smoke.py's ensembles instead")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled call here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_tpu_torch import align
    from torch.profiler import ProfilerActivity, profile

    print(cs.card_line())
    opts = {}
    run = align
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.super5:
        from muscle_tpu_torch import MultiSequence, super5
        from muscle_tpu_torch.utils.build import build_all
        build_all()
        run = super5
        activities = [ProfilerActivity.CUDA]
        seqs = (cs.super5_set() if args.super5 == "synthetic" else
                MultiSequence.from_fasta(os.path.join(ROOT, cs.RDRP16),
                                         strip_gaps=True))
    elif args.ensemble:
        import tempfile
        from muscle_tpu_torch import MultiSequence
        from muscle_tpu_torch.pipeline.ensemble import run_align_command
        from muscle_tpu_torch.utils.build import build_all
        build_all()
        activities = [ProfilerActivity.CUDA]
        if args.ensemble == "48":
            n, lo, hi, seed = cs.ENSEMBLE_48
            seqs, flag = cs.synthetic_family(n, lo, hi, seed=seed), "stratified"
        else:
            seqs = MultiSequence.from_fasta(
                os.path.join(ROOT, "tests/goldens/BB11002.seq.afa"),
                strip_gaps=True)
            flag = "diversified"
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        workdir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        inp = os.path.join(workdir, "in.fa")
        seqs.write_fasta(inp)

        def ensemble(_seqs, device):
            run_align_command("align", inp, os.path.join(workdir, "out.efa"),
                              {flag: True, "device": device})
        run = ensemble
    elif args.mega:
        spec = {"8": cs.MEGA_8, "128": cs.MEGA_128,
                "long": cs.MEGA_LONG}[args.mega]
        opts["mega"], _ = cs.mega_set(*spec)
        seqs = cs.mega_seqs(opts["mega"])
        if args.mega == "long":
            opts["refine_iters"] = cs.MEGA_LONG_REFINE_ITERS
    elif args.long == "mixed":
        seqs = cs.family_of_lengths(cs.LONG_MIXED, b"ARNDCQEGHILKMFPSTWYV", 6)
        opts["refine_iters"] = cs.LONG_MIXED_REFINE_ITERS
    elif args.long == "pair":
        seqs = cs.family_of_lengths(cs.LONG_PAIR, b"ACGT", 2)
    else:
        seqs = cs.synthetic_family(args.n, args.lo, args.hi, seed=args.n)
    if not (args.super5 or args.ensemble):
        align(seqs, device="cuda", **opts)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run(seqs, device="cuda", **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=30))
    busy = busy_us(prof.events()) / 1e6
    print(f"profiled {run.__name__} wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, "
          f"idle share {1 - busy / wall:.4f}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
