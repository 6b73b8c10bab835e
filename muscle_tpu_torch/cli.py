"""Command-line interface (-align, -super5), muscle-flag-compatible.

    python -m muscle_tpu_torch.cli -align seqs.fa -output aln.afa [-device cuda|cpu]
    python -m muscle_tpu_torch.cli -align chains.mega -output aln.afa [-device cuda|cpu]
    python -m muscle_tpu_torch.cli -super5 seqs.fa -output aln.afa [-device cuda|cpu]

Mirrors the reference's single-dash command style (reference:
src/main.cpp:55-73, src/usage.txt) and muscle_tpu.cli for the options
below; each command computes one replicate. `-align -minsuper N`
switches to Super5 when the input has N or more sequences (reference:
src/align.cpp:61-70). An input that starts with the `mega` header, or
any input with -mega, is read as Muscle-3D structure profiles
(reference: LoadInput, src/loadinput.cpp:3-13); -align then takes its
emissions from the profiles.
"""

from __future__ import annotations

import sys

USAGE = """\
muscle_tpu_torch — multiple sequence alignment on the GPU (MUSCLE v5)

  -align FILE        Align FASTA or .mega profiles (MPC algorithm) -> -output
  -super5 FILE       Align a large FASTA set (Super5 algorithm) -> -output
  -minsuper N        With -align: use Super5 when there are >= N sequences
  -output FILE       Output path ('@' expands to <perm>.<perturb seed>)
  -perm none|abc|acb|bca   Guide-tree permutation
  -perturb N         HMM perturbation seed
  -consiters N       Consistency iterations (default 2)
  -refineiters N     Refinement iterations (default 100)
  -nt / -amino       Force alphabet (default: guess)
  -mega              Read the input as .mega structure profiles
  -device cuda|cpu   Where the pair-HMM and consistency run (default cuda)
  -quiet / -log FILE
"""

_BOOL_OPTS = {"nt", "amino", "mega", "quiet", "help", "version"}
_VALUE_OPTS = {"output", "perm", "perturb", "consiters", "refineiters",
               "device", "log", "minsuper"}
_COMMANDS = ("align", "super5")


def parse_args(argv: list[str]) -> tuple[str | None, str | None, dict]:
    """-> (command or None, its input path, {option: value})."""
    cmd = path = None
    opts: dict[str, object] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            raise SystemExit(f"unexpected argument {a!r}")
        name = a.lstrip("-")
        if name in _COMMANDS:
            if i + 1 >= len(argv) or argv[i + 1].startswith("-"):
                raise SystemExit(f"-{name} requires an input file")
            if cmd is not None:
                raise SystemExit(f"-{cmd} and -{name} both given")
            cmd, path = name, argv[i + 1]
            i += 1
        elif name in _BOOL_OPTS:
            opts[name] = True
        elif name in _VALUE_OPTS:
            if i + 1 >= len(argv):
                raise SystemExit(f"option -{name} requires a value")
            opts[name] = argv[i + 1]
            i += 1
        else:
            raise SystemExit(f"unknown option -{name}")
        i += 1
    return cmd, path, opts


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd, path, opts = parse_args(argv)
    if opts.get("help") or path is None:
        print(USAGE)
        return 0 if opts.get("help") or not argv else 1
    if opts.get("version"):
        from . import __version__
        print(f"muscle_tpu_torch {__version__}")
        return 0
    out = opts.get("output")
    if not out:
        raise SystemExit("must set -output")

    from .pipeline.ensemble import load_input
    from .pipeline.mpc import (DEFAULT_CONSISTENCY_ITERS,
                               DEFAULT_REFINE_ITERS, align)
    from .pipeline.super5 import super5
    from .utils import logging as mlog
    mlog.configure(log_path=opts.get("log"), quiet=bool(opts.get("quiet")))
    mlog.log("muscle_tpu_torch %s", " ".join(argv))
    seqs, mega = load_input(path, force_mega=bool(opts.get("mega")))
    nucleo = True if opts.get("nt") else (False if opts.get("amino") else None)
    seed = int(opts.get("perturb", 0) or 0)
    perm = str(opts.get("perm", "none") or "none")
    if "@" in out:
        pos = out.index("@")
        out = f"{out[:pos]}{perm}.{seed}{out[pos + 1:]}"
    iters = dict(consistency_iters=int(opts.get("consiters",
                                                DEFAULT_CONSISTENCY_ITERS)),
                 refine_iters=int(opts.get("refineiters",
                                           DEFAULT_REFINE_ITERS)))
    minsuper = int(opts.get("minsuper", 0) or 0)
    if cmd == "super5" or (minsuper and len(seqs) >= minsuper):
        # the JAX package's switch (pipeline/ensemble.py)
        msa = super5(seqs, nucleo=nucleo, perturb_seed=seed, tree_perm=perm,
                     device=opts.get("device"), **iters)
    else:
        msa = align(seqs, nucleo=nucleo, perturb_seed=seed, tree_perm=perm,
                    device=opts.get("device"), mega=mega, **iters)
    msa.write_fasta(out)
    mlog.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
