#!/usr/bin/env python3
"""The size limits that the JAX package set for a 16 GB TPU, measured on
the card.

    python tools/torch_size_probe.py --peaks [--pad P] [--n FAMILY:N,...]
        [--random-refine-iters R] [--out DIR]
    python tools/torch_size_probe.py --constants [--only NAME ...] [--out DIR]
    python tools/torch_size_probe.py --bits [--out DIR]
    python tools/torch_size_probe.py --fit [--out DIR]

--peaks: `align()` of a synthetic family of n proteins whose lengths pad
to P (default 512; K 32): lengths in (the ladder rung below P, P], at
pad 512 the 400-512 the pad-512 line was fitted on. "mutated"
(chip_smoke.synthetic_family: mutated copies of one random protein,
whose store the MPC trims to its occupied slots) or "random" (unrelated
proteins: diffuse posteriors, no trim), for each (family, n) in a
process of its own (default: n = 200, 320, 440 and 600 of each), with
the store guard lifted (MUSCLE_TPU_HBM_BUDGET_GB=1000). N "max" is the
largest n the line fitted so far over this pad's saved runs admits on
this card (the guard's arithmetic, with the least available memory those
runs saw). --random-refine-iters cuts the random family's refine (its
device joins over diffuse posteriors take minutes; the default is
align()'s 100). Each run records the pad, K and pairs (of the unique
sequences) the guard was given, the
sparse store's bytes ((P+1) * L * K * 8, and as allocated, store_rows(P)
* L * K * 8), its K after the trim, the peak device memory
(max_memory_allocated and max_memory_reserved) before the store fetch
and over the whole call, the card's available memory before it, the
host's RSS before and after the store fetch and its peak (ru_maxrss),
the stage walls. Then, with the pad's line as the guard holds it
(rounded up: the slope to 4 decimals, the base to 0.1 MB), the first n
the guard refuses on this card must raise MemoryError before the pair
stage (chip_smoke.past_the_limit). --fit draws, over every run saved in the output
directory (on any machine), one line a (pad, K): of the lines through
two runs' (allocated store, reserved peak), the one that bounds every
run of that pad from above and is least at the largest store; then says
whether one line bounds every pad's runs. The MPC store guard's table
(pipeline/mpc.py, STORE_FITS) holds those lines.

--constants: each size constant of the table CONSTANTS, in a process of
its own, set to the value derived for an 80 GB card (its 16 GB value
scaled by 5, or the rung or threshold those bytes reach), every other
constant held at the JAX package's value, and every output that
chip_smoke.py gates hashed (sha256 of each alignment's text and of every
pair-stage store): the ten in-repo families, the long families (long
mixed, long pair), mega-long and mega-16k, rdrp-16 under -super5 and
diversified-BB11002 (-replicates as chip_smoke.py runs it). A first
process holds every constant at the JAX package's value; each constant's
outputs are compared with it, digest for digest. Nothing in the package
is changed: the constants are set in the child process only.

--bits: ops/nw.BITS_BUDGET (the NW trace bits of one launch, on the card
and in their host copy) at 2 GiB and at 10 GiB, in processes of their
own, in the order 2, 10, 10, 2: the outputs that reach nw_align_batch
(-protdists on BB11001 and on chip_smoke.py's 20,600 / 300 / 280
residues, -uclustpd -maxpd 1.5 and Super6 on chip_smoke.py's
synthetic-500) and -protdists on six proteins of 19,600-20,600 residues,
where the budget binds; each output's sha256, its NW launches, the
host's RSS with a launch's bits copied (above the RSS before the
output), the most bits a launch held, its wall.

Each writes its lines to the output directory (--out, default
build/size_probe: size_probe_peaks[_padP].json, size_probe_constants.json,
size_probe_bits.json, a file a run) and prints them. On the card only,
but --fit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 5          # 80 GB / 16 GB
GiB = 1 << 30

# (name, module under muscle_tpu_torch, attribute, the JAX package's
# value, the value derived for 80 GB); _clamp_chunk_by_len's budget is a
# literal of the function, set by replacing the function
CONSTANTS = (
    ("BUCKET_LADDER", "pipeline.posteriors", "BUCKET_LADDER",
     (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192,
      12288, 16384, 24576),
     (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192,
      12288, 16384, 24576, 32768, 49152)),
    ("_clamp_chunk_by_len", "pipeline.posteriors", "_clamp_chunk_by_len",
     8 * GiB, 8 * GiB * SCALE),
    ("LONG_PAIR_THRESHOLD", "pipeline.posteriors", "LONG_PAIR_THRESHOLD",
     8192, 16384),
    ("SMALL_DENSE_NL", "pipeline.posteriors", "SMALL_DENSE_NL",
     16384, 32768),
    ("_LONG_PALLAS_CELL_BUDGET", "pipeline.posteriors",
     "_LONG_PALLAS_CELL_BUDGET", 160 << 20, (160 << 20) * SCALE),
    ("_STORE_BUDGET_BYTES", "pipeline.ensemble_batch", "_STORE_BUDGET_BYTES",
     3 * GiB, 3 * GiB * SCALE),
    ("_LIST_F_BUDGET", "pipeline.devjoin", "_LIST_F_BUDGET",
     2 * GiB, 2 * GiB * SCALE),
    ("_WAVE_BYTES", "pipeline.devjoin", "_WAVE_BYTES", GiB, GiB * SCALE),
    ("BITS_BUDGET", "ops.nw", "BITS_BUDGET", 2 * GiB, 2 * GiB * SCALE),
    ("MEMORY_HEADROOM", "utils.device", "MEMORY_HEADROOM", GiB, GiB * SCALE),
)


def smoke():
    """This checkout's chip_smoke.py, for its families and runs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_sizes", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def set_constant(name: str, value) -> None:
    import importlib
    entry = next(c for c in CONSTANTS if c[0] == name)
    mod = importlib.import_module(f"muscle_tpu_torch.{entry[1]}")
    if name == "_clamp_chunk_by_len":
        def clamp(b: int, lb: int, step: int = 8) -> int:
            cap = max(step, int(value // max(1, 12 * lb * lb)))
            return max(step, min(b, mod._floor_rung(cap, step)))
        mod._clamp_chunk_by_len = clamp
    else:
        setattr(mod, entry[2], value)


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def length_range(pad: int) -> tuple[int, int]:
    """(lo, hi) residues of a --peaks family at pad `pad`: (the ladder
    rung below it, pad], so every family pads to `pad`; at pad 512 the
    400-512 of the runs the pad-512 line was fitted on."""
    from muscle_tpu_torch.pipeline import posteriors as post_mod
    ladder = post_mod.BUCKET_LADDER
    if pad not in ladder or pad > post_mod.LONG_PAIR_THRESHOLD:
        raise SystemExit(f"--pad {pad}: not a rung of the store's ladder "
                         f"up to {post_mod.LONG_PAIR_THRESHOLD}")
    if pad == 512:
        return 400, 512
    return max([r for r in ladder if r < pad], default=0) + 1, pad


def random_family(n: int, seed: int, lo: int = 400, hi: int = 512):
    """n unrelated random proteins of lo-hi residues: diffuse
    posteriors, so the store keeps its K slots (no trim) and the
    consistency its widest rows."""
    import numpy as np

    from muscle_tpu_torch import MultiSequence, Sequence
    rng = np.random.default_rng(seed)
    aas = b"ARNDCQEGHILKMFPSTWYV"
    return MultiSequence([Sequence(f"r{i}", bytes(
        aas[c] for c in rng.integers(0, 20, int(rng.integers(lo, hi + 1)))))
        for i in range(n)])


def peak_child(family: str, n: int, pad: int, refine_iters: int,
               path: str) -> int:
    import torch
    cs = smoke()
    from muscle_tpu_torch import align
    from muscle_tpu_torch.pipeline import mpc
    from muscle_tpu_torch.pipeline import posteriors as post_mod
    from muscle_tpu_torch.utils import logging as mlog
    from muscle_tpu_torch.utils.device import device_memory_bytes
    lo, hi = length_range(pad)
    seqs = (cs.synthetic_family(n, lo, hi, seed=n) if family == "mutated"
            else random_family(n, seed=n, lo=lo, hi=hi))
    fetch = post_mod.posts_from_store
    cons = mpc.consistency_sparse
    guard = mpc.store_guard
    rss = {}

    def fetch_rss(*args, **kwargs):
        torch.cuda.synchronize()
        rss["allocated_before_fetch"] = torch.cuda.max_memory_allocated()
        rss["reserved_before_fetch"] = torch.cuda.max_memory_reserved()
        rss["before_fetch"] = rss_bytes()
        out = fetch(*args, **kwargs)
        rss["after_fetch"] = rss_bytes()
        return out

    def cons_k(vals, *args, **kwargs):
        rss["k_store"] = int(vals.shape[2])
        return cons(vals, *args, **kwargs)

    def shape(n_seqs, n_pairs, pad_to, k, device):
        rss["pad"], rss["k"], rss["pairs"] = pad_to, k, n_pairs
        return guard(n_seqs, n_pairs, pad_to, k, device)

    post_mod.posts_from_store = fetch_rss
    mpc.consistency_sparse = cons_k
    mpc.store_guard = shape
    mlog.STAGE_TIMES.clear()
    total, available = device_memory_bytes("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    msa = align(seqs, device="cuda", refine_iters=refine_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rss.get("pad") != pad:
        raise SystemExit(f"{family} n = {n}: the MPC ran at pad "
                         f"{rss.get('pad')}, not {pad}")
    pairs, k = rss["pairs"], rss["k"]
    row = {"family": family, "n": n, "lengths": [lo, hi],
           **rss, "refine_iters": refine_iters,
           "store_bytes": (pairs + 1) * pad * k * 8,
           "store_alloc": post_mod.store_rows(pairs) * pad * k * 8,
           "peak_allocated": torch.cuda.max_memory_allocated(),
           "peak_reserved": torch.cuda.max_memory_reserved(),
           "total": total, "available": available,
           "rss_peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
           * 1024, "wall_s": wall, "width": msa.col_count(),
           "stages": dict(mlog.STAGE_TIMES)}
    with open(path, "w") as f:
        json.dump(row, f)
    return 0


def hashed_outputs(cs, dev) -> dict:
    """sha256 of every output chip_smoke.py gates, and of the stores of
    each run's pair stage."""
    import tempfile

    from muscle_tpu_torch import MultiSequence, align, super5
    from muscle_tpu_torch.pipeline.ensemble import run_align_command

    def text_sha(text: str) -> str:
        return hashlib.sha256(text.encode()).hexdigest()

    out = {}

    def run(name, fn):
        t0 = time.perf_counter()
        with cs.StoreHashes() as stores:
            try:
                text = fn()
            except Exception as e:    # a raise is an output that moved
                text = f"raised {type(e).__name__}: {e}"
        out[name] = {"text": text_sha(text), "stores": stores.hashes,
                     "wall_s": round(time.perf_counter() - t0, 2)}
        if text.startswith("raised"):
            out[name]["raised"] = text
        print(f"  {name}: {out[name]['text'][:16]} stores "
              f"{len(stores.hashes)} ({out[name]['wall_s']}s)", flush=True)

    for name, inp, strip, _ in cs.FAMILIES:
        seqs = MultiSequence.from_fasta(os.path.join(ROOT, inp),
                                        strip_gaps=strip)
        run(name, lambda: align(seqs, device=dev).to_fasta_text())
    for name, lengths, letters, seed, iters in (
            ("long mixed", cs.LONG_MIXED, cs.AMINO_LETTERS, 6,
             cs.LONG_MIXED_REFINE_ITERS),
            ("long pair", cs.LONG_PAIR, b"ACGT", 2, 100)):
        seqs = cs.family_of_lengths(lengths, letters, seed)
        run(name, lambda: align(seqs, device=dev,
                                refine_iters=iters).to_fasta_text())
    work = tempfile.mkdtemp(prefix="size_probe_", dir=os.path.join(
        ROOT, "build"))
    for name, spec in (("mega-long", cs.MEGA_LONG), ("mega-16k", cs.MEGA_16K)):
        ms = cs.mega_set(*spec, where=work)[0]
        run(name, lambda: align(cs.mega_seqs(ms), device=dev, mega=ms,
                                refine_iters=cs.MEGA_LONG_REFINE_ITERS)
            .to_fasta_text())
    seqs = MultiSequence.from_fasta(os.path.join(ROOT, cs.RDRP16),
                                    strip_gaps=True)
    run("rdrp-16 -super5", lambda: super5(seqs, device=dev).to_fasta_text())
    inp = os.path.join(work, "BB11002.fa")
    MultiSequence.from_fasta(os.path.join(ROOT, "tests/goldens/BB11002.seq.afa"),
                             strip_gaps=True).write_fasta(inp)
    efa = os.path.join(work, "BB11002.efa")

    def diversified():
        run_align_command("align", inp, efa, {
            "diversified": True,
            "replicates": str(cs.DIVERSIFIED_REPLICATES), "device": str(dev)})
        with open(efa) as f:
            return f.read()

    run("diversified-BB11002", diversified)
    return out


def constant_child(name: str, path: str) -> int:
    import torch
    sys.path.insert(0, ROOT)
    cs = smoke()
    for entry in CONSTANTS:
        set_constant(entry[0], entry[4] if entry[0] == name else entry[3])
    print(f"{name}: {'every constant at the JAX value' if name == 'jax' else 'at its 80 GB value'}",
          flush=True)
    out = hashed_outputs(cs, torch.device("cuda"))
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def child(args: list[str], path: str, limit: float) -> dict | None:
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__)] + args
                        + [path], cwd=ROOT, timeout=limit).returncode
    print(f"{' '.join(args)}: rc {rc}, {time.perf_counter() - t0:.1f}s",
          flush=True)
    if rc != 0 or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def envelope(rows, what: str = "") -> tuple[float, float] | None:
    """Of the lines through two rows' (allocated store, reserved peak),
    the one that bounds every row from above and is least at the largest
    store: (slope, base bytes), printed with each row against it."""
    best = None
    for i, a in enumerate(rows):
        for b in rows[i + 1:]:
            if b["store_alloc"] == a["store_alloc"]:
                continue
            slope = ((b["peak_reserved"] - a["peak_reserved"])
                     / (b["store_alloc"] - a["store_alloc"]))
            base = a["peak_reserved"] - slope * a["store_alloc"]
            if all(slope * r["store_alloc"] + base >= r["peak_reserved"] - 1
                   for r in rows):
                top = slope * max(r["store_alloc"] for r in rows) + base
                if best is None or top < best[2]:
                    best = (slope, base, top)
    if best is None:
        return None
    slope, base, _ = best
    print(f"{what}reserved peak <= {slope:.4f} * allocated store + "
          f"{base / 1e9:.4f} GB (the envelope's line over {len(rows)} runs)",
          flush=True)
    for r in sorted(rows, key=lambda r: (r["pad"], r["family"], r["n"])):
        print(f"  pad {r['pad']} {r['family']} n = {r['n']}: allocated store "
              f"{r['store_alloc'] / 1e9:.3f} GB, line "
              f"{(slope * r['store_alloc'] + base) / 1e9:.3f} GB, reserved "
              f"{r['peak_reserved'] / 1e9:.3f} GB", flush=True)
    return slope, base


def limit_n(line, pad: int, k: int, available: int) -> int:
    """The largest n whose allocated store the line admits in
    `available` bytes less the headroom (pipeline/mpc.store_guard's
    arithmetic)."""
    from muscle_tpu_torch.pipeline import posteriors as post_mod
    from muscle_tpu_torch.utils.device import MEMORY_HEADROOM
    slope, base = line
    n = 2
    while (slope * post_mod.store_rows((n + 1) * n // 2) * pad * k * 8 + base
           <= available - MEMORY_HEADROOM):
        n += 1
    return n


def saved_rows(out: str) -> list[dict]:
    """Every --peaks run saved in `out`, the latest of each (pad,
    family, n)."""
    import glob
    rows = []
    for path in sorted(glob.glob(os.path.join(out,
                                              "size_probe_peak_*_*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fit_rows(rows) -> dict:
    """One envelope a (pad, K) over `rows`, and whether one line bounds
    them all: {"lines": {"P,K": {...}}, "one_line": {...}}, printed."""
    shapes = sorted({(r["pad"], r["k"]) for r in rows})
    avail = min((r["available"] for r in rows if "available" in r),
                default=None)
    fits = {}
    for pad, k in shapes:
        mine = [r for r in rows if (r["pad"], r["k"]) == (pad, k)]
        line = envelope(mine, f"pad {pad}, K {k}: ")
        if line is None:
            print(f"pad {pad}, K {k}: {len(mine)} run(s), no line", flush=True)
            continue
        fits[f"{pad},{k}"] = {
            "pad": pad, "k": k, "per_byte": line[0], "base": line[1],
            "runs": len(mine),
            "limit_n": limit_n(line, pad, k, avail) if avail else None}
    res = {"available": avail, "lines": fits}
    if len(fits) > 1:
        line = envelope(rows, "one line over every pad: ")
        if line is not None:
            res["one_line"] = {"per_byte": line[0], "base": line[1]}
            for f in fits.values():
                own = f["limit_n"]
                one = (limit_n(line, f["pad"], f["k"], avail) if avail
                       else None)
                f["limit_n_one_line"] = one
                print(f"pad {f['pad']}, K {f['k']}: its own line admits n "
                      f"<= {own}, the one line n <= {one}", flush=True)
        for f in fits.values():
            others = [r for r in rows if (r["pad"], r["k"]) != (f["pad"],
                                                                f["k"])]
            over = [r for r in others if f["per_byte"] * r["store_alloc"]
                    + f["base"] < r["peak_reserved"] - 1]
            f["bounds_every_pad"] = not over
            print(f"pad {f['pad']}'s line bounds every other pad's runs: "
                  f"{not over}"
                  f"{'' if not over else ' (not ' + ', '.join(sorted({str(r['pad']) for r in over})) + ')'}",
                  flush=True)
    return res


def fit_saved(out: str) -> int:
    """The envelopes over every run saved in `out`, no card needed;
    written to size_probe_fit.json there."""
    rows = saved_rows(out)
    if not rows:
        return 1
    res = fit_rows(rows)
    with open(os.path.join(out, "size_probe_fit.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0 if res["lines"] else 1


def table_line(line) -> tuple[float, float]:
    """A fitted (slope, base) rounded up as pipeline/mpc.STORE_FITS
    holds it: the slope to 4 decimals, the base to 0.1 MB."""
    return math.ceil(line[0] * 1e4) / 1e4, math.ceil(line[1] / 1e5) * 1e5


def past_child(pad: int, slope: float, base: float, path: str) -> int:
    """The store guard with (slope, base) as pad `pad`'s line, on this
    card: the first n it refuses, whose align() must raise MemoryError
    before the pair stage."""
    cs = smoke()
    from muscle_tpu_torch.pipeline import mpc
    mpc.STORE_FITS[pad] = (slope, base)
    lo, hi = length_range(pad)
    n = cs.past_the_limit(pad, lo, hi, cs.past_12gb(pad), "cuda")
    with open(path, "w") as f:
        json.dump({"pad": pad, "line": [slope, base], "past_n": n}, f)
    return 0


def peak_path(out: str, family: str, n: int, pad: int) -> str:
    tail = "" if pad == 512 else f"_pad{pad}"
    return os.path.join(out, f"size_probe_peak_{family}_{n}{tail}.json")


def peaks(runs, pad: int, random_iters: int, out: str) -> int:
    os.makedirs(out, exist_ok=True)
    rows = []
    env = dict(os.environ, MUSCLE_TPU_HBM_BUDGET_GB="1000")
    for family, n in runs:
        if n == "max":
            mine = [r for r in saved_rows(out) if r["pad"] == pad
                    and r["k"] == 32 and "available" in r]
            line = envelope(mine, f"pad {pad} so far: ")
            if line is None:
                print(f"{family} n = max: no line at pad {pad} yet",
                      flush=True)
                return 1
            n = limit_n(line, pad, 32, min(r["available"] for r in mine))
            print(f"{family} n = max: {n}", flush=True)
        iters = random_iters if family == "random" else 100
        path = peak_path(out, family, n, pad)
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--peak-child", f"{family}:{n}:{pad}:{iters}",
                             path], cwd=ROOT, env=env, timeout=3000).returncode
        if rc != 0:
            print(f"{family} n = {n}: rc {rc}", flush=True)
            return 1
        with open(path) as f:
            row = json.load(f)
        rows.append(row)
        print(f"pad {row['pad']} K {row['k']} {family} n = {n} (lengths "
              f"{row['lengths']}, refine {iters}): {row['pairs']} pairs, "
              f"store {row['store_bytes'] / 1e9:.3f} GB ((P+1) rows; "
              f"{row['store_alloc'] / 1e9:.3f} GB as allocated, K "
              f"{row.get('k_store')} after the trim), available "
              f"{row['available'] / 1e9:.3f} GB, peak allocated "
              f"{row['peak_allocated'] / 1e9:.3f} GB (ratio to the "
              f"allocated store "
              f"{row['peak_allocated'] / row['store_alloc']:.3f}), reserved "
              f"{row['peak_reserved'] / 1e9:.3f} GB (before the store fetch "
              f"{row['reserved_before_fetch'] / 1e9:.3f}), host RSS before / "
              f"after the store fetch {row['before_fetch'] / 1e9:.3f} / "
              f"{row['after_fetch'] / 1e9:.3f} GB, peak "
              f"{row['rss_peak'] / 1e9:.3f} GB; wall {row['wall_s']:.2f}s "
              f"(process {time.perf_counter() - t0:.1f}s) stages "
              f"{json.dumps(row['stages'])}", flush=True)
    fit = fit_rows(saved_rows(out))
    tail = "" if pad == 512 else f"_pad{pad}"
    line = fit["lines"].get(f"{pad},32")
    past = None
    if line is not None:
        slope, base = table_line((line["per_byte"], line["base"]))
        print(f"pad {pad}'s line as the guard holds it: {slope} * S + "
              f"{base:.0f}", flush=True)
        past = child(["--past-child", f"{pad}:{slope}:{base}"],
                     os.path.join(out, f"size_probe_past{tail}.json"), 600)
    with open(os.path.join(out, f"size_probe_peaks{tail}.json"), "w") as f:
        json.dump({"card": card_line(), "rows": rows, "fit": fit,
                   "past": past}, f, indent=1)
    return 0 if past is not None else 1


BIT_BUDGETS = (2 * GiB, 10 * GiB, 10 * GiB, 2 * GiB)
SUPER6_MAX_PD = 1.5
# -protdists on six mutated copies of one protein of these lengths: every
# pair pads to 20,608 columns (424.7 MB of bits a pair), so 2 GiB holds
# 5 pairs a launch and 10 GiB all 15
BITS_LONG = (20600, 20400, 20200, 20000, 19800, 19600)


def bits_child(budget: int, path: str) -> int:
    """The outputs that reach nw_align_batch under BITS_BUDGET =
    `budget`: sha256, NW launches, the host RSS with a launch's bits
    copied, the most bits a launch held, wall."""
    import tempfile

    import torch
    cs = smoke()
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.cli import main as cli_main
    from muscle_tpu_torch.ops import dp_cuda, nw
    from muscle_tpu_torch.pipeline.ensemble import run_align_command
    nw.BITS_BUDGET = budget
    launch, walk = nw.nw_viterbi_batch, nw._traceback
    seen = {"bits": 0, "copied": False, "rss": []}

    def counted(*args, **kwargs):
        bits, final, scores = launch(*args, **kwargs)
        seen["bits"] = max(seen["bits"], bits.numel() * bits.element_size())
        seen["copied"] = True
        return bits, final, scores

    def first_walk(*args, **kwargs):
        # the first path walk after a launch: its bits are on the host
        if seen["copied"]:
            seen["rss"].append(rss_bytes())
            seen["copied"] = False
        return walk(*args, **kwargs)

    nw.nw_viterbi_batch, nw._traceback = counted, first_walk
    work = tempfile.mkdtemp(prefix="size_probe_bits_",
                            dir=os.path.join(ROOT, "build"))
    files = {}
    for name, seqs in (("wide", cs.protdists_wide_set()),
                       ("long", cs.family_of_lengths(
                           BITS_LONG, cs.AMINO_LETTERS, 20600)),
                       ("synthetic-500", MultiSequence(
                           list(cs.super5_set())[:cs.SUPER6_ROWS]))):
        files[name] = os.path.join(work, f"{name}.fa")
        seqs.write_fasta(files[name])
    golden = os.path.join(ROOT, cs.FAMILIES[0][1])
    cases = (
        ("-protdists BB11001", lambda o: cli_main(
            ["-protdists", golden, "-output", o])),
        ("-protdists 20,600 / 300 / 280", lambda o: cli_main(
            ["-protdists", files["wide"], "-output", o])),
        ("-uclustpd synthetic-500", lambda o: cli_main(
            ["-uclustpd", files["synthetic-500"], "-maxpd",
             str(SUPER6_MAX_PD), "-tsvout", o])),
        ("-super6 synthetic-500", lambda o: run_align_command(
            "super6", files["synthetic-500"], o, {})),
        ("-protdists 6 x 19,600-20,600", lambda o: cli_main(
            ["-protdists", files["long"], "-output", o])),
    )
    res = {}
    for i, (name, run) in enumerate(cases):
        out = os.path.join(work, f"out{i}")
        dp_cuda.reset_launches()
        seen.update(bits=0, copied=False, rss=[])
        rss0 = rss_bytes()
        t0 = time.perf_counter()
        run(out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        res[name] = {"sha256": sha, "launches": dp_cuda.LAUNCHES["nw_viterbi"],
                     "bits_max": seen["bits"],
                     "rss_launch": max(seen["rss"], default=rss0) - rss0,
                     "wall_s": wall}
        print(f"  {name}: {sha[:16]} NW launches "
              f"{res[name]['launches']}, bits a launch <= "
              f"{seen['bits'] / 1e9:.3f} GB, host RSS with a launch's bits "
              f"+{res[name]['rss_launch'] / 1e9:.3f} GB, wall {wall:.2f}s",
              flush=True)
    res["rss_peak"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    with open(path, "w") as f:
        json.dump(res, f)
    return 0


def bits(out: str) -> int:
    os.makedirs(out, exist_ok=True)
    runs = []
    for i, budget in enumerate(BIT_BUDGETS):
        print(f"BITS_BUDGET {budget / GiB:.0f} GiB:", flush=True)
        got = child(["--bits-child", str(budget)], os.path.join(
            out, f"size_probe_bits_{i}.json"), 1200)
        if got is None:
            return 1
        runs.append((budget, got))
    names = [k for k in runs[0][1] if k != "rss_peak"]
    equal = {k: len({g[k]["sha256"] for _, g in runs}) == 1 for k in names}
    table = {}
    for k in names:
        by = {}
        for budget, g in runs:
            by.setdefault(budget, []).append(g[k])
        table[k] = {f"{b // GiB} GiB": {
            "launches": [r["launches"] for r in v],
            "wall_s": [round(r["wall_s"], 3) for r in v],
            "rss_launch_gb": [round(r["rss_launch"] / 1e9, 3) for r in v],
            "bits_max_gb": [round(r["bits_max"] / 1e9, 3) for r in v]}
            for b, v in by.items()}
        table[k]["equal"] = equal[k]
        print(f"{k}: outputs equal under both budgets: {equal[k]}; "
              f"{json.dumps({b: v for b, v in table[k].items() if b != 'equal'})}",
              flush=True)
    with open(os.path.join(out, "size_probe_bits.json"), "w") as f:
        json.dump({"card": card_line(), "table": table,
                   "rss_peak": [g["rss_peak"] for _, g in runs]}, f, indent=1)
    return 0 if all(equal.values()) else 1


def constants(only, out: str) -> int:
    os.makedirs(out, exist_ok=True)
    names = ["jax"] + [c[0] for c in CONSTANTS
                       if not only or c[0] in only]
    res = {}
    for name in names:
        res[name] = child(["--const-child", name], os.path.join(
            out, f"size_probe_const_{name}.json"), 1500)
    base = res["jax"]
    if base is None:
        print("the run at the JAX values failed", flush=True)
        return 1
    table = {}
    for name in names[1:]:
        got = res[name]
        if got is None:
            table[name] = {"moved": ["the process failed"]}
        else:
            moved = [k for k in base if got.get(k) is None
                     or got[k]["text"] != base[k]["text"]
                     or got[k]["stores"] != base[k]["stores"]]
            table[name] = {"moved": moved,
                           "raised": {k: v["raised"] for k, v in got.items()
                                      if "raised" in v}}
        entry = next(c for c in CONSTANTS if c[0] == name)
        print(f"{name} ({entry[1]}.{entry[2]}: {entry[3]} -> {entry[4]}): "
              f"{'no gated output moved' if not table[name]['moved'] else 'moved ' + ', '.join(table[name]['moved'])}"
              f"{'; raised ' + json.dumps(table[name].get('raised')) if table[name].get('raised') else ''}",
              flush=True)
    with open(os.path.join(out, "size_probe_constants.json"), "w") as f:
        json.dump({"card": card_line(), "base": base, "table": table,
                   "runs": res}, f, indent=1)
    return 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--peak-child":
        sys.path.insert(0, ROOT)
        family, n, pad, iters = sys.argv[2].split(":")
        return peak_child(family, int(n), int(pad), int(iters), sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--past-child":
        sys.path.insert(0, ROOT)
        pad, slope, base = sys.argv[2].split(":")
        return past_child(int(pad), float(slope), float(base), sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--const-child":
        return constant_child(sys.argv[2], sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--bits-child":
        sys.path.insert(0, ROOT)
        return bits_child(int(sys.argv[2]), sys.argv[3])
    ap = argparse.ArgumentParser()
    ap.add_argument("--peaks", action="store_true")
    ap.add_argument("--pad", type=int, default=512)
    ap.add_argument("--n", default="mutated:200,mutated:320,mutated:440,"
                    "mutated:600,random:200,random:320,random:440,"
                    "random:600")
    ap.add_argument("--random-refine-iters", type=int, default=100)
    ap.add_argument("--constants", action="store_true")
    ap.add_argument("--bits", action="store_true")
    ap.add_argument("--fit", action="store_true",
                    help="the envelopes over the runs saved in --out")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "size_probe"))
    ap.add_argument("--only", action="append")
    opts = ap.parse_args()
    sys.path.insert(0, ROOT)
    if opts.fit:
        return fit_saved(opts.out)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    from muscle_tpu_torch.utils.build import build_all
    t0 = time.perf_counter()
    build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    rc = 0
    if opts.bits:
        rc |= bits(opts.out)
    if opts.peaks:
        length_range(opts.pad)
        runs = []
        for v in opts.n.split(","):
            family, n = v.split(":")
            runs.append((family, n if n == "max" else int(n)))
        rc |= peaks(runs, opts.pad, opts.random_refine_iters, opts.out)
    if opts.constants:
        rc |= constants(opts.only, opts.out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
