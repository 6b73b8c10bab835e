#!/usr/bin/env python3
"""The size limits that the JAX package set for a 16 GB TPU, measured on
the card.

    python tools/torch_size_probe.py --peaks [--n FAMILY:N,...] [--out DIR]
    python tools/torch_size_probe.py --constants [--only NAME ...] [--out DIR]
    python tools/torch_size_probe.py --fit [--out DIR]

--peaks: `align()` of a synthetic family of n proteins of 400-512
residues (pad 512, K 32), "mutated" (chip_smoke.synthetic_family:
mutated copies of one random protein, whose store the MPC trims to its
occupied slots) or "random" (unrelated proteins: diffuse posteriors, no
trim), for each (family, n) in a process of its own (default: n = 200,
320, 440 and 600 of each), with the store guard lifted
(MUSCLE_TPU_HBM_BUDGET_GB=1000): the sparse store's bytes ((P+1) * L *
K * 8, and as allocated, store_rows(P) * L * K * 8), its K after the
trim, the peak device memory (max_memory_allocated and
max_memory_reserved), the host's RSS before and after the store fetch and
its peak (ru_maxrss), the stage walls; then the line through two points
that bounds every reserved peak from above and is least at the largest
store. --fit draws that line over every (family, n) run saved in the
output directory, on any machine. The MPC store guard's fit (pipeline/mpc.py,
STORE_PEAK_*) is that line.

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

Both write their lines to the output directory (--out, default
build/size_probe: size_probe_peaks.json, size_probe_constants.json, a
file a run) and print them. On the card only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
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


def random_family(n: int, seed: int):
    """n unrelated random proteins of 400-512 residues: diffuse
    posteriors, so the store keeps its K slots (no trim) and the
    consistency its widest rows."""
    import numpy as np

    from muscle_tpu_torch import MultiSequence, Sequence
    rng = np.random.default_rng(seed)
    aas = b"ARNDCQEGHILKMFPSTWYV"
    return MultiSequence([Sequence(f"r{i}", bytes(
        aas[c] for c in rng.integers(0, 20, int(rng.integers(400, 513)))))
        for i in range(n)])


def peak_child(family: str, n: int, path: str) -> int:
    import torch
    cs = smoke()
    from muscle_tpu_torch import align
    from muscle_tpu_torch.pipeline import mpc
    from muscle_tpu_torch.pipeline import posteriors as post_mod
    from muscle_tpu_torch.utils import logging as mlog
    seqs = (cs.synthetic_family(n, 400, 512, seed=n) if family == "mutated"
            else random_family(n, seed=n))
    fetch = post_mod.posts_from_store
    cons = mpc.consistency_sparse
    rss = {}

    def fetch_rss(*args, **kwargs):
        rss["before_fetch"] = rss_bytes()
        out = fetch(*args, **kwargs)
        rss["after_fetch"] = rss_bytes()
        return out

    def cons_k(vals, *args, **kwargs):
        rss["k_store"] = int(vals.shape[2])
        return cons(vals, *args, **kwargs)

    post_mod.posts_from_store = fetch_rss
    mpc.consistency_sparse = cons_k
    mlog.STAGE_TIMES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    msa = align(seqs, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pairs = n * (n - 1) // 2
    row = {"family": family, "n": n, "pairs": pairs, "pad": 512, "k": 32,
           "store_bytes": (pairs + 1) * 512 * 32 * 8,
           "store_alloc": post_mod.store_rows(pairs) * 512 * 32 * 8,
           "peak_allocated": torch.cuda.max_memory_allocated(),
           "peak_reserved": torch.cuda.max_memory_reserved(),
           "total": torch.cuda.mem_get_info()[1],
           "rss_peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
           * 1024, **rss, "wall_s": wall, "width": msa.col_count(),
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


def envelope(rows) -> tuple[float, float] | None:
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
    print(f"reserved peak <= {slope:.4f} * allocated store + "
          f"{base / 1e9:.4f} GB (the envelope's line over {len(rows)} runs)",
          flush=True)
    for r in sorted(rows, key=lambda r: (r["family"], r["n"])):
        print(f"  {r['family']} n = {r['n']}: allocated store "
              f"{r['store_alloc'] / 1e9:.3f} GB, line "
              f"{(slope * r['store_alloc'] + base) / 1e9:.3f} GB, reserved "
              f"{r['peak_reserved'] / 1e9:.3f} GB", flush=True)
    return slope, base


def fit_saved(out: str) -> int:
    """The envelope over every run saved in `out` (one file a (family,
    n): the latest run of each), no card needed."""
    import glob
    rows = []
    for path in sorted(glob.glob(os.path.join(out,
                                              "size_probe_peak_*_*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return 0 if rows and envelope(rows) else 1


def peaks(runs, out: str) -> int:
    os.makedirs(out, exist_ok=True)
    rows = []
    env = dict(os.environ, MUSCLE_TPU_HBM_BUDGET_GB="1000")
    for family, n in runs:
        path = os.path.join(out, f"size_probe_peak_{family}_{n}.json")
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--peak-child", f"{family}:{n}", path], cwd=ROOT,
                            env=env, timeout=900).returncode
        if rc != 0:
            print(f"{family} n = {n}: rc {rc}", flush=True)
            return 1
        with open(path) as f:
            row = json.load(f)
        rows.append(row)
        print(f"{family} n = {n}: {row['pairs']} pairs, store "
              f"{row['store_bytes'] / 1e9:.3f} GB ((P+1) rows; "
              f"{row['store_alloc'] / 1e9:.3f} GB as allocated, K "
              f"{row.get('k_store')} after the trim), peak allocated "
              f"{row['peak_allocated'] / 1e9:.3f} GB (ratio to the "
              f"allocated store "
              f"{row['peak_allocated'] / row['store_alloc']:.3f}), reserved "
              f"{row['peak_reserved'] / 1e9:.3f} GB, host RSS before / after "
              f"the store fetch {row.get('before_fetch', 0) / 1e9:.3f} / "
              f"{row.get('after_fetch', 0) / 1e9:.3f} GB, peak "
              f"{row['rss_peak'] / 1e9:.3f} GB; wall {row['wall_s']:.2f}s "
              f"(process {time.perf_counter() - t0:.1f}s) stages "
              f"{json.dumps(row['stages'])}", flush=True)
    envelope(rows)
    with open(os.path.join(out, "size_probe_peaks.json"), "w") as f:
        json.dump({"card": card_line(), "rows": rows}, f, indent=1)
    return 0


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
        family, n = sys.argv[2].split(":")
        return peak_child(family, int(n), sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--const-child":
        return constant_child(sys.argv[2], sys.argv[3])
    ap = argparse.ArgumentParser()
    ap.add_argument("--peaks", action="store_true")
    ap.add_argument("--n", default="mutated:200,mutated:320,mutated:440,"
                    "mutated:600,random:200,random:320,random:440,"
                    "random:600")
    ap.add_argument("--constants", action="store_true")
    ap.add_argument("--fit", action="store_true",
                    help="the envelope over the runs saved in --out")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "size_probe"))
    ap.add_argument("--only", action="append")
    opts = ap.parse_args()
    if opts.fit:
        return fit_saved(opts.out)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    sys.path.insert(0, ROOT)
    from muscle_tpu_torch.utils.build import build_all
    t0 = time.perf_counter()
    build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    rc = 0
    if opts.peaks:
        rc |= peaks([(v.split(":")[0], int(v.split(":")[1]))
                     for v in opts.n.split(",")], opts.out)
    if opts.constants:
        rc |= constants(opts.only, opts.out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
