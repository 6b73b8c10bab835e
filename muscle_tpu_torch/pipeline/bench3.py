"""Muscle3 benchmark sweeps: -bench, -bench_blosums, -sweep, -spatter.

Host copy of muscle_tpu.pipeline.bench3 (numpy only).

reference: src/bench.{h,cpp} (Bench over a directory of reference MSAs,
mean Q/TC via Muscle3 + QScorer), src/cmd_bench.cpp (cmd_bench /
cmd_bench_blosums), src/sweep.cpp (grid sweep over gapopen/center),
src/spatter.cpp + src/sweeper.cpp (iterative shrink random search).

These are developer/benchmark tools (SURVEY §2.9): each reference MSA
file doubles as its own input (loaded gap-stripped), is re-aligned with
the classic Muscle3 profile aligner under the given parameters, and
scored against itself-as-reference with the Q/TC scorer.

Note on -bench_blosums: the reference's M3AlnParams::SetBlosum calls
GetSubstMx_Letter_Blosum(PctId), which ships only the BLOSUM62 matrix
and Die()s for 90/80/70 (src/blosum.cpp:33-48) — cmd_bench_blosums is
broken as shipped. Here every pct uses the BLOSUM62 scores with that
family's gap-parameter sets (GetGapParams_Blosum tables), so the full
6x4x4 loop actually runs.
"""

from __future__ import annotations

import os

import numpy as np

from ..qscore import qscore
from ..sequence import MultiSequence
from .muscle3 import GAP_PARAMS_BLOSUM, M3Params, Muscle3


class Bench3:
    """reference: class Bench (src/bench.h)."""

    def __init__(self):
        self.names: list[str] = []
        self.refs: list[MultiSequence] = []
        self.inputs: list[MultiSequence] = []
        self.mean_q = 0.0
        self.mean_tc = 0.0
        self.tcs: list[float] = []

    @classmethod
    def load(cls, names_file: str, ref_dir: str) -> "Bench3":
        """Each listed file under ref_dir is both the reference MSA and
        (gap-stripped) the input (reference: Bench::Load
        src/bench.cpp:63-90)."""
        b = cls()
        with open(names_file) as f:
            b.names = [ln.strip() for ln in f if ln.strip()]
        for name in b.names:
            path = os.path.join(ref_dir, name)
            b.refs.append(MultiSequence.from_fasta(path))
            b.inputs.append(MultiSequence.from_fasta(path, strip_gaps=True))
        return b

    def from_sample(self, other: "Bench3", pct: int,
                    rng: np.random.Generator) -> None:
        """Random subset of ~pct% of another bench's cases (reference:
        Bench::FromSample src/bench.cpp:106-131)."""
        count = max(1, (len(other.names) * pct) // 100)
        order = rng.permutation(len(other.names))[:count]
        for k in order:
            self.names.append(other.names[k])
            self.refs.append(other.refs[k])
            self.inputs.append(other.inputs[k])

    def run(self, params: M3Params) -> float:
        """Mean Q/TC of Muscle3 under `params` over all cases
        (reference: Bench::Run src/bench.cpp:133-210)."""
        sum_q = sum_tc = 0.0
        self.tcs = []
        for inp, ref in zip(self.inputs, self.refs):
            m3 = Muscle3(params=params)
            test = m3.run(inp)
            q, tc = qscore(test, ref)
            sum_q += q
            sum_tc += tc
            self.tcs.append(tc)
        n = max(1, len(self.inputs))
        self.mean_q = sum_q / n
        self.mean_tc = sum_tc / n
        return self.mean_tc

    def tcs_to_file(self, path: str | None) -> None:
        if not path:
            return
        with open(path, "w") as f:
            for name, tc in zip(self.names, self.tcs):
                f.write(f"{name}\t{tc:.4f}\n")


def _params_from_opts(opts: dict, gap_open=None, center=None) -> M3Params:
    """M3AlnParams::SetFromCmdLine equivalent for the bench tools."""
    return M3Params(
        pctid=int(opts.get("blosumpct", 62)),
        param_group=int(opts.get("paramset", 0)),
        gap_open=gap_open if gap_open is not None
        else (float(opts["gapopen"]) if opts.get("gapopen") else None),
        center=center if center is not None
        else (float(opts["center"]) if opts.get("center") else None),
        perturb_seed=int(opts.get("perturb", 0) or 0),
        tree_iters=int(opts.get("treeiters", 1)))


def run_bench(names_file: str, opts: dict) -> tuple[float, float, int]:
    """-bench (reference: cmd_bench src/cmd_bench.cpp:5-26)."""
    ref_dir = str(opts.get("refdir", "."))
    b = Bench3.load(names_file, ref_dir)
    params = _params_from_opts(opts)
    b.run(params)
    b.tcs_to_file(opts.get("tsvout"))
    return b.mean_q, b.mean_tc, len(b.inputs)


def run_bench_blosums(names_file: str, opts: dict, out=print):
    """-bench_blosums: 6 perturb seeds x 4 BLOSUM families x 4 param
    sets (reference: cmd_bench_blosums src/cmd_bench.cpp:28-96)."""
    ref_dir = str(opts.get("refdir", "."))
    b = Bench3.load(names_file, ref_dir)
    rows = []
    for perturb_seed in range(6):
        delta = 0.05 * perturb_seed
        for pctid in (90, 80, 70, 62):
            for group in range(4):
                params = M3Params(
                    pctid=pctid, param_group=group,
                    perturb_seed=perturb_seed,
                    perturb_substmx_delta=delta,
                    perturb_gap_delta=delta,
                    perturb_distmx_delta=delta)
                b.run(params)
                out(f"BLOSUM{pctid}:{group} perturb={perturb_seed} "
                    f"delta={delta:7.3g} AvgQ={b.mean_q:.4f} "
                    f"AvgTC={b.mean_tc:.4f} N={len(b.inputs)}")
                rows.append((pctid, group, b.mean_q, b.mean_tc,
                             perturb_seed, delta))
    if opts.get("tsvout"):
        with open(str(opts["tsvout"]), "w") as f:
            f.write("BLOSUM\tParamSet\tQ\tTC\tPerturbSeed\tDelta\n")
            for r in rows:
                f.write("%u\t%u\t%.4f\t%.4f\t%u\t%.3f\n" % r)
    return rows


def parse_grid_spec(spec: str):
    """'name,good,lo,hi,n/name,good,lo,hi,n' (reference: ParseGridSpec
    src/sweep.cpp:69-119; good='-' in the first field disables goods)."""
    names, goods, los, his, sizes = [], [], [], [], []
    do_goods = True
    for i, field in enumerate(spec.split("/")):
        parts = field.split(",")
        if len(parts) != 5:
            raise SystemExit(f"bad gridspec field {field!r}")
        name, good, lo, hi, size = parts
        if i == 0 and good == "-":
            do_goods = False
        if do_goods:
            goods.append(float(good))
        lo, hi, size = float(lo), float(hi), int(size)
        if size <= 1 or lo == hi:
            raise SystemExit(f"bad gridspec field {field!r}")
        names.append(name)
        los.append(min(lo, hi))
        his.append(max(lo, hi))
        sizes.append(size)
    return names, goods, los, his, sizes


def _apply_point(names, values, opts) -> M3Params:
    gap_open = center = None
    for name, v in zip(names, values):
        if name == "gapopen":
            gap_open = float(v)
        elif name == "center":
            center = float(v)
        else:
            raise SystemExit(f"sweep: bad param {name!r}")
    return _params_from_opts(opts, gap_open=gap_open, center=center)


def run_sweep(names_file: str, opts: dict, out=print):
    """-sweep: full grid over the gridspec params, best by TC
    (reference: cmd_sweep src/sweep.cpp:121-170 + Sweeper::ExploreGrid).
    """
    if not opts.get("gridspec"):
        raise SystemExit("-sweep requires -gridspec")
    names, _goods, los, his, sizes = parse_grid_spec(str(opts["gridspec"]))
    ref_dir = str(opts.get("refdir", "."))
    b = Bench3.load(names_file, ref_dir)

    best = (-1.0, -1.0, -1.0, None)   # (score=TC, q, tc, values)
    coords = [0] * len(names)
    total = int(np.prod(sizes))
    results = []
    for counter in range(total):
        values = [lo + (hi - lo) * c / (n - 1)
                  for lo, hi, n, c in zip(los, his, sizes, coords)]
        b.run(_apply_point(names, values, opts))
        results.append((values, b.mean_q, b.mean_tc))
        if b.mean_tc > best[0]:
            best = (b.mean_tc, b.mean_q, b.mean_tc, list(values))
            tag = " <<"
        else:
            tag = ""
        out("  ".join(f"{n}={v:8.4g}" for n, v in zip(names, values))
            + f"  Q={b.mean_q:6.4f} TC={b.mean_tc:6.4f}"
            + f" ({100.0 * (counter + 1) / total:.2f}%)" + tag)
        # odometer increment
        for d in range(len(coords) - 1, -1, -1):
            coords[d] += 1
            if coords[d] < sizes[d]:
                break
            coords[d] = 0
    out(f"best: " + " ".join(
        f"{n}={v:.4g}" for n, v in zip(names, best[3] or []))
        + f" Q={best[1]:.4f} TC={best[2]:.4f}")
    return results, best


def run_spatter(names_file: str, opts: dict, out=print):
    """-spatter: iterative random search — sample around the incumbent
    with per-param deltas, shrink deltas when an iteration fails to
    improve (reference: cmd_spatter src/spatter.cpp:99-180 +
    Sweeper::ExploreSpatter/SpatterIter src/sweeper.cpp)."""
    for req in ("warmup_pct", "maxiters", "maxfailiters", "triesperiter",
                "shrink", "gridspec"):
        if not opts.get(req):
            raise SystemExit(f"-spatter requires -{req}")
    names, goods, los, his, sizes = parse_grid_spec(str(opts["gridspec"]))
    if len(goods) != len(names):
        raise SystemExit("-spatter gridspec needs good values")
    ref_dir = str(opts.get("refdir", "."))
    full = Bench3.load(names_file, ref_dir)
    rng = np.random.default_rng(int(opts.get("randseed", 1)))

    warm = Bench3()
    warm.from_sample(full, int(opts["warmup_pct"]), rng)

    max_iters = int(opts["maxiters"])
    max_fail = int(opts["maxfailiters"])
    tries = int(opts["triesperiter"])
    shrink = float(opts["shrink"])

    deltas = [(hi - lo) / (n - 1) for lo, hi, n in zip(los, his, sizes)]
    center_values = list(goods)
    warm.run(_apply_point(names, center_values, opts))
    best = (warm.mean_tc, list(center_values))
    out("start " + " ".join(f"{n}={v:.4g}" for n, v in
                            zip(names, center_values))
        + f" TC={best[0]:.4f}")

    fail_iters = 0
    for it in range(max_iters):
        improved = False
        for _ in range(tries):
            values = [
                float(np.clip(c + rng.uniform(-d, d), lo, hi))
                for c, d, lo, hi in zip(best[1], deltas, los, his)]
            warm.run(_apply_point(names, values, opts))
            if warm.mean_tc > best[0]:
                best = (warm.mean_tc, values)
                improved = True
                out(f"iter {it} " + " ".join(
                    f"{n}={v:.4g}" for n, v in zip(names, values))
                    + f" TC={best[0]:.4f} <<")
        if improved:
            fail_iters = 0
        else:
            fail_iters += 1
            deltas = [d * shrink for d in deltas]
            if fail_iters >= max_fail:
                break
    # final score of the incumbent on the full bench
    full.run(_apply_point(names, best[1], opts))
    out("final " + " ".join(f"{n}={v:.4g}" for n, v in
                            zip(names, best[1]))
        + f" AvgQ={full.mean_q:.4f} AvgTC={full.mean_tc:.4f}"
        + f" N={len(full.inputs)}")
    return best, (full.mean_q, full.mean_tc)
