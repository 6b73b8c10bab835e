"""Command-line interface, muscle-flag-compatible.

    python -m muscle_tpu_torch.cli -align seqs.fa -output aln.afa [-device cuda|cpu]
    python -m muscle_tpu_torch.cli -align seqs.fa -stratified -output ens.efa
    python -m muscle_tpu_torch.cli -align chains.mega -output aln.afa
    python -m muscle_tpu_torch.cli -super5 seqs.fa -output aln.afa
    python -m muscle_tpu_torch.cli -super6 seqs.fa -output aln.afa
    python -m muscle_tpu_torch.cli -super7 chains.mega -output aln.afa
    python -m muscle_tpu_torch.cli -uclustpd seqs.fa -maxpd 1.5 -tsvout c.tsv
    python -m muscle_tpu_torch.cli -protdists seqs.fa -output d.tsv
    python -m muscle_tpu_torch.cli -maxcc ens.efa -output best.afa
    python -m muscle_tpu_torch.cli -qscore test.afa -ref ref.afa
    python -m muscle_tpu_torch.cli -eadistmx seqs.fa -output ea.tsv
    python -m muscle_tpu_torch.cli -testfb seqs.fa
    python -m muscle_tpu_torch.cli -muscle3 seqs.fa -output aln.afa

Mirrors the reference's single-dash command style (reference:
src/main.cpp:55-73, src/usage.txt) and muscle_tpu.cli for the commands
below. -align, -super5, -super6 and -super7 go through
pipeline/ensemble.run_align_command:
one replicate, or an ensemble (-stratified, -diversified, -replicates
N) written as one EFA or, with '@' in -output, one file a replicate.
`-align -minsuper N` switches to Super5 when the input has N or more
sequences (reference: src/align.cpp:61-70). An input that starts with
the `mega` header, or any input with -mega, is read as Muscle-3D
structure profiles (reference: LoadInput, src/loadinput.cpp:3-13). The
pair-HMM, the consistency and the NW / SW DP scans (-super6,
-uclustpd, -protdists; -super7, -swdistmx) run on the card unless
-device cpu is given, and so do the pair-HMM EAs of -eesort, -eadistmx,
-uclust and -transaln and -testfb's forward and backward (kernels A and
3K). The other commands are host code, as in muscle_tpu: the EFA and
MSA tools, -shrub, -muscle3 and its ensembles and sweeps (-m3ensemble,
-m3select, -m3refine, -bench, -bench_blosums, -sweep, -spatter), the
MASM tools, -kmerdist, -upgma5, -derep, -hmmdump and -perturbhmm.
Options are parsed as muscle_tpu.cli parses them, and unused ones are
warned about after the command in the same words. Every command of
muscle_tpu.cli has its handler here; -guide_tree, which muscle_tpu
parses but does not handle, stops with "unknown command" as there.

Under a launcher (WORLD_SIZE > 1), one process a card:

    python -m torch.distributed.run --nproc-per-node W \
        -m muscle_tpu_torch.cli -align seqs.fa -output aln.afa

every rank joins the process group (parallel/mesh.py: NCCL on
cuda:LOCAL_RANK, or gloo with -device cpu), the pair stage and the
consistency are sharded over the ranks, and every rank runs the host
stages; rank 0 alone writes -output, the other output files and the
log, and prints.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile

from .sequence import MultiSequence

USAGE = """\
muscle_tpu_torch — multiple sequence alignment on the GPU (MUSCLE v5)

Commands:
  -align FILE        Align FASTA or .mega profiles (MPC algorithm) -> -output
  -super5 FILE       Align a large FASTA set (Super5 algorithm) -> -output
  -super6 FILE       Align a large protein set (Super6, ML-distance
                     clusters) -> -output
  -super7 FILE       Align a large set by shrubs of a guide tree (Super7;
                     FASTA or .mega) -> -output
  -uclustpd FILE     Cluster by ML protein distance (-maxpd) -> -tsvout
  -protdists FILE    All-pairs ML protein distances -> -output
  -shrub TREE        Shrubs of <= -n leaves of a Newick tree
  -swdistmx FILE     SW-BLOSUM62 guide tree -> -guidetreeout
  -qscore FILE       Q/TC accuracy vs -ref reference alignment
  -efastats FILE     Per-replicate column stats of an EFA
  -disperse FILE     Ensemble dispersion of EFA
  -maxcc FILE        Pick max-confidence replicate from EFA -> -output
  -resample FILE     Bootstrap resampled MSAs from EFA -> -output
  -efa_explode FILE  Split EFA into FASTA files -> -prefix
  -fa2efa FILES      Concatenate FASTAs into EFA -> -output
  -addconfseq FILE   Append column-confidence row(s) to MSA -> -output
  -letterconf FILE   Per-letter confidence vs -ref -> -output
  -efa_bestconf FILE Per-replicate confidence; best replicate -> -output
  -efa_bestcols FILE MSA of the highest-confidence columns -> -output
  -colscore_efa FILE Column TC + confidence calibration vs -ref
  -qscore_efa FILE   Q/TC of every replicate vs -ref
  -trimtoref_efa FILE  Trim every replicate to -ref's columns -> -output
  -eesort FILE       Sort -db by pair-HMM EA to the query -> -output
  -cmp_msa FILE      HTML comparison with -ref -> -output
  -cmp_ref_msas FILE Column agreement with -ref
  -consseq FILE      Consensus sequence of an MSA [-> -output]
  -msastats FILE     MSA statistics
  -strip_gappy_cols, -strip_gappy_rows, -relabel (-labels2), -trimtoref
  (-ref), -make_a2m, -squeeze_inserts FILE -> -output; -core_blocks FILE
                     MSA editing (-max_gap_fract)
  -eadistmx FILE     All-pairs pair-HMM EA distances -> -output
  -kmerdist FILE     K-mer distances (-k 66|33) [-> -output]
  -upgma5 FILE       UPGMA tree from a distance TSV -> -output
  -testfb FILE       Forward vs backward total probability, each pair
  -muscle3 FILE      Classic profile aligner -> -output
  -m3ensemble/-m3select FILE, -m3refine MSA   muscle3 ensembles -> -output
  -bench/-bench_blosums/-sweep/-spatter NAMES  muscle3 sweeps (-refdir)
  -derep FILE        Unique sequences -> -output
  -uclust FILE       EA clustering (-minea) centroids -> -output
  -transaln FILE     Fresh sequences onto -ref's MSA -> -output
  -hmmdump DIR       HMM parameter files into DIR
  -perturbhmm N      Perturbation deltas of N seeds
  -masm_train AFA    MASM from an MSA and -input .mega -> -output
  -masm_stats FILE / -swmasm FILE (-query .mega)   MASM tools

Options:
  -output FILE       Output path ('@' expands to <perm>.<perturb seed>)
  -ref FILE          Reference alignment (qscore, letterconf, ...)
  -perm none|abc|acb|bca   Guide-tree permutation
  -perturb N         HMM perturbation seed
  -stratified        4 seeds x 4 perms ensemble (16 replicates)
  -diversified       100 perturbed replicates ensemble
  -replicates N      Replicate count (x4 with -stratified)
  -consiters N       Consistency iterations (default 2)
  -refineiters N     Refinement iterations (default 100)
  -minsuper N        With -align: use Super5 when there are >= N sequences
  -super6_maxpd1 X   Super6's UClustPD distance (default 1.5)
  -shrub_size N      Super7's shrub size (default 32)
  -distmxin FILE     Super7's guide tree from a reseek distance matrix
  -nt / -amino       Force alphabet (default: guess)
  -mega              Read the input as .mega structure profiles
  -input_order       Output rows in input order (default: tree order)
  -guidetreein FILE  Use Newick guide tree
  -guidetreeout FILE Write the guide tree
  -hmmin/-hmmout FILE  Read/write HMM parameters
  -device cuda|cpu   Where the pair-HMM and consistency run (default cuda)
  -threads N         Super6 / -uclustpd: new seeds an iteration
                     (default 16); otherwise accepted for compatibility
  -quiet / -log FILE

Options are parsed as muscle_tpu's CLI parses them: -tree_order,
-verbose, -reseek, -scaledist and -eadist are flags, any other option
takes a value, and an option the command did not read is reported after
it ("WARNING: option -X was not used by -cmd").
"""

# the command flags, as muscle_tpu/cli.py::parse_args has them: any of
# them starts a command (-guide_tree too, which neither package has a
# handler for: it stops with "unknown command", as muscle_tpu's does)
COMMANDS = frozenset({
    "align", "super5", "super6", "super7", "uclustpd", "protdists",
    "qscore", "disperse", "maxcc", "testfb",
    "resample", "efa_explode", "fa2efa", "addconfseq", "letterconf",
    "efa_bestconf", "efa_bestcols", "colscore_efa", "qscore_efa",
    "trimtoref_efa", "eesort", "cmp_msa", "cmp_ref_msas", "upgma5",
    "bench", "bench_blosums", "sweep", "spatter",
    "consseq", "guide_tree", "efastats", "msastats",
    "eadistmx", "kmerdist", "muscle3",
    "m3ensemble", "m3select", "m3refine",
    "strip_gappy_cols", "strip_gappy_rows", "relabel", "trimtoref",
    "make_a2m", "squeeze_inserts", "core_blocks",
    "derep", "uclust", "transaln", "shrub", "swdistmx", "hmmdump",
    "perturbhmm", "masm_train", "masm_stats", "swmasm",
})
# flags (no value); every other option name takes the next argument
BOOL_OPTS = frozenset({"stratified", "diversified", "quiet", "nt", "amino",
                       "input_order", "tree_order", "verbose", "bysequence",
                       "version", "help", "mega", "reseek", "scaledist",
                       "eadist"})
# options read by the harness, not by a command: never warned about
# (-device is the port's own)
HARNESS_OPTS = frozenset({"log", "quiet", "threads", "help", "version",
                          "fa2efa_files", "device"})
# the options that name files a command writes
OUTPUT_OPTS = ("output", "hmmout", "tsvout", "guidetreeout")


class OptDict(dict):
    """The options by name, recording which ones a command read (get,
    [] or `in`), so that main() can warn about the rest, as the JAX
    package does (reference: src/myutils.h:364-371, src/main.cpp:68)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.used: set[str] = set()

    def get(self, k, d=None):
        self.used.add(k)
        return super().get(k, d)

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):
        self.used.add(k)
        return super().__contains__(k)

    def unused(self) -> list[str]:
        return sorted(k for k in self.keys()
                      if k not in self.used and k not in HARNESS_OPTS)


def parse_args(argv: list[str]) -> tuple[str | None, str | None, OptDict]:
    """-> (command or None, its input path or None, the options), parsed
    as muscle_tpu.cli.parse_args parses: BOOL_OPTS are flags, any other
    option takes a value; -fa2efa's input files are
    opts["fa2efa_files"]."""
    cmd = path = None
    opts = OptDict()
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            raise SystemExit(f"unexpected argument {a!r}")
        name = a.lstrip("-")
        if name in COMMANDS:
            if cmd is not None:
                raise SystemExit("only one command flag allowed")
            cmd = name
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                path = argv[i + 1]
                i += 1
            if name == "fa2efa":
                files = [path] if path else []
                while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                    files.append(argv[i + 1])
                    i += 1
                opts["fa2efa_files"] = files
        elif name in BOOL_OPTS:
            opts[name] = True
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"option -{name} requires a value")
            opts[name] = argv[i + 1]
            i += 1
        i += 1
    return cmd, path, opts


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd, path, opts = parse_args(argv)
    if opts.get("version"):
        from . import __version__
        print(f"muscle_tpu_torch {__version__}")
        return 0
    if cmd is None or path is None or opts.get("help"):
        print(USAGE)
        return 0 if opts.get("help") or not argv else 1

    from .utils import logging as mlog
    mesh, joined = _join_world(opts)
    silent = mesh is not None and mesh.rank != 0
    if silent:
        # a rank past 0 writes its outputs where nobody reads them
        scratch = tempfile.mkdtemp(prefix=f"muscle_tpu_rank{mesh.rank}_")
        for name in OUTPUT_OPTS:
            if dict.get(opts, name):
                dict.__setitem__(opts, name, os.path.join(
                    scratch, os.path.basename(str(dict.get(opts, name)))))
    mlog.configure(log_path=None if silent else opts.get("log"),
                   quiet=silent or bool(opts.get("quiet")))
    mlog.log("muscle_tpu_torch %s", " ".join(argv))
    sink = open(os.devnull, "w") if silent else None
    try:
        with (contextlib.redirect_stdout(sink) if sink
              else contextlib.nullcontext()):
            rc = _HANDLERS.get(cmd, _cmd_unknown)(cmd, path, opts)
        for name in opts.unused():
            mlog.progress("WARNING: option -%s was not used by -%s", name,
                          cmd)
        mlog.finish()
    finally:
        if sink:
            sink.close()
            shutil.rmtree(scratch, ignore_errors=True)
        if joined:
            from .parallel.mesh import shutdown
            shutdown()
    return rc


def _join_world(opts: dict):
    """(mesh, whether this call joined it): under a launcher's WORLD_SIZE
    > 1, the process group, on cuda:LOCAL_RANK (NCCL; raising where the
    host has fewer cards than local ranks) or, with -device cpu, on the
    CPU (gloo); (None, False) in a world of one."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, False
    import torch.distributed as dist
    from .parallel.mesh import init_distributed
    joined = not dist.is_initialized()
    cpu = dict.get(opts, "device") == "cpu"
    mesh = init_distributed(device="cpu" if cpu else "cuda")
    if mesh is None:
        raise SystemExit("WORLD_SIZE > 1 without MASTER_ADDR: start the "
                         "ranks with torchrun")
    dict.__setitem__(opts, "device", str(mesh.device))
    return mesh, joined


def _need(opts: dict, *names: str) -> None:
    if not all(opts.get(k) for k in names):
        raise SystemExit("must set " + " and ".join(f"-{k}" for k in names))


def _write_or_print(text: str, dest) -> None:
    """`text` into the file `dest`, or to stdout when none is given."""
    if dest:
        with open(str(dest), "w") as f:
            f.write(text)
    else:
        print(text, end="")


def _ensemble(path: str):
    from .pipeline.ensemble import Ensemble
    return Ensemble.from_efa(path)


def _cmd_align(cmd: str, path: str, opts: dict) -> int:
    from .pipeline.ensemble import run_align_command
    _need(opts, "output")
    run_align_command(cmd, path, str(opts["output"]), opts)
    return 0


def _cmd_qscore(cmd: str, path: str, opts: dict) -> int:
    from .qscore import qscore
    _need(opts, "ref")
    test = MultiSequence.from_fasta(path)
    ref = MultiSequence.from_fasta(str(opts["ref"]))
    q, tc = qscore(test, ref, by_sequence=bool(opts.get("bysequence")))
    print(f"{path} Q={q:.3g}, TC={tc:.3g}")
    return 0


def _cmd_efastats(cmd: str, path: str, opts: dict) -> int:
    """Per-replicate column stats of an EFA (reference: src/efastats.cpp)."""
    ens = _ensemble(path)
    uniq = len({k for keys in ens._col_keys for k in keys})
    print(f"file={path} msas={ens.msa_count} unique_cols={uniq}")
    for i, (name, msa) in enumerate(zip(ens.names, ens.msas)):
        tc = ens.total_conf(i)
        print(f"{name}\tseqs={len(msa)}\tcols={msa.col_count()}"
              f"\ttotal_conf={tc:.1f}\tavg_conf={tc / msa.col_count():.4f}")
    return 0


def _cmd_disperse(cmd: str, path: str, opts: dict) -> int:
    ens = _ensemble(path)
    d_lp, d_cols = ens.dispersion()
    print(f"@disperse file={path} n={len(ens.msas)} D_LP={d_lp:.4f} "
          f"D_Cols={d_cols:.4f}")
    return 0


def _cmd_maxcc(cmd: str, path: str, opts: dict) -> int:
    ens = _ensemble(path)
    best = ens.max_cc()
    if opts.get("output"):
        ens.msas[best].write_fasta(str(opts["output"]))
    print(f"maxcc replicate {ens.names[best]}")
    return 0


def _cmd_resample(cmd: str, path: str, opts: dict) -> int:
    _need(opts, "output")
    _ensemble(path).resample_to_file(str(opts["output"]),
                                     int(opts.get("replicates", 100)),
                                     int(opts.get("randseed", 1)))
    return 0


def _cmd_efa_explode(cmd: str, path: str, opts: dict) -> int:
    ens = _ensemble(path)
    prefix = opts.get("prefix", "")
    for name, msa in zip(ens.names, ens.msas):
        msa.write_fasta(f"{prefix}{name}.afa")
    return 0


def _cmd_fa2efa(cmd: str, path: str, opts: dict) -> int:
    _need(opts, "output")
    with open(str(opts["output"]), "w") as f:
        for p in opts["fa2efa_files"]:
            f.write(f"<{p}\n")
            f.write(MultiSequence.from_fasta(p).to_fasta_text())
    return 0


def _cmd_addconfseq(cmd: str, path: str, opts: dict) -> int:
    _need(opts, "output")
    _ensemble(path).write_with_conf_seq(str(opts["output"]))
    return 0


def _cmd_letterconf(cmd: str, path: str, opts: dict) -> int:
    """Per-letter confidence vs a reference alignment (reference:
    cmd_letterconf src/letterconf.cpp:47-92)."""
    _need(opts, "ref")
    ens = _ensemble(path)
    ref = MultiSequence.from_fasta(str(opts["ref"]))
    stats = ens.letter_conf(ref, opts.get("output"))
    if opts.get("html"):
        ens.letter_conf_html(str(opts["html"]), ref)
    if opts.get("jalview"):
        ens.letter_conf_jalview(str(opts["jalview"]), ref)
    print(f"letterconf Q={stats['Q']:.3g} TC={stats['TC']:.3g} "
          f"mean_conf={stats['mean_conf']:.3g}")
    return 0


def _cmd_efa_bestconf(cmd: str, path: str, opts: dict) -> int:
    """Per-replicate confidence table; writes the best-median replicate
    (reference: cmd_efa_bestconf src/efabestconf.cpp:4-57)."""
    ens = _ensemble(path)
    stats = ens.best_conf_stats()
    print("  MSA     Cols     N1   N1f  TotConf  MedConf  Name")
    for s in stats:
        print(f"{s['index'] + 1:5d}  {s['cols']:7d}  {s['n1']:5d}  "
              f"{s['n1f']:4.2f}  {s['total_conf']:7.3f}  "
              f"{s['median_conf']:7.4f}  {s['name']}")
    best_tot = max(stats, key=lambda s: s["total_conf"])
    best_med = max(stats, key=lambda s: s["median_conf"])
    print(f"Best MSA, total  {best_tot['index'] + 1} ({best_tot['name']})")
    print(f"Best MSA, median {best_med['index'] + 1} ({best_med['name']})")
    if opts.get("output"):
        ens.msas[best_med["index"]].write_fasta(str(opts["output"]))
    return 0


def _cmd_efa_bestcols(cmd: str, path: str, opts: dict) -> int:
    """MSA of the highest-confidence unique columns
    (reference: cmd_efa_bestcols src/efabestcols.cpp:5-64)."""
    _need(opts, "output")
    maxcols = opts.get("maxcols")
    _ensemble(path).best_cols_msa(
        min_conf=float(opts.get("minconf", 1.0)),
        max_gap_fract=float(opts.get("max_gap_fract", 0.5)),
        max_cols=int(maxcols) if maxcols else None,
    ).write_fasta(str(opts["output"]))
    return 0


def _cmd_colscore_efa(cmd: str, path: str, opts: dict) -> int:
    """Mean TC + confidence-bin calibration vs a reference alignment
    (reference: cmd_colscore_efa src/colscoreefa.cpp:18-102)."""
    _need(opts, "ref")
    ens = _ensemble(path)
    ref = MultiSequence.from_fasta(str(opts["ref"]))
    res = ens.colscore(ref, float(opts.get("max_gap_fract", 0.5)))
    lines = [f"meantc\t{res['mean_tc']:.4f}"]
    for b in res["bins"]:
        lines.append(f"bin\t{b['bin']}\t{b['count']}\t{b['correct']}"
                     f"\t{b['p']:.4f}")
    text = "\n".join(lines) + "\n"
    if opts.get("output"):
        with open(str(opts["output"]), "w") as f:
            f.write(text)
    print(text, end="")
    return 0


def _cmd_qscore_efa(cmd: str, path: str, opts: dict) -> int:
    """Q/TC of every replicate vs a reference alignment
    (reference: cmd_qscore_efa src/qscoreefa.cpp:5-33)."""
    import os
    from .qscore import qscore
    _need(opts, "ref")
    ens = _ensemble(path)
    ref = MultiSequence.from_fasta(str(opts["ref"]))
    ref_name = os.path.splitext(os.path.basename(str(opts["ref"])))[0]
    for name, msa in zip(ens.names, ens.msas):
        q, tc = qscore(msa, ref)
        print(f"{ref_name} {name} Q={q:.4f} TC={tc:.4f}")
    return 0


def _cmd_trimtoref_efa(cmd: str, path: str, opts: dict) -> int:
    """Trim every replicate to the reference's columns, EFA out
    (reference: cmd_trimtoref_efa src/trimtorefefa.cpp:8-33)."""
    from . import msatools as mt
    _need(opts, "ref", "output")
    ens = _ensemble(path)
    ref = MultiSequence.from_fasta(str(opts["ref"]))
    with open(str(opts["output"]), "w") as f:
        for name, msa in zip(ens.names, ens.msas):
            f.write(f"<{name}\n")
            f.write(mt.trim_to_ref(msa, ref).to_fasta_text())
    return 0


def _cmd_eesort(cmd: str, path: str, opts: dict) -> int:
    """Sort DB sequences by pair-HMM expected accuracy to the first
    query sequence (reference: cmd_eesort src/eesort.cpp:5-80; the EAs
    are one batched EA pass of pipeline/pairwise.py, on the card unless
    -device cpu)."""
    import numpy as np
    from .alphabet import ALPHA_AMINO, ALPHA_NUCLEO, guess_is_nucleo
    from .hmm.params import HMMParams
    from .pipeline.pairwise import PairAligner
    from .utils.rng import MwcRng
    _need(opts, "db", "output")
    query = MultiSequence.from_fasta(path, strip_gaps=True)
    db = MultiSequence.from_fasta(str(opts["db"]), strip_gaps=True)
    nucleo = guess_is_nucleo(db, MwcRng(1))
    alpha = ALPHA_NUCLEO if nucleo else ALPHA_AMINO
    pack = HMMParams.from_defaults(nucleo=nucleo).to_scores()
    combined = MultiSequence([query[0]] + list(db))
    aligner = PairAligner(combined, pack, alpha, device=opts.get("device"))
    eas = aligner.ea([(0, 1 + i) for i in range(len(db))])
    order = np.argsort(-np.asarray(eas), kind="stable")
    tsv = opts.get("tsvout")
    ftsv = open(str(tsv), "w") if tsv else None
    try:
        with open(str(opts["output"]), "w") as f:
            for k in order:
                if ftsv:
                    ftsv.write(f"{eas[k]:.3g}\t{db[int(k)].label}\n")
                MultiSequence([db[int(k)]])._write(f)
    finally:
        if ftsv:
            ftsv.close()
    return 0


def _cmd_cmp_msa(cmd: str, path: str, opts: dict) -> int:
    """HTML comparison of a test MSA vs a reference: letters colored by
    their reference column, golden-ratio HSV palette
    (reference: cmd_cmp_msa src/cmd_cmp_msa.cpp:130-246)."""
    from .utils.rng import MwcRng
    _need(opts, "ref", "output")
    test = MultiSequence.from_fasta(path)
    ref = MultiSequence.from_fasta(str(opts["ref"]))

    def hsv_to_rgb(h, s, v):
        hi = int(h * 6)
        f = h * 6 - hi
        p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
        r, g, b = [(v, t, p), (q, v, p), (p, v, t),
                   (p, q, v), (t, p, v), (v, p, q)][hi % 6]
        return int(r * 255), int(g * 255), int(b * 255)

    rng = MwcRng(1)
    hue = (rng.randu32() % 1000) / 1000.0
    colors: list[str] = []

    def color_for(ref_col: int) -> str:
        nonlocal hue
        while ref_col >= len(colors):
            i = len(colors)
            if i % 4 == 0:
                hue = (hue + 0.618033988749895) % 1.0
            r, g, b = hsv_to_rgb(hue, 0.5, 0.95)
            factor = (4 - i % 4) / 4.0
            colors.append("#%02x%02x%02x" % (int(r * factor),
                                             int(g * factor),
                                             int(b * factor)))
        return colors[ref_col]

    ref_rows = {s.label: s for s in ref}
    html = ["<html>", "<body>", '<span style="font-size:16px"><pre>']
    cols = test.col_count()
    row_len = 100
    # per test row: test column -> ref column (or None)
    maps = {}
    for s in test:
        r = ref_rows.get(s.label)
        if r is None:
            continue
        p2c = r.pos_to_col()
        m = [None] * cols
        pos = 0
        for c, ch in enumerate(s.text()):
            if ch not in "-.":
                if pos < len(p2c):
                    m[c] = int(p2c[pos])
                pos += 1
        maps[s.label] = m
    for lo in range(0, cols, row_len):
        hi = min(lo + row_len, cols)
        for s in test:
            if s.label not in maps:
                continue
            row = ["   "]
            m = maps[s.label]
            for c in range(lo, hi):
                ch = s.text()[c]
                if m[c] is None:
                    row.append(f'<span style="color:gray">{ch}</span>')
                else:
                    row.append(
                        f'<span style="color:white;background-color:'
                        f'{color_for(m[c])}">{ch}</span>')
            row.append(" " * (lo + row_len - hi))
            row.append(f'  <span style="color:black">{s.label}   </span>')
            html.append("".join(row))
        html.append("\n")
    html.extend(["</pre></span>", "</body>", "</html>"])
    with open(str(opts["output"]), "w") as f:
        f.write("\n".join(html) + "\n")
    return 0


def _cmd_uclustpd(cmd: str, path: str, opts: dict) -> int:
    """Greedy ML-distance clustering to TSV (reference: cmd_uclustpd
    src/uclustpd.cpp:373-401; -tsvout centroid_index<TAB>label). The
    reference promotes <= thread-count new seeds an iteration
    (src/uclustpd.cpp:193), so -threads changes its clustering."""
    from .pipeline.uclustpd import (DEFAULT_SEEDS_PER_ITER, ProtDistCalc,
                                    UClustPD)
    if "maxpd" not in opts:
        raise SystemExit("must set -maxpd")
    if opts.get("output"):
        raise SystemExit("use -tsvout not -output")
    max_pd = float(opts["maxpd"])
    seqs = MultiSequence.from_fasta(path, strip_gaps=True)
    calc = ProtDistCalc(seqs, device=opts.get("device"))
    uc = UClustPD(calc, seeds_per_iter=int(
        opts.get("threads", DEFAULT_SEEDS_PER_ITER)))
    clusters = uc.run(list(range(len(seqs))), max_pd)
    lines = [f"{ci}\t{seqs[si].label}"
             for ci, members in enumerate(clusters) for si in members]
    _write_or_print("\n".join(lines) + "\n", opts.get("tsvout"))
    sizes = sorted((len(m) for m in clusters), reverse=True)
    print(f"{len(seqs)} seqs, {len(clusters)} clusters, "
          f"median {sizes[len(sizes) // 2]}, "
          f"singletons {sum(1 for s in sizes if s == 1)}")
    return 0


def _cmd_protdists(cmd: str, path: str, opts: dict) -> int:
    """All-pairs ML protein distances (reference: cmd_protdists
    src/protdists.cpp:16-86; label<TAB>label<TAB>dist)."""
    from .pipeline.uclustpd import ProtDistCalc
    seqs = MultiSequence.from_fasta(path, strip_gaps=True)
    calc = ProtDistCalc(seqs, device=opts.get("device"))
    n = len(seqs)
    pairs = [(i, j) for i in range(1, n) for j in range(i)]
    d = calc.dists(pairs)
    lines = [f"{seqs[i].label}\t{seqs[j].label}\t{d[k]:.4g}"
             for k, (i, j) in enumerate(pairs)]
    _write_or_print("\n".join(lines) + "\n", opts.get("output"))
    return 0


def _cmd_shrub(cmd: str, path: str, opts: dict) -> int:
    """Report the shrub decomposition of a guide tree: non-overlapping
    subtrees of <= n leaves covering all leaves (reference: cmd_shrub,
    src/shrub.cpp:39-92)."""
    from .pipeline.super7 import get_shrubs
    from .tree.tree import Tree
    tree = Tree.from_file(path)
    n = int(opts.get("n", 32))
    lcas = get_shrubs(tree, n)
    total = 0
    for i, lca in enumerate(lcas):
        leaves = tree.subtree_leaves(lca)
        total += len(leaves)
        print(f"shrub {i}: node {lca}, {len(leaves)} leaves: "
              + ",".join(leaves))
    assert total == len(tree.leaf_labels())
    print(f"{len(lcas)} shrubs, {total} leaves, max size {n}")
    return 0


def _cmd_swdistmx(cmd: str, path: str, opts: dict) -> int:
    """SW-BLOSUM62 guide tree (all-pairs local alignment similarities,
    kernel sw_scores on the card -> rescale -> UPGMA avg); writes Newick
    to -guidetreeout (reference: cmd_swdistmx, src/swdistmx.cpp:129-137)."""
    from .alphabet import ALPHA_AMINO
    from .ops.sw import sw_dist_matrix
    from .tree.upgma import LINKAGE_AVG, scale_dist_mx, upgma5
    seqs = MultiSequence.from_fasta(path)
    sim = sw_dist_matrix(list(seqs), ALPHA_AMINO, device=opts.get("device"))
    tree = upgma5(seqs.labels(), scale_dist_mx(sim), LINKAGE_AVG)
    with open(opts["guidetreeout"], "w") as f:
        f.write(tree.to_newick() + "\n")
    return 0


def _alpha_pack(seqs):
    """(alphabet, score pack) of the default HMM for `seqs`' guessed
    alphabet, as the JAX package's stage commands pick them."""
    from .alphabet import ALPHA_AMINO, ALPHA_NUCLEO, guess_is_nucleo
    from .hmm.params import HMMParams
    from .utils.rng import MwcRng
    nucleo = guess_is_nucleo(seqs, MwcRng(1))
    alpha = ALPHA_NUCLEO if nucleo else ALPHA_AMINO
    return alpha, HMMParams.from_defaults(nucleo=nucleo).to_scores()


def _cmd_consseq(cmd: str, path: str, opts: dict) -> int:
    """Consensus sequence of an MSA (reference: src/consseq.cpp; Super4's
    consensus, pipeline/super4.consensus_sequence)."""
    from .alphabet import ALPHA_AMINO, ALPHA_NUCLEO, guess_is_nucleo
    from .pipeline.super4 import consensus_sequence
    from .sequence import Sequence
    from .utils.rng import MwcRng
    msa = MultiSequence.from_fasta(path)
    alpha = (ALPHA_NUCLEO if guess_is_nucleo(msa, MwcRng(1)) else ALPHA_AMINO)
    label = str(opts.get("label", "CONSENSUS"))
    out = opts.get("output")
    cons = MultiSequence([Sequence(label, consensus_sequence(msa, alpha))])
    if out:
        cons.write_fasta(str(out))
    else:
        print(cons.to_fasta_text(), end="")
    return 0


def _cmd_msastats(cmd: str, path: str, opts: dict) -> int:
    """Basic MSA statistics (reference: src/msastats.cpp)."""
    msa = MultiSequence.from_fasta(path)
    mat = msa.to_matrix()
    gaps = (mat == ord("-")) | (mat == ord("."))
    gap_pct = 100.0 * gaps.mean()
    lens = [s.ungapped_length() for s in msa]
    print(f"file={path} seqs={len(msa)} cols={msa.col_count()} "
          f"gap_pct={gap_pct:.1f} min_len={min(lens)} max_len={max(lens)} "
          f"avg_len={sum(lens) / len(lens):.1f}")
    return 0


def _cmd_msatool(cmd: str, path: str, opts: dict) -> int:
    """The MSA editing commands of msatools (reference:
    src/stripgappycols.cpp, src/stripgappyrows.cpp, src/relabel.cpp,
    src/trimtoref.cpp, src/makea2m.cpp, src/squeezeinserts.cpp,
    src/coreblocks.cpp)."""
    from . import msatools as mt
    msa = MultiSequence.from_fasta(path)
    gf = float(opts.get("max_gap_fract", 0.5))
    if cmd == "strip_gappy_cols":
        out = mt.strip_gappy_cols(msa, gf)
    elif cmd == "strip_gappy_rows":
        out = mt.strip_gappy_rows(msa, gf)
    elif cmd == "relabel":
        mapping = {}
        with open(str(opts["labels2"])) as f:
            for line in f:
                flds = line.rstrip("\n").split("\t")
                if len(flds) == 2:
                    mapping[flds[0]] = flds[1]
        out = mt.relabel(msa, mapping)
    elif cmd == "trimtoref":
        ref = MultiSequence.from_fasta(str(opts["ref"]))
        out = mt.trim_to_ref(msa, ref)
    elif cmd == "make_a2m":
        out = mt.make_a2m(msa, gf)
    elif cmd == "squeeze_inserts":
        out = mt.squeeze_inserts(msa, gf)
    else:
        blocks = mt.core_blocks(
            msa, min_cols=int(opts.get("min_core_block_cols", 8)),
            min_seqs=int(opts.get("min_core_block_seqs", 8)))
        lines = [f"core_blocks\t{len(blocks)}"] + [
            f"{c0}\t{w}\t{r0}\t{nr}" for c0, w, r0, nr in blocks]
        _write_or_print("\n".join(lines) + "\n", opts.get("output"))
        return 0
    dest = opts.get("output")
    if not dest:
        raise SystemExit("must set -output")
    out.write_fasta(str(dest))
    return 0


def _cmd_muscle3(cmd: str, path: str, opts: dict) -> int:
    """Classic profile aligner, host code (reference: -muscle3
    src/muscle3.cpp)."""
    from .pipeline.muscle3 import M3Params, Muscle3
    _need(opts, "output")
    seqs = MultiSequence.from_fasta(path)
    params = M3Params(
        pctid=int(opts.get("blosumpct", 62)),
        param_group=int(opts.get("paramset", 0)),
        gap_open=(float(opts["gapopen"]) if opts.get("gapopen") else None),
        center=(float(opts["center"]) if opts.get("center") else None),
        kmer_dist=str(opts.get("kmerdist", "66")),
        linkage=str(opts.get("linkage", "min")),
        tree_iters=int(opts.get("treeiters", 1)))
    Muscle3(params=params).run(seqs).write_fasta(str(opts["output"]))
    return 0


def _cmd_bench3(cmd: str, path: str, opts: dict) -> int:
    """Benchmark sweeps of muscle3 over a directory of reference MSAs,
    host code (reference: src/cmd_bench.cpp, src/sweep.cpp,
    src/spatter.cpp)."""
    from .pipeline import bench3
    if cmd == "bench":
        q, tc, n = bench3.run_bench(path, opts)
        print(f"AvgQ={q:.3f} AvgTC={tc:.3f} N={n}")
    elif cmd == "bench_blosums":
        bench3.run_bench_blosums(path, opts)
    elif cmd == "sweep":
        bench3.run_sweep(path, opts)
    else:
        bench3.run_spatter(path, opts)
    return 0


def _cmd_m3(cmd: str, path: str, opts: dict) -> int:
    """muscle3 perturbation ensembles, host code (reference:
    src/cmd_m3ensemble.cpp, src/m3select.cpp, src/m3refine.cpp)."""
    from .pipeline.muscle3 import m3_ensemble, m3_refine, m3_select
    _need(opts, "output")
    out = str(opts["output"])
    if cmd == "m3ensemble":
        seqs = MultiSequence.from_fasta(path, strip_gaps=True)
        m3_ensemble(seqs, out, replicates=int(opts.get("replicates", 16)))
    elif cmd == "m3select":
        seqs = MultiSequence.from_fasta(path, strip_gaps=True)
        m3_select(seqs, replicates=int(opts.get("replicates", 64))
                  ).write_fasta(out)
    else:
        msa = MultiSequence.from_fasta(path)
        if not msa.is_aligned():
            raise SystemExit("-m3refine input must be aligned")
        m3_refine(msa, iters=int(opts.get("iters", 32))).write_fasta(out)
    return 0


def _cmd_eadistmx(cmd: str, path: str, opts: dict) -> int:
    """All-pairs expected-accuracy matrix (reference: src/eadistmx.cpp;
    one batched EA pass, kernels A/B on the card unless -device cpu)."""
    from .pipeline.pairwise import PairAligner
    _need(opts, "output")
    seqs = MultiSequence.from_fasta(path, strip_gaps=True)
    alpha, pack = _alpha_pack(seqs)
    d = PairAligner(seqs, pack, alpha,
                    device=opts.get("device")).ea_dist_matrix()
    labels = seqs.labels()
    with open(str(opts["output"]), "w") as f:
        for i in range(len(labels)):
            for j in range(i + 1, len(labels)):
                f.write(f"{labels[i]}\t{labels[j]}\t{d[i, j]:.4f}\n")
    return 0


def _cmd_kmerdist(cmd: str, path: str, opts: dict) -> int:
    """K-mer distances, host code (reference: src/kmerdist66.cpp,
    src/kmerdist33.cpp)."""
    from .tree.kmerdist import kmer_dist_33, kmer_dist_66
    seqs = MultiSequence.from_fasta(path, strip_gaps=True)
    k = str(opts.get("k", "66"))
    d = kmer_dist_33(seqs) if k == "33" else kmer_dist_66(seqs)
    labels = seqs.labels()
    lines = [f"{labels[i]}\t{labels[j]}\t{d[i, j]:.4f}"
             for i in range(len(labels)) for j in range(i + 1, len(labels))]
    _write_or_print("\n".join(lines) + "\n", opts.get("output"))
    return 0


def _cmd_testfb(cmd: str, path: str, opts: dict) -> int:
    """Forward/backward check (reference: -testfb, src/testfb.cpp): for
    every consecutive sequence pair, the total log-probability folded
    from the forward's final states must equal the one folded from the
    backward's (kernel A against kernel 3K's corner output on the card,
    ops/testfb.py). Prints the max deviation; exits non-zero above
    1e-3."""
    from .alphabet import ALPHA_AMINO, ALPHA_NUCLEO, guess_is_nucleo
    from .hmm.params import HMMParams
    from .ops.testfb import total_probs
    from .pipeline.posteriors import encode_batch
    from .utils import logging as mlog
    from .utils.rng import MwcRng
    seqs = MultiSequence.from_fasta(path)
    nucleo = (bool(opts.get("nt")) or
              (not opts.get("amino")
               and guess_is_nucleo(seqs, MwcRng(1))))
    alpha = ALPHA_NUCLEO if nucleo else ALPHA_AMINO
    pack = HMMParams.from_defaults(nucleo=nucleo).to_scores()
    codes, lens = encode_batch(seqs, alpha)
    n = len(seqs)
    worst = 0.0
    if n > 1:
        fwd, bwd = total_probs(
            [codes[i][:int(lens[i])] for i in range(n - 1)],
            [codes[i + 1][:int(lens[i + 1])] for i in range(n - 1)],
            pack, opts.get("device"))
        for i in range(n - 1):
            tf, tb = float(fwd[i]), float(bwd[i])
            rel = abs(tf - tb) / max(1.0, abs(tf))
            worst = max(worst, rel)
            mlog.progress("testfb %s/%s: fwd %.6f bwd %.6f rel %.2e",
                          seqs[i].label, seqs[i + 1].label, tf, tb, rel)
    mlog.progress("testfb max relative |fwd-bwd| = %.3e", worst)
    return 0 if worst < 1e-3 else 1


def _cmd_upgma5(cmd: str, path: str, opts: dict) -> int:
    """UPGMA tree from a distance-matrix file, host code (reference:
    cmd_upgma5 src/upgma5.cpp:565-610; -reseek reads reseek's format and
    rescales, the plain format is label<TAB>label<TAB>dist with
    -scaledist/-eadist transforms; default linkage avg)."""
    import numpy as np
    from .tree.upgma import (fix_ea_distmx, read_distmx_reseek,
                             scale_dist_mx, upgma5)
    _need(opts, "output")
    if opts.get("reseek"):
        labels, d = read_distmx_reseek(path)
        d = scale_dist_mx(d)
    else:
        labels = []
        idx: dict[str, int] = {}
        trips = []
        with open(path) as f:
            for line in f:
                fl = line.rstrip("\n").split("\t")
                if len(fl) != 3:
                    continue
                for lb in fl[:2]:
                    if lb not in idx:
                        idx[lb] = len(labels)
                        labels.append(lb)
                trips.append((fl[0], fl[1], float(fl[2])))
        d = np.zeros((len(labels), len(labels)), dtype=np.float64)
        for a, b, v in trips:
            d[idx[a], idx[b]] = d[idx[b], idx[a]] = v
        if opts.get("scaledist"):
            d = scale_dist_mx(d)
        elif opts.get("eadist"):
            d = fix_ea_distmx(d)
    tree = upgma5(labels, d, str(opts.get("linkage", "avg")))
    tree.to_file(str(opts["output"]))
    return 0


def _cmd_cmp_ref_msas(cmd: str, path: str, opts: dict) -> int:
    """Column agreement of two alignments of the same sequences: per
    reference column the share of its letters in the test column that
    holds most of them, and the summary line, host code (compact
    equivalent of cmd_cmp_ref_msas src/cmp_ref_msas.cpp:22-171)."""
    import numpy as np
    _need(opts, "ref")
    ref_path = opts["ref"]
    test = MultiSequence.from_fasta(path)
    ref = MultiSequence.from_fasta(str(ref_path))
    ref_labels = {r.label for r in ref}
    common = [s.label for s in test if s.label in ref_labels]
    if len(common) < 2:
        raise SystemExit("fewer than 2 shared labels")
    t_rows = {s.label: s for s in test}
    r_rows = {s.label: s for s in ref}

    def col_keys(rows):
        mat = np.stack([rows[lb].bytes_view() for lb in common])
        nongap = (mat != ord("-")) & (mat != ord("."))
        pos = np.cumsum(nongap, axis=1) * nongap
        return [tuple(pos[:, c]) for c in range(mat.shape[1])]

    letter_to_tcol = {}
    for c, key in enumerate(col_keys(t_rows)):
        for i, p in enumerate(key):
            if p:
                letter_to_tcol[(i, p)] = c
    qs = []
    for key in col_keys(r_rows):
        letters = [(i, p) for i, p in enumerate(key) if p]
        if len(letters) < 2:
            continue
        votes: dict[int, int] = {}
        for lt in letters:
            tc = letter_to_tcol.get(lt)
            if tc is not None:
                votes[tc] = votes.get(tc, 0) + 1
        best = max(votes.values()) if votes else 0
        qs.append(best / len(letters))
    q = float(np.mean(qs)) if qs else 0.0
    print(f"@CMP_REF_MSAs test={path} ref={ref_path} name={path} "
          f"cols={len(qs)} Q={q:.4f}")
    return 0


def _cmd_derep(cmd: str, path: str, opts: dict) -> int:
    """Write the unique (dereplicated) sequences, host code (reference:
    cmd_derep, src/derep.cpp:226-241)."""
    from .pipeline.derep import Derep
    seqs = MultiSequence.from_fasta(path)
    d = Derep()
    d.run(seqs)
    d.unique_seqs(seqs).write_fasta(opts["output"])
    return 0


def _cmd_uclust(cmd: str, path: str, opts: dict) -> int:
    """Greedy EA-threshold clustering; writes the centroid sequences
    (reference: cmd_uclust, src/uclust.cpp:183-206; the EAs on the card,
    kernels A/B, unless -device cpu)."""
    from .pipeline.pairwise import PairAligner
    from .pipeline.uclust import UClust
    seqs = MultiSequence.from_fasta(path)
    min_ea = float(opts.get("minea", 0.9))
    alpha, pack = _alpha_pack(seqs)
    aligner = PairAligner(list(seqs), pack, alpha, device=opts.get("device"))
    centroid_idx, _assign, _paths = UClust(aligner, alpha).run(seqs, min_ea)
    MultiSequence([seqs[i] for i in centroid_idx]).write_fasta(opts["output"])
    return 0


def _cmd_transaln(cmd: str, path: str, opts: dict) -> int:
    """Align fresh sequences transitively onto an existing MSA: input k
    is pair-aligned (pair-HMM + MEA; kernels A/B on the card unless
    -device cpu) to the ungapped reference row k % ref_count and merged
    through the transitive path machinery (reference: cmd_transaln,
    src/transaln.cpp:752-810)."""
    from .pipeline.pairwise import PairAligner
    from .pipeline.transaln import make_extended_msa
    from .sequence import Sequence
    fresh = MultiSequence.from_fasta(path)
    ref_msa = MultiSequence.from_fasta(opts["ref"])
    nref = len(ref_msa)
    ungapped = [Sequence(s.label, s.bytes_view()[s.bytes_view() != ord("-")])
                for s in ref_msa]
    alpha, pack = _alpha_pack(fresh)
    aligner = PairAligner(list(fresh) + ungapped, pack, alpha,
                          device=opts.get("device"))
    idx = [i % nref for i in range(len(fresh))]
    results = aligner.align_pairs(
        [(k, len(fresh) + idx[k]) for k in range(len(fresh))])
    paths = [p for _ea, p in results]
    make_extended_msa(ref_msa, list(fresh), idx, paths).write_fasta(
        opts["output"])
    return 0


def _cmd_hmmdump(cmd: str, path: str, opts: dict) -> int:
    """Dump the HMM parameter set to the directory `path`: the defaults
    (hmm.tsv), a serialization round trip (hmm2/hmm3.tsv, byte-identical)
    and the single-affine collapse (sa.hmm), host code (reference:
    cmd_hmmdump, src/hmmdump.cpp:257-284)."""
    import os
    from .hmm.params import HMMParams
    os.makedirs(path, exist_ok=True)
    hp = HMMParams.from_defaults(nucleo=bool(opts.get("nt")))
    hp.to_file(os.path.join(path, "hmm.tsv"))
    hp.to_file(os.path.join(path, "hmm2.tsv"))
    hp2 = HMMParams.from_file(os.path.join(path, "hmm2.tsv"))
    hp2.to_file(os.path.join(path, "hmm3.tsv"))
    _single_affine(hp2).to_file(os.path.join(path, "sa.hmm"))
    return 0


def _single_affine(hp):
    """Average the short/long gap tracks into one affine class
    (reference: HMMParams::ToSingleAffineProbs,
    src/hmmparams.cpp:52-77)."""
    import numpy as np
    from .hmm.params import TRANS_NAMES, HMMParams
    t = {n: float(v) for n, v in zip(TRANS_NAMES, hp.trans)}
    si = (t["START_IS"] + t["START_IL"]) / 2
    mi = (t["M_IS"] + t["M_IL"]) / 2
    im = (t["IS_M"] + t["IL_M"]) / 2
    ii = (t["IS_IS"] + t["IL_IL"]) / 2
    t.update(START_IS=si, START_IL=si, M_IS=mi, M_IL=mi,
             IS_M=im, IL_M=im, IS_IS=ii, IL_IL=ii)
    trans = np.array([t[n] for n in TRANS_NAMES], dtype=np.float32)
    return HMMParams(hp.alpha, trans, hp.emits, hp.var)


def _cmd_perturbhmm(cmd: str, path: str, opts: dict) -> int:
    """Perturbation-stream diagnostic: for each seed below `path`, the
    mean |delta| of the perturbed transitions and emissions against the
    defaults, host code (reference: cmd_perturbhmm,
    src/perturbhmm.cpp:68-99)."""
    import numpy as np
    from .hmm.params import HMMParams
    from .utils import logging as mlog
    iters = int(path)
    nucleo = bool(opts.get("nt"))
    base = HMMParams.from_defaults(nucleo=nucleo)
    for it in range(iters):
        hp = HMMParams.from_defaults(nucleo=nucleo)
        hp.perturb(it)
        dt = float(np.abs(base.trans - hp.trans).mean())
        de = float(np.abs(base.emits - hp.emits).mean())
        mlog.progress("Iter %u, trans %8.6f, emit %8.6f", it, dt, de)
    return 0


def _cmd_masm_train(cmd: str, path: str, opts: dict) -> int:
    """Train a MASM (multiple alignment structure model) from an aligned
    family and its .mega feature profiles, host code (reference:
    cmd_masm_train, src/masm_train.cpp:18-37)."""
    import os
    from .io.mega import parse_mega
    from .pipeline.masm import MASM
    aln = MultiSequence.from_fasta(path)
    mega = parse_mega(opts["input"])
    label = opts.get("label") or os.path.basename(path)
    MASM.from_msa(aln, mega, label).to_file(opts["output"])
    return 0


def _cmd_masm_stats(cmd: str, path: str, opts: dict) -> int:
    """Print a MASM's dimensions (reference: cmd_masm_stats,
    src/masm_train.cpp:4-16)."""
    from .pipeline.masm import MASM
    m = MASM.from_file(path)
    feats = " ".join(f"{n}/{a}" for n, a in
                     zip(m.feature_names, m.alpha_sizes))
    print(f"{m.seq_count:10d}  Sequences")
    print(f"{m.col_count:10d}  Columns")
    print(f"{len(m.feature_names):10d}  Features  {feats}")
    return 0


def _cmd_swmasm(cmd: str, path: str, opts: dict) -> int:
    """Local-align every profile of a .mega file (-query) against a MASM;
    label pairs and SW scores as TSV, host code (reference: cmd_swmasm,
    src/swmasm.cpp:27-65)."""
    from .io.mega import parse_mega
    from .pipeline.masm import MASM
    m = MASM.from_file(path)
    mega = parse_mega(opts["query"])
    lines = []
    for lb, prof in zip(mega.labels, mega.profiles):
        score, _path, _loi, _loj = m.sw_vs_profile(prof)
        lines.append(f"{m.label}\t{lb}\t{score:.3g}")
    _write_or_print("\n".join(lines) + "\n", opts.get("output"))
    return 0


def _cmd_unknown(cmd: str, path: str, opts: dict) -> int:
    """A command flag with no handler (-guide_tree), as muscle_tpu's
    _dispatch stops on it."""
    raise SystemExit(f"unknown command -{cmd}")


_HANDLERS = {"align": _cmd_align, "super5": _cmd_align,
             "super6": _cmd_align, "super7": _cmd_align,
             "uclustpd": _cmd_uclustpd, "protdists": _cmd_protdists,
             "shrub": _cmd_shrub, "swdistmx": _cmd_swdistmx,
             "qscore": _cmd_qscore, "efastats": _cmd_efastats,
             "disperse": _cmd_disperse, "maxcc": _cmd_maxcc,
             "resample": _cmd_resample, "efa_explode": _cmd_efa_explode,
             "fa2efa": _cmd_fa2efa, "addconfseq": _cmd_addconfseq,
             "letterconf": _cmd_letterconf,
             "efa_bestconf": _cmd_efa_bestconf,
             "efa_bestcols": _cmd_efa_bestcols,
             "colscore_efa": _cmd_colscore_efa,
             "qscore_efa": _cmd_qscore_efa,
             "trimtoref_efa": _cmd_trimtoref_efa, "eesort": _cmd_eesort,
             "cmp_msa": _cmd_cmp_msa, "cmp_ref_msas": _cmd_cmp_ref_msas,
             "consseq": _cmd_consseq, "msastats": _cmd_msastats,
             "eadistmx": _cmd_eadistmx, "kmerdist": _cmd_kmerdist,
             "testfb": _cmd_testfb, "muscle3": _cmd_muscle3,
             "m3ensemble": _cmd_m3, "m3select": _cmd_m3, "m3refine": _cmd_m3,
             "bench": _cmd_bench3, "bench_blosums": _cmd_bench3,
             "sweep": _cmd_bench3, "spatter": _cmd_bench3,
             "upgma5": _cmd_upgma5, "derep": _cmd_derep,
             "uclust": _cmd_uclust, "transaln": _cmd_transaln,
             "hmmdump": _cmd_hmmdump, "perturbhmm": _cmd_perturbhmm,
             "masm_train": _cmd_masm_train, "masm_stats": _cmd_masm_stats,
             "swmasm": _cmd_swmasm}
_HANDLERS.update((cmd, _cmd_msatool) for cmd in (
    "strip_gappy_cols", "strip_gappy_rows", "relabel", "trimtoref",
    "make_a2m", "squeeze_inserts", "core_blocks"))


if __name__ == "__main__":
    sys.exit(main())
