"""The port's CLI against muscle_tpu.cli.main on the commands it gained
last: each writes the same standard output, the same files and the same
unused-option warnings, and returns the same code, on in-repo data (the
goldens, degapped where a command takes sequences; tests/mega_synth.py
for the MASM tools). The commands that reach the pair-HMM (-eadistmx,
-uclust, -transaln, -testfb) run with -device cpu in the port. -testfb's
totals are compared within 1e-5 relative (kernel A's and 3K's plain
versions against the JAX scans); -guide_tree stops in both with
"unknown command".
"""

import os
import re
import sys

import pytest
import torch

from muscle_tpu.cli import main as j_main
from muscle_tpu_torch.cli import main as t_main
from muscle_tpu_torch.io.mega import parse_mega
from muscle_tpu_torch.pipeline.masm import MASM
from muscle_tpu_torch.pipeline.muscle3 import Muscle3
from muscle_tpu_torch.sequence import MultiSequence, Sequence
from muscle_tpu_torch.tree.kmerdist import kmer_dist_66

sys.path.insert(0, os.path.dirname(__file__))
from mega_synth import mega_text  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens")
DEVICE_COMMANDS = {"eadistmx", "uclust", "transaln", "testfb"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    """The input files, by name."""
    d = tmp_path_factory.mktemp("inputs")
    f = {"aln1": os.path.join(GOLDEN, "BB11001.seq.afa"),
         "aln2": os.path.join(GOLDEN, "BB11002.seq.afa")}

    def put(name, text):
        f[name] = str(d / name)
        with open(f[name], "w") as fh:
            fh.write(text)

    seqs1 = MultiSequence.from_fasta(f["aln1"], strip_gaps=True)
    put("fa1", seqs1.to_fasta_text())
    # duplicates and a near-duplicate, for -derep and -uclust
    s0 = seqs1[0].text()
    extra = [Sequence("dup0", s0), Sequence("dup1", seqs1[1].text()),
             Sequence("near0", s0[:40] + "W" + s0[41:])]
    put("fa_dups", MultiSequence(list(seqs1) + extra).to_fasta_text())
    put("m3aln", Muscle3().run(seqs1).to_fasta_text())
    put("labels2", "1j46_A\tfirst\n2lef_A\tsecond\n")
    seqs2 = MultiSequence.from_fasta(f["aln2"], strip_gaps=True)
    d2 = kmer_dist_66(seqs2)
    labels = seqs2.labels()
    put("dist", "".join(f"{labels[i]}\t{labels[j]}\t{d2[i, j]:.4f}\n"
                        for i in range(len(labels))
                        for j in range(i + 1, len(labels))))
    # -transaln: two degapped rows onto the MSA of the other two
    gold = MultiSequence.from_fasta(f["aln1"])
    put("fresh", MultiSequence([seqs1[0], seqs1[1]]).to_fasta_text())
    put("ref2", MultiSequence([gold[2], gold[3]]).to_fasta_text())
    # -bench family: a names file and its refdir
    for fam in ("BB11001", "BB11002"):
        with open(os.path.join(GOLDEN, f"{fam}.seq.afa")) as fh:
            put(f"{fam}.afa", fh.read())
    put("names2", "BB11001.afa\nBB11002.afa\n")
    put("names1", "BB11001.afa\n")
    f["refdir"] = str(d)
    # MASM: a synthetic 8-feature set, its muscle3 alignment, a model
    put("mega", mega_text(6, 50, 70, 31))
    mega = parse_mega(f["mega"])
    put("mega_aln", Muscle3().run(MultiSequence(
        [Sequence(lb, sq) for lb, sq in zip(mega.labels, mega.seqs)]
    )).to_fasta_text())
    put("masm", MASM.from_msa(MultiSequence.from_fasta(f["mega_aln"]), mega,
                              "fam").to_text())
    return f


# (id, argv with {name} for an input and {o} for the output directory)
CASES = [
    ("consseq", "-consseq {aln2} -label CONS"),
    ("consseq-output", "-consseq {aln1} -output {o}/cons.afa"),
    ("msastats", "-msastats {aln2}"),
    ("strip_gappy_cols", "-strip_gappy_cols {aln2} -max_gap_fract 0.3 "
                         "-output {o}/s.afa"),
    ("strip_gappy_rows", "-strip_gappy_rows {aln2} -max_gap_fract 0.2 "
                         "-output {o}/s.afa"),
    ("relabel", "-relabel {aln1} -labels2 {labels2} -output {o}/r.afa"),
    ("trimtoref", "-trimtoref {m3aln} -ref {aln1} -output {o}/t.afa"),
    ("make_a2m", "-make_a2m {aln2} -output {o}/a.a2m"),
    ("squeeze_inserts", "-squeeze_inserts {aln2} -max_gap_fract 0.4 "
                        "-output {o}/q.afa"),
    ("core_blocks", "-core_blocks {aln2} -min_core_block_cols 4 "
                    "-min_core_block_seqs 2"),
    ("eadistmx", "-eadistmx {fa1} -output {o}/ea.tsv"),
    ("kmerdist", "-kmerdist {aln2} -k 33"),
    ("kmerdist-output", "-kmerdist {aln2} -output {o}/k.tsv -unused 1"),
    ("muscle3", "-muscle3 {fa1} -output {o}/m.afa -treeiters 2 "
                "-linkage avg"),
    ("m3ensemble", "-m3ensemble {aln1} -output {o}/e.efa -replicates 4"),
    ("m3select", "-m3select {aln1} -output {o}/s.afa -replicates 4"),
    ("m3refine", "-m3refine {aln2} -output {o}/r.afa -iters 4"),
    ("bench", "-bench {names2} -refdir {refdir} -tsvout {o}/tc.tsv"),
    ("bench_blosums", "-bench_blosums {names1} -refdir {refdir} "
                      "-tsvout {o}/b.tsv"),
    ("sweep", "-sweep {names2} -refdir {refdir} "
              "-gridspec gapopen,-6,-7,-5,2"),
    ("spatter", "-spatter {names2} -refdir {refdir} "
                "-gridspec gapopen,-6,-8,-4,3 -warmup_pct 50 -maxiters 2 "
                "-maxfailiters 1 -triesperiter 2 -shrink 0.6"),
    ("upgma5", "-upgma5 {dist} -output {o}/t.nwk -linkage biased"),
    ("upgma5-scaledist", "-upgma5 {dist} -scaledist -output {o}/t.nwk"),
    ("cmp_ref_msas", "-cmp_ref_msas {m3aln} -ref {aln1}"),
    ("derep", "-derep {fa_dups} -output {o}/u.fa"),
    ("uclust", "-uclust {fa_dups} -minea 0.9 -output {o}/c.fa"),
    ("transaln", "-transaln {fresh} -ref {ref2} -output {o}/t.afa"),
    ("hmmdump", "-hmmdump {o}/hmm"),
    ("hmmdump-nt", "-hmmdump {o}/hmm -nt"),
    ("perturbhmm", "-perturbhmm 3"),
    ("masm_train", "-masm_train {mega_aln} -input {mega} -output {o}/f.masm "
                   "-label fam"),
    ("masm_stats", "-masm_stats {masm}"),
    ("swmasm", "-swmasm {masm} -query {mega}"),
]


def run_cli(main, argv, capsys):
    """(return code or the SystemExit's text, stdout, stderr)."""
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = f"SystemExit: {e}"
    got = capsys.readouterr()
    return rc, got.out, got.err


def files_under(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p) as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def both(argv_text, inp, tmp_path, capsys):
    """Each package's (code, stdout, stderr's lines but the wall, files)."""
    res = {}
    for pkg, main in (("port", t_main), ("jax", j_main)):
        o = tmp_path / pkg
        o.mkdir()
        argv = argv_text.format(o=o, **inp).split()
        if pkg == "port" and argv[0][1:] in DEVICE_COMMANDS:
            argv += ["-device", "cpu"]
        rc, out, err = run_cli(main, argv, capsys)
        # the closing "Finished (<wall> elapsed)" differs in its wall
        lines = [ln for ln in err.splitlines()
                 if not ln.startswith("Finished (")]
        res[pkg] = (rc, out, lines, files_under(o))
    return res


@pytest.mark.parametrize("argv_text", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_command_matches_jax(argv_text, inp, tmp_path, capsys):
    res = both(argv_text, inp, tmp_path, capsys)
    assert res["port"] == res["jax"]
    assert res["port"][0] == 0
    if "{o}" in argv_text:
        assert res["port"][3], "no file written"


def test_testfb_matches_jax(inp, tmp_path, capsys):
    """-testfb: the same exit code and pairs; each total within 1e-5
    relative of muscle_tpu's, and the worst |fwd - bwd| printed."""
    res = both("-testfb {fa1}", inp, tmp_path, capsys)
    assert res["port"][0] == res["jax"][0] == 0
    pat = re.compile(r"testfb (\S+): fwd (\S+) bwd (\S+) rel")
    got = [pat.search(ln) for ln in res["port"][2]]
    want = [pat.search(ln) for ln in res["jax"][2]]
    got = [m.groups() for m in got if m]
    want = [m.groups() for m in want if m]
    assert len(got) == len(want) == 3
    for (p, f, b), (jp, jf, jb) in zip(got, want):
        assert p == jp
        for a, c in ((f, jf), (b, jb)):
            assert abs(float(a) - float(c)) <= 1e-5 * abs(float(c))
    assert any("max relative |fwd-bwd|" in ln for ln in res["port"][2])


def test_guide_tree_stops_as_jax(inp, tmp_path, capsys):
    res = both("-guide_tree {fa1} -output {o}/t.nwk", inp, tmp_path, capsys)
    assert res["port"][0] == res["jax"][0] == ("SystemExit: unknown "
                                               "command -guide_tree")


def test_total_probs_match_jax():
    """ops/testfb's totals (kernel A's and 3K's plain versions, all pairs
    in one call) within 1e-5 relative of muscle_tpu.ops.pairhmm's
    total_prob_fwd / total_prob_bwd on 3 pairs, one of them with lx and
    ly at a multiple of 128 (the corner on the step past RB_M's rows)."""
    import jax.numpy as jnp
    import numpy as np
    from muscle_tpu.hmm.params import HMMParams as JHMMParams
    from muscle_tpu.ops import pairhmm as j_ph
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import testfb
    rng = np.random.default_rng(12)
    lens = [(128, 128), (70, 45), (150, 133)]
    xs = [rng.integers(0, 20, size=a).astype(np.int32) for a, _ in lens]
    ys = [rng.integers(0, 20, size=b).astype(np.int32) for _, b in lens]
    fwd, bwd = testfb.total_probs(
        xs, ys, HMMParams.from_defaults().to_scores(), "cpu")
    jpack = JHMMParams.from_defaults().to_scores()
    for k in range(3):
        x, y = jnp.asarray(xs[k]), jnp.asarray(ys[k])
        for got, want in ((fwd[k], j_ph.total_prob_fwd(x, y, jpack)),
                          (bwd[k], j_ph.total_prob_bwd(x, y, jpack))):
            assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    pack = HMMParams.from_defaults().to_scores()
    assert testfb.total_prob_fwd(xs[0], ys[0], pack, "cpu") == fwd[0]
    assert testfb.total_prob_bwd(xs[0], ys[0], pack, "cpu") == bwd[0]
