"""The EFA tools, the serial replicate loop's inputs and the CLI: the port
against the JAX package, on the CPU.

* every `Ensemble` method, and every EFA handler of the port's CLI
  (stdout and files), equal to muscle_tpu's, on tests/test_efa_tools.py's
  EFA and on an EFA the port made (`-replicates 3` of degapped BB11001),
  with BB11001's golden as the reference alignment;
* the host copies `qscore.py` and `msatools.py` equal to muscle_tpu's;
* the serial loop: a `.mega -replicates 2` ensemble, and `-guidetreein`,
  `-guidetreeout`, `-input_order`, `-hmmin` and `-hmmout`, each giving
  muscle_tpu's files, and `-guidetreeout` with `-input_order`, which
  leaves the rows in the run's order;
* `.mega` input is amino whatever -nt says: `-super5 x.mega -nt` and
  `-align x.mega -minsuper 2 -nt` give muscle_tpu's text.
"""

import os

import numpy as np
import pytest
import torch

from mega_synth import mega_text
from muscle_tpu import msatools as j_mt
from muscle_tpu.cli import main as j_cli
from muscle_tpu.pipeline.ensemble import Ensemble as JEnsemble
from muscle_tpu.qscore import qscore as j_qscore
from muscle_tpu.qscore import ref_letter_counts as j_rlc
from muscle_tpu.sequence import MultiSequence as JMS
from muscle_tpu_torch import msatools as t_mt
from muscle_tpu_torch.cli import main as t_cli
from muscle_tpu_torch.pipeline.ensemble import Ensemble, run_align_command
from muscle_tpu_torch.qscore import qscore, ref_letter_counts
from muscle_tpu_torch.sequence import MultiSequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "BB11001.seq.afa")

# tests/test_efa_tools.py's ensemble
EFA = """\
<rep0
>a
ACD-F
>b
AC-EF
<rep1
>a
ACD-F
>b
AC-EF
<rep2
>a
ACDF
>b
ACEF
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def efas(tmp_path_factory):
    """{name: (efa path, reference alignment path)}: the small EFA and
    one the port made from degapped BB11001 (3 replicates)."""
    d = tmp_path_factory.mktemp("efa")
    small = d / "small.efa"
    small.write_text(EFA)
    small_ref = d / "small_ref.afa"
    small_ref.write_text(">a\nACD-F\n>b\nAC-EF\n")
    inp = d / "bb.fa"
    inp.write_text(MultiSequence.from_fasta(GOLDEN, strip_gaps=True)
                   .to_fasta_text())
    made = d / "bb.efa"
    run_align_command("align", str(inp), str(made),
                      {"replicates": "3", "refineiters": "3",
                       "device": "cpu"})
    return {"small": (str(small), str(small_ref)),
            "port-made": (str(made), GOLDEN)}


def _ens_pair(path):
    return Ensemble.from_efa(path), JEnsemble.from_efa(path)


def _msa_text(m):
    return m.to_fasta_text()


@pytest.mark.parametrize("which", ["small", "port-made"])
def test_ensemble_methods_match_jax(efas, which, tmp_path):
    path, ref_path = efas[which]
    t, j = _ens_pair(path)
    ref, jref = (MultiSequence.from_fasta(ref_path),
                 JMS.from_fasta(ref_path))
    assert t.names == j.names and t.msa_count == j.msa_count
    assert [_msa_text(m) for m in t.msas] == [_msa_text(m) for m in j.msas]
    for i in range(t.msa_count):
        cols = t.msas[i].col_count()
        assert [t.col_conf(i, c) for c in range(cols)] == \
            [j.col_conf(i, c) for c in range(cols)]
        assert t.total_conf(i) == j.total_conf(i)
        assert t.median_conf(i) == j.median_conf(i)
        assert t.n1(i) == j.n1(i)
        for dec in (1, 2):
            assert t.conf_seq(i, dec) == j.conf_seq(i, dec)
    assert t.best_conf_stats() == j.best_conf_stats()
    for kw in ({}, {"min_conf": 0.5, "max_gap_fract": 1.0, "max_cols": 2}):
        assert _msa_text(t.best_cols_msa(**kw)) == \
            _msa_text(j.best_cols_msa(**kw))
    for gf in (0.5, 1.0):
        assert t.colscore(ref, gf) == j.colscore(jref, gf)
    assert t.max_cc() == j.max_cc()
    if t.msa_count > 1:
        assert t.dispersion() == j.dispersion()
    assert t.hi_qual_unique_cols() == j.hi_qual_unique_cols()
    assert t.median_hi_qual_col_count() == j.median_hi_qual_col_count()
    assert np.array_equal(t.letter_confs(ref), j.letter_confs(jref))
    assert _msa_text(t.conf_aln(ref)) == _msa_text(j.conf_aln(jref))
    assert t.letter_conf(ref, None) == j.letter_conf(jref, None)
    for name, fn, jfn in (
            ("resample", lambda p: t.resample_to_file(p, 5, 3),
             lambda p: j.resample_to_file(p, 5, 3)),
            ("conf", t.write_with_conf_seq, j.write_with_conf_seq),
            ("html", lambda p: t.letter_conf_html(p, ref),
             lambda p: j.letter_conf_html(p, jref)),
            ("jalview", lambda p: t.letter_conf_jalview(p, ref),
             lambda p: j.letter_conf_jalview(p, jref))):
        fn(str(tmp_path / f"{name}.port"))
        jfn(str(tmp_path / f"{name}.jax"))
        assert (tmp_path / f"{name}.port").read_text() == \
            (tmp_path / f"{name}.jax").read_text(), name


# each handler: its arguments beyond the input ({efa}, {ref}, {out}
# filled in) and the files it writes
HANDLERS = [
    ("efastats", [], []),
    ("disperse", [], []),
    ("maxcc", ["-output", "{out}"], ["{out}"]),
    ("resample", ["-output", "{out}", "-replicates", "4", "-randseed", "7"],
     ["{out}"]),
    ("efa_explode", ["-prefix", "{out}_"], []),
    ("addconfseq", ["-output", "{out}"], ["{out}"]),
    ("letterconf", ["-ref", "{ref}", "-output", "{out}", "-html",
                    "{out}.html", "-jalview", "{out}.jal"],
     ["{out}", "{out}.html", "{out}.jal"]),
    ("efa_bestconf", ["-output", "{out}"], ["{out}"]),
    ("efa_bestcols", ["-output", "{out}", "-minconf", "0.5"], ["{out}"]),
    ("colscore_efa", ["-ref", "{ref}", "-output", "{out}"], ["{out}"]),
    ("qscore_efa", ["-ref", "{ref}"], []),
    ("trimtoref_efa", ["-ref", "{ref}", "-output", "{out}"], ["{out}"]),
]


def _run_cli(fn, argv, capsys):
    capsys.readouterr()
    assert fn(argv + ["-quiet"]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("which", ["small", "port-made"])
@pytest.mark.parametrize("cmd,args,files", HANDLERS,
                         ids=[h[0] for h in HANDLERS])
def test_efa_handlers_match_jax(efas, which, cmd, args, files, tmp_path,
                                capsys):
    path, ref_path = efas[which]
    outs = {}
    for pkg, fn in (("port", t_cli), ("jax", j_cli)):
        d = tmp_path / pkg
        d.mkdir()
        fill = {"efa": path, "ref": ref_path, "out": str(d / "out")}
        argv = [f"-{cmd}", path] + [a.format(**fill) for a in args]
        stdout = _run_cli(fn, argv, capsys)
        written = {f: open(f.format(**fill)).read() for f in files}
        if cmd == "efa_explode":
            written = {f: open(d / f).read() for f in sorted(os.listdir(d))}
        outs[pkg] = (stdout, list(written.values()), sorted(
            os.path.basename(f) for f in os.listdir(d)))
    assert outs["port"] == outs["jax"]


def test_fasta_handlers_match_jax(efas, tmp_path, capsys):
    """-qscore, -fa2efa, -cmp_msa and -eesort (the EA on the CPU here)."""
    path, ref_path = efas["port-made"]
    exploded = tmp_path / "x"
    exploded.mkdir()
    Ensemble.from_efa(path).msas[0].write_fasta(str(exploded / "a.afa"))
    Ensemble.from_efa(path).msas[2].write_fasta(str(exploded / "b.afa"))
    a, b = str(exploded / "a.afa"), str(exploded / "b.afa")
    for argv, files in (
            (["-qscore", a, "-ref", ref_path], []),
            (["-qscore", a, "-ref", ref_path, "-bysequence"], []),
            (["-fa2efa", a, b, "-output", "{out}"], ["{out}"]),
            (["-cmp_msa", a, "-ref", ref_path, "-output", "{out}"],
             ["{out}"]),
            (["-eesort", b, "-db", ref_path, "-output", "{out}",
              "-tsvout", "{out}.tsv"], ["{out}", "{out}.tsv"])):
        outs = []
        for pkg, fn, extra in (("port", t_cli, ["-device", "cpu"]),
                               ("jax", j_cli, [])):
            out = str(tmp_path / f"{argv[0][1:]}.{pkg}")
            cmd = [x.format(out=out) for x in argv]
            if argv[0] == "-eesort":
                cmd += extra
            stdout = _run_cli(fn, cmd, capsys)
            outs.append((stdout.replace(out, "OUT"),
                         [open(f.format(out=out)).read() for f in files]))
        assert outs[0] == outs[1], argv[0]


def test_host_copies_equal_jax(efas):
    """qscore.py and msatools.py: the port's copies give muscle_tpu's
    results."""
    path, ref_path = efas["port-made"]
    ref, jref = MultiSequence.from_fasta(ref_path), JMS.from_fasta(ref_path)
    ens = Ensemble.from_efa(path)
    for m in ens.msas:
        jm = JMS.from_fasta_text(m.to_fasta_text())
        for by_seq in (False, True):
            assert qscore(m, ref, by_sequence=by_seq) == \
                j_qscore(jm, jref, by_sequence=by_seq)
        assert np.array_equal(ref_letter_counts(m, ref), j_rlc(jm, jref))
        for name, args in (("strip_gappy_cols", (0.5,)),
                           ("strip_gappy_rows", (0.5,)),
                           ("relabel", ({m[0].label: "renamed"},)),
                           ("make_a2m", (0.5,)),
                           ("squeeze_inserts", (0.5,))):
            got = getattr(t_mt, name)(m, *args)
            want = getattr(j_mt, name)(jm, *args)
            assert got.to_fasta_text() == want.to_fasta_text(), name
        assert t_mt.trim_to_ref(m, ref).to_fasta_text() == \
            j_mt.trim_to_ref(jm, jref).to_fasta_text()
        assert t_mt.core_blocks(m, 2, 2) == j_mt.core_blocks(jm, 2, 2)


def _align_both(tmp_path, inp, opts, files=("out.afa",), cmd="align"):
    """run_align_command of both packages; returns [(port text, jax
    text)] for each of `files` (written in each package's directory)."""
    from muscle_tpu.pipeline.ensemble import run_align_command as j_run
    texts = {}
    for pkg, fn, extra in (("port", run_align_command, {"device": "cpu"}),
                           ("jax", j_run, {})):
        d = tmp_path / pkg
        d.mkdir(parents=True, exist_ok=True)
        o = {k: (str(d / v) if k in ("hmmout", "guidetreeout") else v)
             for k, v in opts.items()}
        fn(cmd, str(inp), str(d / files[0]), {**o, **extra})
        texts[pkg] = [open(d / f).read() for f in files]
    return list(zip(texts["port"], texts["jax"]))


def test_mega_replicates_take_the_serial_loop(tmp_path):
    inp = tmp_path / "set.mega"
    inp.write_text(mega_text(4, 50, 70, 21))
    for mine, theirs in _align_both(tmp_path, inp,
                                    {"replicates": "2", "refineiters": "3"},
                                    ("ens.efa",)):
        assert mine == theirs
        assert mine.count("<") == 2


def test_tree_order_and_hmm_options_match_jax(tmp_path):
    """-guidetreeout writes the run's tree; -guidetreein takes one (here
    that tree, permuted by -perm acb in a first run); -input_order;
    -hmmout writes the (perturbed) HMM, -hmmin reads one."""
    inp = tmp_path / "bb.fa"
    inp.write_text(MultiSequence.from_fasta(GOLDEN, strip_gaps=True)
                   .to_fasta_text())
    pairs = _align_both(tmp_path / "a", inp,
                        {"perm": "acb", "perturb": "2", "refineiters": "3",
                         "guidetreeout": "tree.nwk", "hmmout": "hmm.txt"},
                        ("out.afa", "tree.nwk", "hmm.txt"))
    for mine, theirs in pairs:
        assert mine == theirs
    tree = tmp_path / "a" / "port" / "tree.nwk"
    hmm = tmp_path / "a" / "port" / "hmm.txt"
    for opts in ({"guidetreein": str(tree), "refineiters": "3"},
                 {"input_order": True, "refineiters": "3"},
                 {"hmmin": str(hmm), "refineiters": "3"},
                 {"guidetreein": str(tree), "replicates": "2",
                  "refineiters": "2"}):
        (mine, theirs), = _align_both(tmp_path / str(len(opts)) /
                                      "_".join(sorted(opts)), inp, opts)
        assert mine == theirs, opts
    labels = [ln[1:] for ln in mine.splitlines() if ln.startswith(">")]
    assert len(labels) > 0
    # with -guidetreeout, -input_order leaves the rows as the run gave them
    for mine, theirs in _align_both(
            tmp_path / "b", inp, {"guidetreeout": "tree.nwk",
                                  "input_order": True, "refineiters": "3"},
            ("out.afa", "tree.nwk")):
        assert mine == theirs


@pytest.mark.parametrize("argv", [
    ["-super5", "{inp}", "-nt"],
    ["-align", "{inp}", "-minsuper", "2", "-nt"],
], ids=["super5-nt", "minsuper-nt"])
def test_mega_input_is_amino_under_super5(tmp_path, argv, capsys):
    """A `.mega` input aligns as amino acids whatever -nt says, as in
    muscle_tpu (pipeline/ensemble.py forces it before any dispatch)."""
    inp = tmp_path / "set.mega"
    inp.write_text(mega_text(4, 40, 60, 22))
    texts = []
    for pkg, fn, extra in (("port", t_cli, ["-device", "cpu"]),
                           ("jax", j_cli, [])):
        out = tmp_path / f"{pkg}.afa"
        cmd = [a.format(inp=inp) for a in argv] + [
            "-output", str(out), "-refineiters", "2"] + extra
        _run_cli(fn, cmd, capsys)
        texts.append(out.read_text())
    assert texts[0] == texts[1]
