"""The port's CLI parser and top-level API against muscle_tpu's.

* `muscle_tpu_torch.cli.parse_args` gives muscle_tpu.cli.parse_args's
  command, input and options on argv lists with the flags -tree_order,
  -verbose, -reseek, -scaledist, -eadist and value options neither
  package reads; both mains then warn "option -X was not used by -cmd"
  about the same options and write the same text;
* each of six commands that once stopped with "not ported yet" parses
  as in muscle_tpu and writes muscle_tpu's output (every command:
  tests/test_torch_surface_cli.py);
* `muscle_tpu_torch.align(..., device="cpu")` under `input_order`,
  `guide_tree_in` and `hmm_params` gives muscle_tpu.align's text on a
  small synthetic family (built as tests/test_devjoin.py builds one);
* `muscle_tpu_torch.qscore` is exported and gives muscle_tpu's (Q, TC).
"""

import os

import numpy as np
import pytest
import torch

import muscle_tpu
import muscle_tpu_torch
from muscle_tpu.cli import main as j_main
from muscle_tpu.cli import parse_args as j_parse
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.qscore import qscore as j_qscore
from muscle_tpu.sequence import MultiSequence as JMS
from muscle_tpu.tree.tree import Tree as JTree
from muscle_tpu_torch.cli import main as t_main
from muscle_tpu_torch.cli import parse_args as t_parse
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.sequence import MultiSequence, Sequence
from muscle_tpu_torch.tree.tree import Tree

ARGVS = [
    ["-align", "x.fa", "-output", "o.afa", "-tree_order"],
    ["-align", "x.fa", "-verbose", "-output", "o.afa"],
    ["-align", "x.fa", "-reseek", "-scaledist", "-eadist", "-output",
     "o.afa"],
    ["-align", "x.fa", "-output", "o.afa", "-any_value_opt", "7",
     "-threads", "4", "-stratified"],
    ["-qscore", "t.afa", "-ref", "r.afa", "-bysequence", "-perm", "abc"],
    ["-fa2efa", "a.afa", "b.afa", "c.afa", "-output", "e.efa", "-verbose"],
    ["-tree_order", "-maxcc", "e.efa"],
    ["-output", "o.afa", "-align"],
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_parse_args_matches_jax(argv):
    """The same command, input and options as muscle_tpu's parser."""
    jc, jp, jo = j_parse(list(argv))
    tc, tp, to = t_parse(list(argv))
    assert (tc, tp, dict(to)) == (jc, jp, dict(jo))


def test_parse_errors_match_jax():
    """A value option at the end of the line and two commands fail in
    both parsers."""
    for argv in (["-align", "x.fa", "-output"],
                 ["-align", "x.fa", "-maxcc", "e.efa"]):
        with pytest.raises(SystemExit):
            j_parse(argv)
        with pytest.raises(SystemExit):
            t_parse(argv)


def _small_input(cmd, d):
    """argv (less -output) of `cmd` on a small input written into d."""
    seqs, _ = _family(n=4, lo=20, hi=30, seed=11)
    fa = d / "in.fa"
    seqs.write_fasta(str(fa))
    if cmd in ("kmerdist", "m3ensemble", "muscle3"):
        return [f"-{cmd}", str(fa)] + (["-replicates", "4"]
                                       if cmd == "m3ensemble" else [])
    from muscle_tpu_torch.pipeline.muscle3 import Muscle3
    afa = d / "in.afa"
    Muscle3().run(seqs).write_fasta(str(afa))
    if cmd == "msastats":
        return ["-msastats", str(afa)]
    if cmd == "upgma5":
        tsv = d / "d.tsv"
        tsv.write_text("s0\ts1\t0.2\ns0\ts2\t0.5\ns1\ts2\t0.4\n"
                       "s0\ts3\t0.7\ns1\ts3\t0.6\ns2\ts3\t0.3\n")
        return ["-upgma5", str(tsv)]
    # masm_train: a .mega set whose chains are the family's letters
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from mega_synth import mega_text
    from muscle_tpu_torch.io.mega import parse_mega
    mega_path = d / "set.mega"
    mega_path.write_text(mega_text(3, 20, 30, 5))
    mega = parse_mega(str(mega_path))
    Muscle3().run(MultiSequence([Sequence(lb, sq) for lb, sq in zip(
        mega.labels, mega.seqs)])).write_fasta(str(afa))
    return ["-masm_train", str(afa), "-input", str(mega_path), "-label",
            "fam"]


@pytest.mark.parametrize("cmd", ["kmerdist", "m3ensemble", "muscle3",
                                 "masm_train", "msastats", "upgma5"])
def test_unported_command_raises(cmd, tmp_path, capsys):
    """Six commands that stopped with "not ported yet" before they were
    ported: the port parses each as muscle_tpu does and runs it to
    muscle_tpu's output (stdout and the file written) on a small input."""
    argv = [f"-{cmd}", "x.fa", "-output", "o.afa"]
    tc, tp, to = t_parse(list(argv))
    jc, jp, jo = j_parse(list(argv))
    assert (tc, tp, dict(to)) == (jc, jp, dict(jo)) == (
        cmd, "x.fa", {"output": "o.afa"})
    base = _small_input(cmd, tmp_path)
    outs = {}
    for pkg, fn in (("port", t_main), ("jax", j_main)):
        out = tmp_path / f"{pkg}.out"
        capsys.readouterr()
        assert fn(base + ["-output", str(out)]) == 0
        outs[pkg] = (capsys.readouterr().out,
                     out.read_text() if out.exists() else None)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] or outs["port"][1]


def _family(n=7, lo=40, hi=70, seed=3):
    """A small protein family of mutated copies of one random sequence,
    as tests/test_devjoin.py builds one; (port, JAX) MultiSequences."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=hi)
    aas = b"ARNDCQEGHILKMFPSTWYV"
    seqs = MultiSequence()
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        mut = base[:ln].copy()
        nmut = int(rng.integers(0, ln // 3))
        pos = rng.integers(0, ln, size=nmut)
        mut[pos] = rng.integers(0, 20, size=nmut)
        seqs.add(Sequence(f"s{i}", bytes(aas[c] for c in mut)))
    return seqs, JMS.from_fasta_text(seqs.to_fasta_text())


def _warnings(text):
    return [ln for ln in text.splitlines() if ln.startswith("WARNING:")]


def test_unused_option_warnings_match_jax(tmp_path, capsys):
    """-align with the flags and a value option no command reads: both
    CLIs write the same alignment and warn about the same options in the
    same words, after the run."""
    seqs, _ = _family(n=5, lo=30, hi=45, seed=8)
    inp = tmp_path / "in.fa"
    seqs.write_fasta(str(inp))
    runs = {}
    for pkg, fn, extra in (("port", t_main, ["-device", "cpu"]),
                           ("jax", j_main, [])):
        out = tmp_path / f"{pkg}.afa"
        argv = ["-align", str(inp), "-output", str(out), "-tree_order",
                "-verbose", "-reseek", "-any_value_opt", "7",
                "-refineiters", "2", "-consiters", "1"] + extra
        capsys.readouterr()
        assert fn(argv) == 0
        err = capsys.readouterr().err
        runs[pkg] = (out.read_text(), _warnings(err))
    assert runs["port"] == runs["jax"]
    assert runs["port"][1] == [
        f"WARNING: option -{o} was not used by -align"
        for o in ("any_value_opt", "reseek", "tree_order", "verbose")]


def test_qscore_warnings_match_jax(tmp_path, capsys):
    """-qscore with options it does not read: the same line out and the
    same warnings; -device, the port's own option, is never warned
    about."""
    seqs, _ = _family(n=4, lo=20, hi=30, seed=9)
    msa = muscle_tpu_torch.align(seqs, device="cpu", refine_iters=1,
                                 consistency_iters=0)
    path = tmp_path / "t.afa"
    msa.write_fasta(str(path))
    outs = {}
    for pkg, fn, extra in (("port", t_main, ["-device", "cpu"]),
                           ("jax", j_main, [])):
        capsys.readouterr()
        assert fn(["-qscore", str(path), "-ref", str(path), "-perm", "abc",
                   "-eadist", "-threads", "3"] + extra) == 0
        got = capsys.readouterr()
        outs[pkg] = (got.out, _warnings(got.err))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == ["WARNING: option -eadist was not used by "
                               "-qscore", "WARNING: option -perm was not "
                               "used by -qscore"]


GUIDE = "(((s0:1,s1:1):1,(s2:1,s3:1):1):1,((s4:1,s5:1):1,s6:1):1);"


@pytest.mark.parametrize("kind", ["input_order", "guide_tree_in",
                                  "hmm_params"])
def test_align_keywords_match_jax(kind):
    """align() under each keyword gives muscle_tpu.align's text."""
    seqs, jseqs = _family()
    kw, jkw = {}, {}
    if kind == "input_order":
        kw = jkw = {"input_order": True}
    elif kind == "guide_tree_in":
        kw = {"guide_tree_in": Tree.from_newick(GUIDE)}
        jkw = {"guide_tree_in": JTree.from_newick(GUIDE)}
    else:
        hp, jhp = (HMMParams.from_defaults(nucleo=False),
                   JHMMParams.from_defaults(nucleo=False))
        hp.perturb(5)
        jhp.perturb(5)
        kw, jkw = {"hmm_params": hp}, {"hmm_params": jhp}
    got = muscle_tpu_torch.align(seqs, device="cpu", refine_iters=3, **kw)
    want = muscle_tpu.align(jseqs, refine_iters=3, **jkw)
    assert got.to_fasta_text() == want.to_fasta_text()
    if kind == "input_order":
        assert [s.label for s in got] == [s.label for s in seqs]


def test_qscore_is_exported():
    """muscle_tpu_torch.qscore, as muscle_tpu.qscore, gives (Q, TC), also
    after the submodule of that name has been imported (the CLI's
    -qscore imports it)."""
    import muscle_tpu_torch.cli  # noqa: F401
    from muscle_tpu_torch import qscore as t_qscore_mod  # noqa: F401
    seqs, jseqs = _family(n=4, lo=20, hi=30, seed=4)
    test = muscle_tpu_torch.align(seqs, device="cpu", refine_iters=1)
    ref = muscle_tpu_torch.align(seqs, device="cpu", refine_iters=1,
                                 consistency_iters=0)
    jt = JMS.from_fasta_text(test.to_fasta_text())
    jr = JMS.from_fasta_text(ref.to_fasta_text())
    assert muscle_tpu_torch.qscore(test, ref) == j_qscore(jt, jr)
    assert muscle_tpu_torch.qscore(test, test) == (1.0, 1.0)
