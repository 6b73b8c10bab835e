"""The port's Super6 / Super7 commands against muscle_tpu.cli's, on the
CPU: -super6, -super7 (with -distmxin and -shrub_size), -uclustpd
(-maxpd, -tsvout, -threads), -protdists, -shrub (-n) and -swdistmx
(-guidetreeout) write the same text and the same "option -X was not
used" warnings, and stop with the same messages (the port run with
-device cpu, an option it never warns about)."""

import numpy as np
import pytest
import torch

from muscle_tpu.cli import main as j_main
from muscle_tpu_torch.cli import main as t_main
from muscle_tpu_torch.sequence import MultiSequence

GOLDEN = "tests/goldens/BB11001.seq.afa"
FAMILY = ("MKVLITGGAGFIGSHLVDELLRRGHEVIVLDNLSTGKK",
          "MKVLITGGAGFIGSHLVDKLLRRGHEVIVLDNLSTG",
          "MRVLITGGAGFIGSHLVDELLRQGHEVIVLDNLSTGKKA",
          "MKVLVTGGAGFIGSHLVDELLRRGYEVIVLDNLSSGKK",
          "MKVLITGGSGFIGSHLVDELIRRGHEVIVLDNLSTGRK",
          "MKILITGGAGFIGSHLVEELLRRGHEVIVLDNLSTGKK")


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _warnings(text):
    return [ln for ln in text.splitlines() if ln.startswith("WARNING:")]


def _run_both(capsys, tmp_path, argv_of):
    """argv_of(pkg) -> argv; returns {pkg: (stdout, warnings, files)}
    with each package's output files read back (named by pkg)."""
    out = {}
    for pkg, fn, extra in (("port", t_main, ["-device", "cpu"]),
                           ("jax", j_main, [])):
        capsys.readouterr()
        assert fn(argv_of(pkg) + extra) == 0
        got = capsys.readouterr()
        files = {p.name.split(".", 1)[1]: p.read_text()
                 for p in sorted(tmp_path.glob(f"{pkg}.*"))}
        out[pkg] = (got.out.replace(pkg, "PKG"), _warnings(got.err), files)
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.fixture
def inputs(tmp_path):
    """The degapped BB11001 golden and a 6-sequence family as FASTA
    files, the family's reseek distance matrix and a Newick tree."""
    bb = tmp_path / "bb.fa"
    MultiSequence.from_fasta(GOLDEN, strip_gaps=True).write_fasta(str(bb))
    fam = tmp_path / "fam.fa"
    fam.write_text("".join(f">q{i}\n{s}\n" for i, s in enumerate(FAMILY)))
    rng = np.random.default_rng(4)
    n = len(FAMILY)
    dmx = tmp_path / "fam.distmx"
    # labels in another order than the FASTA's: -distmxin permutes them
    order = [3, 0, 5, 1, 4, 2]
    dmx.write_text(f"distmx\t{n}\n"
                   + "".join(f"{k}\tq{order[k]}\n" for k in range(n))
                   + "".join(f"{i}\t{j}\t{rng.uniform(0.1, 1.0):.4f}\n"
                             for i in range(n) for j in range(i + 1, n)))
    tree = tmp_path / "t.nwk"
    tree.write_text("(((a:1,b:1):1,(c:1,(d:1,e:1):1):1):1,((f:1,g:1):1,"
                    "h:1):1);\n")
    return {"bb": str(bb), "fam": str(fam), "dmx": str(dmx),
            "tree": str(tree)}


def test_super6_cli_matches_jax(capsys, tmp_path, inputs):
    got = _run_both(capsys, tmp_path, lambda pkg: [
        "-super6", inputs["bb"], "-output", str(tmp_path / f"{pkg}.afa"),
        "-refineiters", "2", "-threads", "2", "-super6_maxpd1", "1.3",
        "-tree_order"])
    assert got[1] == ["WARNING: option -tree_order was not used by -super6"]
    assert got[2]["afa"].count(">") == 4


def test_super7_cli_matches_jax(capsys, tmp_path, inputs):
    """-distmxin (labels permuted into input order) and -shrub_size 2;
    then the SW tree at the default shrub size (one shrub: one MPC)."""
    got = _run_both(capsys, tmp_path, lambda pkg: [
        "-super7", inputs["fam"], "-output", str(tmp_path / f"{pkg}.afa"),
        "-distmxin", inputs["dmx"], "-shrub_size", "2", "-refineiters", "2",
        "-scaledist"])
    assert got[1] == ["WARNING: option -scaledist was not used by -super7"]
    for p in tmp_path.glob("*.afa"):
        p.unlink()
    _run_both(capsys, tmp_path, lambda pkg: [
        "-super7", inputs["fam"], "-output", str(tmp_path / f"{pkg}.afa"),
        "-refineiters", "2"])


def test_uclustpd_cli_matches_jax(capsys, tmp_path, inputs):
    got = _run_both(capsys, tmp_path, lambda pkg: [
        "-uclustpd", inputs["bb"], "-maxpd", "1.3", "-tsvout",
        str(tmp_path / f"{pkg}.tsv"), "-threads", "2", "-perm", "abc"])
    assert got[0].startswith("4 seqs, ")
    assert got[1] == ["WARNING: option -perm was not used by -uclustpd"]
    assert got[2]["tsv"].splitlines()[0].startswith("0\t")
    # without -tsvout the clusters go to stdout
    _run_both(capsys, tmp_path, lambda pkg: [
        "-uclustpd", inputs["fam"], "-maxpd", "0.2"])


def test_uclustpd_cli_errors_match_jax(inputs):
    for argv, msg in ((["-uclustpd", inputs["bb"]], "must set -maxpd"),
                      (["-uclustpd", inputs["bb"], "-maxpd", "1", "-output",
                        "x.tsv"], "use -tsvout not -output")):
        for fn in (t_main, j_main):
            with pytest.raises(SystemExit, match=msg):
                fn(argv + ["-device", "cpu"] if fn is t_main else argv)


def test_protdists_cli_matches_jax(capsys, tmp_path, inputs):
    got = _run_both(capsys, tmp_path, lambda pkg: [
        "-protdists", inputs["bb"], "-output", str(tmp_path / f"{pkg}.tsv")])
    assert len(got[2]["tsv"].splitlines()) == 6
    got = _run_both(capsys, tmp_path, lambda pkg: [
        "-protdists", inputs["fam"], "-maxpd", "3"])
    assert len(got[0].splitlines()) == 15
    assert got[1] == ["WARNING: option -maxpd was not used by -protdists"]


def test_shrub_and_swdistmx_cli_match_jax(capsys, tmp_path, inputs):
    for n in ("3", "32"):
        got = _run_both(capsys, tmp_path, lambda pkg: [
            "-shrub", inputs["tree"], "-n", n, "-output", "unused"])
        assert got[0].splitlines()[-1].endswith(f"max size {n}")
        assert got[1] == ["WARNING: option -output was not used by -shrub"]
    got = _run_both(capsys, tmp_path, lambda pkg: [
        "-swdistmx", inputs["fam"], "-guidetreeout",
        str(tmp_path / f"{pkg}.nwk")])
    assert got[2]["nwk"].startswith("(") and got[1] == []
