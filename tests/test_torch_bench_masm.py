"""The port's host copies of the muscle3 benchmark sweeps and of MASM,
against muscle_tpu on in-repo data:

* -bench, -sweep and -spatter (pipeline/bench3.py) give the same lines,
  results and TSV files on a names file and refdir made from two
  goldens, as tests/test_bench3.py's fixture builds them
  (-bench_blosums through the CLI: tests/test_torch_surface_cli.py);
* a MASM trained from a muscle3 alignment of a synthetic 8-feature
  .mega set (tests/mega_synth.py) has the same text in both packages,
  reads back to the same text, and scores and aligns each profile of
  the set (sw_vs_profile) with the same score, path and start.
"""

import os
import sys

import numpy as np
import pytest

from muscle_tpu.io.mega import parse_mega as j_parse_mega
from muscle_tpu.pipeline import bench3 as j_b3
from muscle_tpu.pipeline.masm import MASM as JMASM
from muscle_tpu.sequence import MultiSequence as JMS
from muscle_tpu_torch.io.mega import parse_mega as t_parse_mega
from muscle_tpu_torch.pipeline import bench3 as t_b3
from muscle_tpu_torch.pipeline.masm import MASM as TMASM
from muscle_tpu_torch.pipeline.muscle3 import Muscle3
from muscle_tpu_torch.sequence import MultiSequence, Sequence

sys.path.insert(0, os.path.dirname(__file__))
from mega_synth import mega_text  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens")


def _bench_dir(tmp_path, names):
    for name in names:
        with open(os.path.join(GOLDEN, name.replace(".afa", ".seq.afa"))) as f:
            (tmp_path / name).write_text(f.read())
    names_file = tmp_path / f"names{len(names)}.txt"
    names_file.write_text("".join(n + "\n" for n in names))
    return str(names_file), str(tmp_path)


@pytest.fixture()
def bench_dir(tmp_path):
    return _bench_dir(tmp_path, ["BB11001.afa", "BB11002.afa"])


def _both(fn_name, names_file, opts, tmp_path):
    """Run bench3.<fn_name> of each package; (lines, result, tsv text)."""
    out = {}
    for pkg, mod in (("port", t_b3), ("jax", j_b3)):
        o = dict(opts)
        if "tsvout" in o:
            o["tsvout"] = str(tmp_path / f"{pkg}.tsv")
        lines = []
        kw = {} if fn_name == "run_bench" else {"out": lines.append}
        res = getattr(mod, fn_name)(names_file, o, **kw)
        tsv = open(o["tsvout"]).read() if "tsvout" in o else None
        out[pkg] = (lines, res, tsv)
    return out


@pytest.mark.parametrize("fn_name,opts", [
    ("run_bench", {"tsvout": ""}),
    ("run_bench", {"blosumpct": "70", "paramset": "2", "treeiters": "2"}),
    ("run_sweep", {"gridspec": "gapopen,-6,-7,-5,2/center,0.8,0.6,1.0,2"}),
    ("run_spatter", {"gridspec": "gapopen,-6,-8,-4,3", "warmup_pct": "50",
                     "maxiters": "2", "maxfailiters": "1",
                     "triesperiter": "2", "shrink": "0.6",
                     "randseed": "3"}),
], ids=["bench", "bench-params", "sweep", "spatter"])
def test_bench_tools_identical(bench_dir, tmp_path, fn_name, opts):
    names_file, ref_dir = bench_dir
    got = _both(fn_name, names_file, dict(opts, refdir=ref_dir), tmp_path)
    assert got["port"] == got["jax"]


def test_parse_grid_spec_identical():
    for spec in ("gapopen,-6,-8,-4,3/center,0.8,0.4,1.2,3",
                 "gapopen,-,-8,-4,3"):
        assert t_b3.parse_grid_spec(spec) == j_b3.parse_grid_spec(spec)


@pytest.fixture(scope="module")
def masm_inputs(tmp_path_factory):
    """(mega path, aligned FASTA path) of an 8-chain synthetic set, the
    alignment by the port's muscle3 over the chains' amino letters."""
    d = tmp_path_factory.mktemp("masm")
    mega_path = d / "set.mega"
    mega_path.write_text(mega_text(8, 60, 90, 21))
    mega = t_parse_mega(str(mega_path))
    seqs = MultiSequence([Sequence(lb, sq)
                          for lb, sq in zip(mega.labels, mega.seqs)])
    aln_path = d / "set.afa"
    Muscle3().run(seqs).write_fasta(str(aln_path))
    return str(mega_path), str(aln_path)


def test_masm_identical(masm_inputs, tmp_path):
    mega_path, aln_path = masm_inputs
    t = TMASM.from_msa(MultiSequence.from_fasta(aln_path),
                       t_parse_mega(mega_path), "fam")
    j = JMASM.from_msa(JMS.from_fasta(aln_path), j_parse_mega(mega_path),
                       "fam")
    text = t.to_text()
    assert text == j.to_text()
    t.to_file(str(tmp_path / "fam.masm"))
    back, jback = (TMASM.from_file(str(tmp_path / "fam.masm")),
                   JMASM.from_text(text))
    assert back.to_text() == jback.to_text()
    assert (back.seq_count, back.col_count, back.feature_names,
            back.alpha_sizes) == (jback.seq_count, jback.col_count,
                                  jback.feature_names, jback.alpha_sizes)
    assert np.array_equal(t.col_gap_open, j.col_gap_open)
    mega = t_parse_mega(mega_path)
    for prof in mega.profiles:
        assert np.array_equal(t.smx_vs_profile(prof), j.smx_vs_profile(prof))
        assert t.sw_vs_profile(prof) == j.sw_vs_profile(prof)
        assert back.sw_vs_profile(prof) == jback.sw_vs_profile(prof)
