"""Ensemble replicates: the port's batched replicate loop against the JAX
package and against its own serial loop, on the CPU.

* `posteriors.ensemble_pairs_posteriors_sparse` (every (replicate, pair)
  lane with its own tables, JAX's buckets and chunks) against
  muscle_tpu's on 5 sequences of L 30-46 with 2 packs: the store's
  columns equal, values and EA within 1e-5 (the two CPU scans); each
  replicate's slice equal to the port's single-pack store;
* `ensemble_batch.run_replicates_batched` text equal to muscle_tpu's and
  to the port's serial loop (one MPC per replicate);
* `ensemble.run_align_command` EFA text equal to muscle_tpu's for
  `-stratified` on degapped BB11001 (refine cut to 4), `-replicates 3
  -perm abc`, and `@` wildcard file names; `-replicates` on a family
  padded beyond the batched stream's limit takes the serial loop.
The multi kernels' plain versions: tests/test_torch_ensemble_kernels.py;
the EFA tools and the serial-loop inputs: tests/test_torch_efa.py.
"""

import os

import numpy as np
import pytest
import torch

from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import ensemble as j_ens
from muscle_tpu.pipeline import posteriors as j_post
from muscle_tpu.pipeline.ensemble_batch import \
    run_replicates_batched as j_batched
from muscle_tpu.sequence import MultiSequence as JMS
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.pipeline import ensemble as t_ens
from muscle_tpu_torch.pipeline import posteriors as t_post
from muscle_tpu_torch.pipeline.ensemble_batch import run_replicates_batched
from muscle_tpu_torch.pipeline.mpc import MPC
from muscle_tpu_torch.sequence import MultiSequence, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BB11001 = os.path.join(ROOT, "tests", "goldens", "BB11001.seq.afa")
AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU scan runs many small ops, which gain nothing from
    intra-op threads; one thread keeps it from crowding the other test
    workers on the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand_seqs(n, seed, lo=30, hi=46):
    rng = np.random.default_rng(seed)
    return MultiSequence([
        Sequence(f"s{i}", "".join(AA[k] for k in
                                  rng.integers(0, 20, int(rng.integers(lo, hi)))))
        for i in range(n)])


def _packs(cls, seeds=(0, 3)):
    out = []
    for s in seeds:
        hp = cls.from_defaults(nucleo=False)
        if s:
            hp.perturb(s)
        out.append(hp.to_scores())
    return out


def test_ensemble_store_matches_jax_and_per_pack():
    seqs = _rand_seqs(5, 7)
    codes, lens = t_post.encode_batch(seqs, "amino", pad_to=64)
    n = len(seqs)
    pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
    sv, sc, ea, nnz = t_post.ensemble_pairs_posteriors_sparse(
        codes, lens, _packs(HMMParams), pairs, "cpu")
    jv, jc, jea, jnnz = j_post.ensemble_pairs_posteriors_sparse(
        codes, lens, _packs(JHMMParams), pairs)
    jv, jc = np.asarray(jv), np.asarray(jc)
    assert sv.shape == jv.shape and ea.shape == jea.shape == (2, len(pairs))
    assert np.array_equal(sc.numpy(), jc)
    assert np.abs(sv.numpy() - jv).max() < 1e-5
    assert np.abs(ea - jea).max() < 1e-5 and nnz == jnnz
    for r, pk in enumerate(_packs(HMMParams)):
        v1, c1, ea1, _ = t_post.all_pairs_posteriors_sparse(
            codes, lens, pk, pairs, "cpu")
        assert torch.equal(sv[r], v1) and torch.equal(sc[r], c1)
        assert np.array_equal(ea[r], ea1)


def _load(cls):
    return lambda: cls.from_defaults(nucleo=False)


def test_batched_replicates_match_jax_and_serial_loop():
    seqs = _rand_seqs(6, 8)
    jseqs = JMS.from_fasta_text(seqs.to_fasta_text())
    reps = [(0, "none"), (1, "abc"), (1, "acb"), (2, "bca")]
    got = list(run_replicates_batched(seqs, reps, _load(HMMParams), "amino",
                                      2, 4, "cpu"))
    want = list(j_batched(jseqs, reps, _load(JHMMParams), "amino", 2, 4))
    for (seed, perm), (s, p, msa), (_, _, jmsa) in zip(reps, got, want):
        assert (s, p) == (seed, perm)
        assert msa.to_fasta_text() == jmsa.to_fasta_text(), (seed, perm)
        hp = HMMParams.from_defaults(nucleo=False)
        if seed > 0:
            hp.perturb(seed)
        serial = MPC(consistency_iters=2, refine_iters=4, tree_perm=perm,
                     device="cpu").run(seqs, hp, "amino")
        assert msa.to_fasta_text() == serial.to_fasta_text(), (seed, perm)


def _run_both(tmp_path, inp, out_name, opts):
    """run_align_command of both packages on one input; returns the two
    output paths (the port's under port/, JAX's under jax/)."""
    outs = []
    for pkg, fn, extra in (("port", t_ens.run_align_command,
                            {"device": "cpu"}),
                           ("jax", j_ens.run_align_command, {})):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        out = str(d / out_name)
        fn("align", str(inp), out, {**opts, **extra})
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def bb11001(tmp_path_factory):
    p = tmp_path_factory.mktemp("bb") / "bb11001.fa"
    p.write_text(MultiSequence.from_fasta(BB11001, strip_gaps=True)
                 .to_fasta_text())
    return p


@pytest.mark.parametrize("opts", [
    {"stratified": True, "refineiters": "4"},
    {"replicates": "3", "perm": "abc", "refineiters": "4"},
], ids=["stratified", "replicates-3-abc"])
def test_run_align_command_efa_matches_jax(tmp_path, bb11001, opts):
    mine, theirs = _run_both(tmp_path, bb11001, "ens.efa", opts)
    text = open(mine).read()
    assert text == open(theirs).read()
    heads = [ln for ln in text.splitlines() if ln.startswith("<")]
    if "stratified" in opts:
        assert heads == [f"<{p}.{s}" for s in range(4)
                         for p in t_ens.TREE_PERM_NAMES]
    else:
        assert heads == ["<abc.0", "<abc.1", "<abc.2"]


def test_run_align_command_wildcard_files_match_jax(tmp_path, bb11001):
    opts = {"replicates": "2", "refineiters": "3"}
    mine, theirs = _run_both(tmp_path, bb11001, "rep_@.afa", opts)
    for perm, seed in (("none", 0), ("abc", 1)):
        a = t_ens.make_replicate_file_name(mine, perm, seed)
        b = j_ens.make_replicate_file_name(theirs, perm, seed)
        assert os.path.basename(a) == f"rep_{perm}.{seed}.afa"
        assert open(a).read() == open(b).read()
    with pytest.raises(ValueError, match="'@' not found"):
        t_ens.make_replicate_file_name("x.afa", "none", 0)


def test_long_pad_takes_the_serial_loop(tmp_path, monkeypatch):
    """A family padded beyond the batched stream's limit (shrunk here)
    runs one MPC per replicate, as the JAX package's rule says."""
    from muscle_tpu_torch.pipeline import ensemble_batch
    inp = tmp_path / "in.fa"
    inp.write_text(_rand_seqs(4, 9).to_fasta_text())
    monkeypatch.setattr(t_post, "LONG_PAIR_THRESHOLD", 32)

    def refuse(*a, **k):
        raise AssertionError("the batched loop ran")
    monkeypatch.setattr(ensemble_batch, "run_replicates_batched", refuse)
    out = tmp_path / "out.efa"
    t_ens.run_align_command("align", str(inp), str(out),
                            {"replicates": "2", "refineiters": "2",
                             "device": "cpu"})
    ens = t_ens.Ensemble.from_efa(str(out))
    assert ens.names == ["none.0", "abc.1"]
    hp = HMMParams.from_defaults(nucleo=False)
    hp.perturb(1)
    seqs = MultiSequence.from_fasta(str(inp))
    want = MPC(refine_iters=2, tree_perm="abc", device="cpu").run(
        seqs, hp, "amino")
    got = {s.label: s.text() for s in ens.msas[1]}
    assert got == {s.label: s.text().upper() for s in want}
