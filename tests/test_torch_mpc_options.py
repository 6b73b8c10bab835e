"""MPC's options, PairAligner's batch size and the greedy PProg of the
port on the CPU, against muscle_tpu with the same arguments:

* `align(consistency_precision="highest")` on a synthetic family of
  n = 32 ("highest" keeps the panels f32 where "auto" rounds them to
  bf16 from n = 32), and `align(sparse_k=16)`, `align(batch_size=64)`
  and `align(random_chain_tree=True)` on n = 12, all on the blocked Gram
  branch (SMALL_DENSE_NL lowered in both packages; 66 pairs in calls of
  64 and 2), give muscle_tpu's MPC's text with the same arguments, and
  each option reaches the stage it sets (the pair store's K and batch,
  the consistency's precision; the random chain tree differs from
  UPGMA5's text);
* `PairAligner(batch_size=8)` gives muscle_tpu's EAs;
* the greedy `PProg.run` over 6 single-row MSAs gives muscle_tpu's text
  (host joins; its device joins are path_msas', which
  tests/test_torch_pprog.py holds), and `score_round` / `align_msas`
  its scores and path.
Families are mutated copies of one random protein, built as
tests/test_devjoin.py builds them.
"""

import numpy as np
import pytest
import torch

from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import mpc as j_mpc
from muscle_tpu.pipeline import posteriors as j_post
from muscle_tpu.pipeline import pprog as j_pp
from muscle_tpu.pipeline.pairwise import PairAligner as JPairAligner
from muscle_tpu.sequence import MultiSequence as JMS
from muscle_tpu_torch import align
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.pipeline import mpc as t_mpc
from muscle_tpu_torch.pipeline import posteriors as t_post
from muscle_tpu_torch.pipeline import pprog as t_pp
from muscle_tpu_torch.pipeline.pairwise import PairAligner
from muscle_tpu_torch.sequence import MultiSequence


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _family_text(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=hi)
    aas = "ARNDCQEGHILKMFPSTWYV"
    lines = []
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        mut = base[:ln].copy()
        nmut = int(rng.integers(0, ln // 3))
        pos = rng.integers(0, ln, size=nmut)
        mut[pos] = rng.integers(0, 20, size=nmut)
        lines.append(f">s{i}\n{''.join(aas[c] for c in mut)}\n")
    return "".join(lines)


CASES = [(32, {"consistency_precision": "highest"}), (12, {"sparse_k": 16}),
         (12, {"batch_size": 64}), (12, {"random_chain_tree": True})]


@pytest.mark.parametrize("n,kw", CASES,
                         ids=[f"n{n}-{next(iter(kw))}" for n, kw in CASES])
def test_mpc_option_matches_jax(monkeypatch, n, kw):
    monkeypatch.setattr(j_post, "SMALL_DENSE_NL", 64)
    monkeypatch.setattr(t_post, "SMALL_DENSE_NL", 64)
    seen = {}

    def spy(name, fn, keys):
        def wrapped(*a, **k):
            seen[name] = {key: k.get(key) for key in keys}
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_post, "all_pairs_posteriors_sparse", spy(
        "store", t_post.all_pairs_posteriors_sparse, ("batch_size", "k")))
    monkeypatch.setattr(t_mpc, "consistency_sparse", spy(
        "consistency", t_mpc.consistency_sparse, ("precision",)))
    text = _family_text(n, 30, 60, 5)
    got = align(MultiSequence.from_fasta_text(text), refine_iters=2,
                device="cpu", **kw)
    want = j_mpc.MPC(refine_iters=2, **kw).run(
        JMS.from_fasta_text(text), JHMMParams.from_defaults(nucleo=False),
        "amino")
    assert got.to_fasta_text() == want.to_fasta_text()
    assert seen["store"] == {"batch_size": kw.get("batch_size", 256),
                             "k": kw.get("sparse_k", 32)}
    assert seen["consistency"] == {
        "precision": kw.get("consistency_precision",
                            "default" if n >= 32 else "highest")}
    if kw.get("random_chain_tree"):
        upgma = align(MultiSequence.from_fasta_text(text), refine_iters=2,
                      device="cpu")
        assert upgma.to_fasta_text() != got.to_fasta_text()


def test_pair_aligner_batch_size_matches_jax():
    text = _family_text(7, 30, 120, 6)
    pack = HMMParams.from_defaults(nucleo=False).to_scores()
    jpack = JHMMParams.from_defaults(nucleo=False).to_scores()
    pairs = [(i, j) for i in range(7) for j in range(7) if i != j][:20]
    al = PairAligner(MultiSequence.from_fasta_text(text), pack, "amino",
                     device="cpu", batch_size=8)
    assert al.batch_size == 8
    want = JPairAligner(JMS.from_fasta_text(text), jpack, "amino",
                        batch_size=8).ea(pairs)
    assert np.array_equal(np.asarray(al.ea(pairs)), np.asarray(want))


def _pprogs(text):
    """(port PProg, JAX PProg, port leaves, JAX leaves) over single-row
    MSAs of the family."""
    seqs = MultiSequence.from_fasta_text(text)
    jseqs = JMS.from_fasta_text(text)
    l2g = {s.label: i for i, s in enumerate(seqs)}
    pp = t_pp.PProg(PairAligner(
        seqs, HMMParams.from_defaults(nucleo=False).to_scores(), "amino",
        device="cpu"), l2g)
    jpp = j_pp.PProg(JPairAligner(
        jseqs, JHMMParams.from_defaults(nucleo=False).to_scores(), "amino"),
        l2g)
    return (pp, jpp, [MultiSequence([s]) for s in seqs],
            [JMS([s]) for s in jseqs])


def test_greedy_pprog_run_matches_jax(monkeypatch):
    monkeypatch.setenv("MUSCLE_TPU_DEVICE_REFINE", "0")
    pp, jpp, leaves, jleaves = _pprogs(_family_text(6, 40, 80, 8))
    got = pp.run(leaves)
    want = jpp.run(jleaves)
    assert got.to_fasta_text() == want.to_fasta_text()
    assert sorted(got.labels()) == [f"s{i}" for i in range(6)]


def test_score_round_and_align_msas_match_jax():
    pp, jpp, leaves, jleaves = _pprogs(_family_text(5, 40, 80, 9))
    items = [(0, 1), (2, 4), (3, 1)]
    got = pp.score_round(items, leaves)
    want = jpp.score_round(items, jleaves)
    assert [got[k][0] for k in items] == [want[k][0] for k in items]
    for k in items:
        assert got[k][1].randu32() == want[k][1].randu32()
    assert (pp.align_msas(leaves[0], leaves[2])
            == jpp.align_msas(jleaves[0], jleaves[2]))
