"""Super6's modules of muscle_tpu_torch against muscle_tpu's, on the CPU.

* tree/protdist: prot_dists_from_counts bit for bit on random counts,
  zero overlap and fits that blow up (-1), and the letter-pair counts;
* pipeline/uclustpd: ProtDistCalc on the degapped BB11001 golden gives
  JAX's distances and lies within 5e-4 of the reference binary's six
  (REF_PROTDISTS, copied from tests/test_super6.py, whose own test reads
  the unmounted reference tree); UClustPD gives JAX's clusters,
  centroids and assignment distances on a seeded 3-family set at max_pd
  0.3 and 1.5 with 1, 2 and 16 seeds an iteration, and on the golden at
  1.3 with 2 (first cluster of 2);
* pipeline/super6: Super6.run's text equals JAX's on the golden and on
  a synthetic set with max_cluster=4, which forces the split and the
  PProg joins (refine_iters=2).
"""

import numpy as np
import pytest
import torch

import muscle_tpu
from muscle_tpu.alphabet import ALPHA_AMINO as J_AMINO
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import uclustpd as j_uc
from muscle_tpu.tree import protdist as j_pd
from muscle_tpu_torch import MultiSequence, Sequence
from muscle_tpu_torch.alphabet import ALPHA_AMINO
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.pipeline import super6 as t_s6
from muscle_tpu_torch.pipeline import uclustpd as t_uc
from muscle_tpu_torch.tree import protdist as t_pd

GOLDEN = "tests/goldens/BB11001.seq.afa"

# the reference binary: muscle -protdists BB11001 (label-pair order i>j)
REF_PROTDISTS = {
    ("1j46_A", "1aab_"): 1.188,
    ("1k99_A", "1aab_"): 1.314,
    ("1k99_A", "1j46_A"): 1.406,
    ("2lef_A", "1aab_"): 1.339,
    ("2lef_A", "1j46_A"): 1.42,
    ("2lef_A", "1k99_A"): 1.406,
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The NW twin runs many small ops, which gain nothing from intra-op
    threads; one thread keeps it from crowding the other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _families_text(n_fam=3, per=4, lo=30, hi=50, seed=6, sub=(0.03, 0.08)):
    """n_fam families of `per` mutated copies (a fraction `sub` of the
    positions substituted, 0-2 indels) of a random root of `hi` residues,
    each truncated to lo..hi; rows interleaved by family."""
    rng = np.random.default_rng(seed)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    rows = []
    for f in range(n_fam):
        root = list(rng.integers(0, 20, hi))
        for i in range(per):
            m = list(root)
            for _ in range(int(rng.integers(0, 3))):
                p = int(rng.integers(0, len(m)))
                if rng.random() < 0.5:
                    del m[p:p + 2]
                else:
                    m[p:p] = rng.integers(0, 20, 2).tolist()
            m = np.array(m[:int(rng.integers(lo, hi + 1))])
            pos = rng.choice(len(m), int(rng.uniform(*sub) * len(m)),
                             replace=False)
            m[pos] = (m[pos] + rng.integers(1, 20, len(pos))) % 20
            rows.append((i, f, "".join(aas[c] for c in m)))
    rows.sort()
    return "".join(f">f{f}_{i}\n{s}\n" for i, f, s in rows)


def test_prot_dists_bit_identical_to_jax():
    """Random counts, a zero matrix (no overlap: -1), identity columns
    (the epsilon floor) and a scan of two-pair mixtures in which some
    fits blow up past 10000 (-1)."""
    rng = np.random.default_rng(0)
    counts = [np.round(rng.gamma(0.3, 1.0, (40, 20, 20))
                       * rng.uniform(1, 60, (40, 1, 1))),
              np.zeros((1, 20, 20)), np.eye(20)[None] * 3.0]
    mix = np.zeros((2000, 20, 20))
    mix[:, 11, 19] = 1.0
    mix[:, 18, 14] = np.linspace(0.01, 3, 2000)
    counts.append(mix)
    c = np.concatenate(counts)
    got = t_pd.prot_dists_from_counts(c)
    want = j_pd.prot_dists_from_counts(c)
    assert np.array_equal(got, want)
    total = c.sum(axis=(1, 2))
    assert got[40] == -1.0 and got[41] == pytest.approx(1e-5)
    assert ((got == -1.0) & (total > 0)).any()
    assert np.array_equal(t_pd.EIGS, j_pd.EIGS)
    assert np.array_equal(t_pd.PROBS, j_pd.PROBS)
    a = rng.integers(0, 21, 50)
    b = rng.integers(0, 21, 50)
    mp = [(k, (3 * k) % 50) for k in range(0, 50, 2)]
    assert np.array_equal(t_pd.pair_counts_from_match_pairs(a, b, mp),
                          j_pd.pair_counts_from_match_pairs(a, b, mp))


def test_protdistcalc_matches_jax_and_the_reference_binary():
    seqs = MultiSequence.from_fasta(GOLDEN, strip_gaps=True)
    jseqs = muscle_tpu.MultiSequence.from_fasta(GOLDEN, strip_gaps=True)
    idx = {s.label: i for i, s in enumerate(seqs)}
    pairs = [(idx[a], idx[b]) for (a, b) in REF_PROTDISTS]
    got = t_uc.ProtDistCalc(seqs, device="cpu").dists(pairs)
    want = j_uc.ProtDistCalc(jseqs).dists(pairs)
    assert np.array_equal(got, want)
    for k, (key, ref) in enumerate(REF_PROTDISTS.items()):
        assert got[k] == pytest.approx(ref, abs=5e-4), key
    assert (t_uc.DEFAULT_MAX_PD_PASS1, t_uc.DEFAULT_SEEDS_PER_ITER,
            t_uc.TARGET_PAIR_COUNT_CLUSTER_DIST) == (1.5, 16, 8)


def _uclustpd(text, max_pd, spi):
    seqs = MultiSequence.from_fasta_text(text)
    jseqs = muscle_tpu.MultiSequence.from_fasta_text(text)
    ours = t_uc.UClustPD(t_uc.ProtDistCalc(seqs, device="cpu"),
                         seeds_per_iter=spi)
    ref = j_uc.UClustPD(j_uc.ProtDistCalc(jseqs), seeds_per_iter=spi)
    got = ours.run(list(range(len(seqs))), max_pd)
    want = ref.run(list(range(len(jseqs))), max_pd)
    assert got == want
    assert ours.centroid_seq_indexes == ref.centroid_seq_indexes
    assert ours.assign_dist == ref.assign_dist
    return got


@pytest.mark.parametrize("max_pd", [0.3, 1.5])
@pytest.mark.parametrize("spi", [1, 2, 16])
def test_uclustpd_matches_jax(max_pd, spi):
    clusters = _uclustpd(_families_text(), max_pd, spi)
    assert sorted(i for c in clusters for i in c) == list(range(12))


def test_uclustpd_goes_on_where_jax_asserts():
    """Within-family distances of 0.3-0.6 at max_pd 0.3, one seed an
    iteration: no member joins the first seed, and muscle_tpu's phase 2
    asserts that one must (a fault of the JAX package: phase 1 already
    took the seed out of pending). The port goes on, as the reference's
    loop does: each sequence its own cluster and centroid."""
    text = _families_text(sub=(0.15, 0.3))
    jseqs = muscle_tpu.MultiSequence.from_fasta_text(text)
    with pytest.raises(AssertionError):
        j_uc.UClustPD(j_uc.ProtDistCalc(jseqs), seeds_per_iter=1).run(
            list(range(len(jseqs))), 0.3)
    seqs = MultiSequence.from_fasta_text(text)
    uc = t_uc.UClustPD(t_uc.ProtDistCalc(seqs, device="cpu"),
                       seeds_per_iter=1)
    clusters = uc.run(list(range(len(seqs))), 0.3)
    assert sorted(i for c in clusters for i in c) == list(range(12))
    assert [c[0] for c in clusters] == uc.centroid_seq_indexes
    assert len(clusters) == 12


def test_uclustpd_golden_matches_jax():
    """BB11001 at 1.3 with 2 seeds an iteration: 1aab_ and 1j46_A (1.188
    apart) share the first cluster."""
    text = MultiSequence.from_fasta(GOLDEN, strip_gaps=True).to_fasta_text()
    clusters = _uclustpd(text, 1.3, 2)
    assert len(clusters[0]) == 2


@pytest.mark.parametrize("case", ["golden", "split"])
def test_super6_matches_jax(case):
    """Super6.run's text equals muscle_tpu's: the golden (one UClustPD
    cluster, seeds_per_iter 2) and the 3-family set with max_cluster=4
    (chunks of 4 and PProg joins along the coarse tree)."""
    if case == "golden":
        seqs = MultiSequence.from_fasta(GOLDEN, strip_gaps=True)
        jseqs = muscle_tpu.MultiSequence.from_fasta(GOLDEN, strip_gaps=True)
        kw = {"seeds_per_iter": 2}
    else:
        text = _families_text()
        seqs = MultiSequence.from_fasta_text(text)
        jseqs = muscle_tpu.MultiSequence.from_fasta_text(text)
        kw = {"max_cluster": 4}
    from muscle_tpu.pipeline.super6 import Super6 as JSuper6
    ours = t_s6.Super6(refine_iters=2, device="cpu", **kw).run(
        seqs, HMMParams.from_defaults(nucleo=False), ALPHA_AMINO)
    ref = JSuper6(refine_iters=2, **kw).run(
        jseqs, JHMMParams.from_defaults(nucleo=False), J_AMINO)
    assert ours.to_fasta_text() == ref.to_fasta_text()
    run = t_s6.LAST_RUN
    assert run["seqs"] == len(seqs) and sum(run["clusters"]) == len(seqs)
    if case == "split":
        assert max(run["clusters"]) <= 4 and max(run["uclustpd"]) > 4
        assert sum(run["pprog_joins"].values()) == len(run["clusters"]) - 1
