"""The port's host copies of the classic aligner and its helpers, against
muscle_tpu on the same inputs (in-repo data only):

* k-mer distances (66 and 33), Kimura distances, Clustal weights and
  the random chain tree bit-identical;
* `Muscle3.run` on the degapped BB11001 and BB11002 goldens
  text-identical, also under other parameters and with -treeiters 2;
* `m3_ensemble(replicates=4)`'s EFA text, `m3_select(replicates=4)` and
  `m3_refine(iters=4)` identical.
"""

import io
import os

import numpy as np
import pytest

from muscle_tpu.pipeline import muscle3 as j_m3
from muscle_tpu.sequence import MultiSequence as JMS
from muscle_tpu.tree import clustalweights as j_cw
from muscle_tpu.tree import kimura as j_kim
from muscle_tpu.tree import kmerdist as j_km
from muscle_tpu.tree import randomchain as j_rc
from muscle_tpu.tree.upgma import upgma5 as j_upgma5
from muscle_tpu.utils.rng import MwcRng as JMwc
from muscle_tpu_torch.pipeline import muscle3 as t_m3
from muscle_tpu_torch.sequence import MultiSequence as TMS
from muscle_tpu_torch.tree import clustalweights as t_cw
from muscle_tpu_torch.tree import kimura as t_kim
from muscle_tpu_torch.tree import kmerdist as t_km
from muscle_tpu_torch.tree import randomchain as t_rc
from muscle_tpu_torch.tree.upgma import upgma5 as t_upgma5
from muscle_tpu_torch.utils.rng import MwcRng as TMwc

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens")
FAMILIES = ["BB11001", "BB11002"]


def _golden(fam, strip):
    path = os.path.join(GOLDEN, f"{fam}.seq.afa")
    return (TMS.from_fasta(path, strip_gaps=strip),
            JMS.from_fasta(path, strip_gaps=strip))


@pytest.mark.parametrize("fam", FAMILIES + ["BB11005"])
def test_distances_and_weights_bit_identical(fam):
    """kmer_dist_66/33 on the degapped golden, kimura_dist_mx on the
    aligned one, and the Clustal weights of a UPGMA tree over them."""
    ts, js = _golden(fam, True)
    for name in ("kmer_dist_66", "kmer_dist_33"):
        got = getattr(t_km, name)(ts)
        want = getattr(j_km, name)(js)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    ta, ja = _golden(fam, False)
    d, jd = t_kim.kimura_dist_mx(ta), j_kim.kimura_dist_mx(ja)
    assert np.array_equal(d, jd)
    for p in (0.1, 0.74, 0.8, 0.95):
        assert t_kim.kimura_dist(1.0 - p) == j_kim.kimura_dist(1.0 - p)
    tree = t_upgma5(ta.labels(), d, "biased")
    jtree = j_upgma5(ja.labels(), jd, "biased")
    assert np.array_equal(t_cw.clustal_weights(tree, ta.labels()),
                          j_cw.clustal_weights(jtree, ja.labels()))


@pytest.mark.parametrize("seed", [1, 7])
def test_random_chain_tree_identical(seed):
    labels = [f"s{i}" for i in range(9)]
    got = t_rc.random_chain_tree(labels, TMwc(seed))
    want = j_rc.random_chain_tree(labels, JMwc(seed))
    assert got.to_newick() == want.to_newick()
    assert (t_rc.random_chain_tree(labels).to_newick()
            == j_rc.random_chain_tree(labels).to_newick())


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("kw", [{}, {"kmer_dist": "33", "linkage": "avg",
                                     "tree_iters": 2, "gap_open": -7.5}],
                         ids=["defaults", "options"])
def test_muscle3_run_text_identical(fam, kw):
    ts, js = _golden(fam, True)
    t = t_m3.Muscle3(**kw)
    j = j_m3.Muscle3(**kw)
    assert t.run(ts).to_fasta_text() == j.run(js).to_fasta_text()
    assert np.array_equal(t.final_weights, j.final_weights)


def test_m3_ensembles_identical():
    """The EFA of m3_ensemble(replicates=4), m3_select(replicates=4) and
    m3_refine(iters=4) on BB11001 (degapped / aligned) and BB11002."""
    ts, js = _golden("BB11001", True)
    got, want = io.StringIO(), io.StringIO()
    t_m3.m3_ensemble(ts, got, replicates=4)
    j_m3.m3_ensemble(js, want, replicates=4)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("<") == 4
    assert (t_m3.m3_select(ts, replicates=4).to_fasta_text()
            == j_m3.m3_select(js, replicates=4).to_fasta_text())
    ta, ja = _golden("BB11002", False)
    assert (t_m3.m3_refine(ta, iters=4).to_fasta_text()
            == j_m3.m3_refine(ja, iters=4).to_fasta_text())


def test_perturbed_params_identical():
    """M3Params' MinStdRand perturbation of gap params, the substitution
    matrix and a distance matrix."""
    kw = dict(perturb_seed=3, perturb_substmx_delta=0.1,
              perturb_gap_delta=0.1, perturb_distmx_delta=0.1)
    t, j = t_m3.M3Params(80, 2, **kw), j_m3.M3Params(80, 2, **kw)
    assert (t.gap_open, t.center) == (j.gap_open, j.center)
    assert np.array_equal(t.subst, j.subst)
    d = np.random.default_rng(0).random((6, 6))
    d = d + d.T
    td, jd = d.copy(), d.copy()
    t.perturb_dist_mx(td)
    j.perturb_dist_mx(jd)
    assert np.array_equal(td, jd)
