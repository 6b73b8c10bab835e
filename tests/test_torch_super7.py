"""Super7 of muscle_tpu_torch against muscle_tpu's, on the CPU.

* get_shrubs and prune_to_shrub_tree give JAX's shrubs and pruned tree
  on UPGMA trees of 20 leaves at sizes 1, 3, 7 and 32;
* Super7.run's text equals JAX's on 8 letter sequences at shrub_size 3
  with each guide tree source: the SW tree (kernel sw_scores' twin), a
  distance matrix and a given tree (refine_iters=2);
* on an 8-chain `.mega` set (tests/mega_synth.py) through MegaPProg,
  whose pair stores come from the mega emissions, the text equals JAX's
  too.
"""

import numpy as np
import pytest
import torch

import muscle_tpu
from muscle_tpu.alphabet import ALPHA_AMINO as J_AMINO
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.io import mega as j_mega
from muscle_tpu.pipeline import super7 as j_s7
from muscle_tpu.tree.tree import Tree as JTree
from muscle_tpu.tree.upgma import upgma5 as j_upgma5
from muscle_tpu_torch import MultiSequence, Sequence
from muscle_tpu_torch.alphabet import ALPHA_AMINO
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.io import mega as t_mega
from muscle_tpu_torch.pipeline import super7 as t_s7
from muscle_tpu_torch.tree.tree import Tree
from muscle_tpu_torch.tree.upgma import upgma5
from mega_synth import mega_text


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU scans run many small ops, which gain nothing from
    intra-op threads; one thread keeps them from crowding the other
    workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _dist(n, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)).astype(np.float32)
    d = ((m + m.T) / 2).astype(np.float32)
    np.fill_diagonal(d, 0)
    return d


@pytest.mark.parametrize("size", [1, 3, 7, 32])
def test_shrubs_and_pruned_tree_match_jax(size):
    labels = [f"s{i}" for i in range(20)]
    d = _dist(20)
    t, jt = upgma5(labels, d, "avg"), j_upgma5(labels, d, "avg")
    lcas = t_s7.get_shrubs(t, size)
    assert lcas == j_s7.get_shrubs(jt, size)
    assert [t.subtree_leaves(a) for a in lcas] == [jt.subtree_leaves(a)
                                                  for a in lcas]
    if len(lcas) == 1:
        with pytest.raises(ValueError):
            t_s7.prune_to_shrub_tree(t, lcas)
        return
    st, names = t_s7.prune_to_shrub_tree(t, lcas)
    jst, jnames = j_s7.prune_to_shrub_tree(jt, lcas)
    assert names == jnames
    assert st.to_newick() == jst.to_newick()
    assert st.leaf_count == len(lcas)


def _letters():
    """tests/test_super7.py's family: 8 copies of one 38-residue root,
    3 substitutions each."""
    base = "MKVLITGGAGFIGSHLVDELLRRGHEVIVLDNLSTGKK"
    rng = np.random.default_rng(3)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    out = []
    for i in range(8):
        s = list(base)
        for _ in range(3):
            s[rng.integers(0, len(s))] = aas[rng.integers(0, 20)]
        out.append(f">q{i}\n{''.join(s)}\n")
    return "".join(out)


GUIDE = ("(((q0:1,q5:1):1,(q2:1,q3:1):1):1,"
         "(((q4:1,q1:1):1,q6:1):1,q7:1):1);")


@pytest.mark.parametrize("source", ["sw", "dist_mx", "guide_tree"])
def test_super7_letters_match_jax(source):
    text = _letters()
    seqs = MultiSequence.from_fasta_text(text)
    jseqs = muscle_tpu.MultiSequence.from_fasta_text(text)
    kw, jkw = {}, {}
    if source == "dist_mx":
        kw = jkw = {"dist_mx": _dist(8, seed=5)}
    elif source == "guide_tree":
        kw = {"guide_tree": Tree.from_newick(GUIDE)}
        jkw = {"guide_tree": JTree.from_newick(GUIDE)}
    ours = t_s7.Super7(shrub_size=3, refine_iters=2, device="cpu").run(
        seqs, HMMParams.from_defaults(), ALPHA_AMINO, **kw)
    ref = j_s7.Super7(shrub_size=3, refine_iters=2).run(
        jseqs, JHMMParams.from_defaults(), J_AMINO, **jkw)
    assert ours.to_fasta_text() == ref.to_fasta_text()


def test_super7_mega_matches_jax():
    """8 chains of 40-60 positions, shrub_size 3, the SW tree on the
    chains' amino letters: MegaPProg's joins give JAX's text."""
    text = mega_text(8, 40, 60, 17)
    tm, jm = t_mega.parse_mega(text), j_mega.parse_mega(text)
    seqs = MultiSequence([Sequence(lb, s) for lb, s in zip(tm.labels, tm.seqs)])
    jseqs = muscle_tpu.MultiSequence([muscle_tpu.Sequence(lb, s) for lb, s
                                      in zip(jm.labels, jm.seqs)])
    ours = t_s7.Super7(shrub_size=3, refine_iters=2, mega=tm,
                       device="cpu").run(seqs, HMMParams.from_defaults(),
                                         ALPHA_AMINO)
    ref = j_s7.Super7(shrub_size=3, refine_iters=2, mega=jm).run(
        jseqs, JHMMParams.from_defaults(), J_AMINO)
    assert ours.to_fasta_text() == ref.to_fasta_text()
    # more than one shrub: the joins went through MegaPProg
    from muscle_tpu_torch.ops.sw import sw_dist_matrix
    from muscle_tpu_torch.tree.upgma import scale_dist_mx
    tree = upgma5(seqs.labels(), scale_dist_mx(
        sw_dist_matrix(seqs, ALPHA_AMINO, device="cpu")), "avg")
    assert len(t_s7.get_shrubs(tree, 3)) > 1
