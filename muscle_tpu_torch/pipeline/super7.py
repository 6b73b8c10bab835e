"""Super7 — shrub-partitioned alignment for large structure sets (torch
port of muscle_tpu.pipeline.super7).

reference: src/super7.cpp:9-179, src/shrub.cpp:6-37 — a supplied or
computed guide tree is partitioned into "shrubs" (maximal subtrees with
<= shrub_size leaves); each shrub is aligned with MPC, then the shrub
MSAs are joined by PProg following the shrub-collapsed guide tree.

Guide tree sources (reference: cmd_super7 src/super7.cpp:139-179):
-guidetreein Newick, -distmxin (reseek distance matrix -> UPGMA avg),
or the all-pairs SW-BLOSUM62 similarities (ops/sw.sw_dist_matrix:
kernel sw_scores on the card) rescaled -> UPGMA avg.
"""

from __future__ import annotations

import sys

import numpy as np

from ..hmm.params import HMMParams
from ..sequence import MultiSequence
from ..tree.joinorder import guide_tree_join_order
from ..tree.tree import Tree
from ..tree.upgma import LINKAGE_AVG, scale_dist_mx, upgma5
from ..utils import logging as mlog
from ..utils.device import resolve_device
from .cluster_batch import run_clusters_batched
from .mpc import DEFAULT_CONSISTENCY_ITERS, DEFAULT_REFINE_ITERS, MPC
from .pairwise import PairAligner
from .pprog import PProg

DEFAULT_SHRUB_SIZE = 32   # reference: src/super7.cpp cmd_super7 default


def get_shrubs(tree: Tree, max_size: int) -> list[int]:
    """Non-overlapping subtree LCAs covering all leaves, each subtree
    with <= max_size leaves (reference: src/shrub.cpp:6-37)."""
    sizes = tree.subtree_leaf_counts()
    if sizes[tree.root] <= max_size:
        return [tree.root]
    lcas = []
    covered = 0
    for node in range(tree.node_count):
        if node == tree.root:
            continue
        if sizes.get(node, 0) <= max_size and \
                sizes.get(tree.parent[node], 0) > max_size:
            lcas.append(node)
            covered += sizes[node]
    assert covered == tree.leaf_count
    return lcas


def prune_to_shrub_tree(tree: Tree, lcas: list[int],
                        prefix: str = "Shrub_") -> tuple[Tree, list[str]]:
    """Collapse each shrub LCA into a leaf named prefix+i
    (reference: Tree::PruneTree src/tree4.cpp:168)."""
    lca_set = {node: i for i, node in enumerate(lcas)}
    labels = [f"{prefix}{i}" for i in range(len(lcas))]
    if len(lcas) == 1:
        raise ValueError("single shrub needs no pruned tree")

    lefts, rights, leaf_order = [], [], []

    def rec(node: int):
        if node in lca_set:
            leaf_order.append(lca_set[node])
            return ("leaf", len(leaf_order) - 1)
        l = rec(tree.left[node])
        r = rec(tree.right[node])
        lefts.append(l)
        rights.append(r)
        return ("join", len(lefts) - 1)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * tree.node_count + 100))
    try:
        rec(tree.root)
    finally:
        sys.setrecursionlimit(old)

    n = len(leaf_order)
    leaf_labels = [labels[leaf_order[k]] for k in range(n)]
    conv = lambda ref: ref[1] if ref[0] == "leaf" else n + ref[1]
    t = Tree.from_joins(leaf_labels,
                        [conv(l) for l in lefts], [conv(r) for r in rights])
    return t, labels


class Super7:
    def __init__(self, shrub_size: int = DEFAULT_SHRUB_SIZE,
                 consistency_iters: int = DEFAULT_CONSISTENCY_ITERS,
                 refine_iters: int = DEFAULT_REFINE_ITERS,
                 mega=None, device=None):
        self.shrub_size = shrub_size
        self.consistency_iters = consistency_iters
        self.refine_iters = refine_iters
        self.mega = mega
        self.device = resolve_device(device)

    def run(self, seqs: MultiSequence, hp: HMMParams, alpha: str,
            guide_tree: Tree | None = None,
            dist_mx: np.ndarray | None = None) -> MultiSequence:
        labels = seqs.labels()
        if guide_tree is None:
            with mlog.stage("guide_tree"):
                if dist_mx is not None:
                    # reseek distance matrix (src/super7.cpp:156-162)
                    tree = upgma5(labels, dist_mx, LINKAGE_AVG)
                else:
                    # all-pairs SW-BLOSUM62 similarities, rescaled +
                    # UPGMA avg (src/swdistmx.cpp:88
                    # CalcGuideTree_SW_BLOSUM62)
                    from ..ops.sw import sw_dist_matrix
                    sim = sw_dist_matrix(seqs, alpha, device=self.device)
                    tree = upgma5(labels, scale_dist_mx(sim), LINKAGE_AVG)
        else:
            tree = guide_tree

        def make_mpc():
            return MPC(consistency_iters=self.consistency_iters,
                       refine_iters=self.refine_iters, mega=self.mega,
                       device=self.device)

        lcas = get_shrubs(tree, self.shrub_size)
        by_label = {s.label: s for s in seqs}
        if len(lcas) == 1:
            return make_mpc().run(seqs, hp, alpha)

        with mlog.stage("shrub_mpcs"):
            shrub_msas = run_clusters_batched(
                [MultiSequence([by_label[lb] for lb in
                                tree.subtree_leaves(lca)]) for lca in lcas],
                hp, alpha, make_mpc)

        shrub_tree, shrub_labels = prune_to_shrub_tree(tree, lcas)
        idx1, idx2 = guide_tree_join_order(
            shrub_tree, {lb: i for i, lb in enumerate(shrub_labels)})

        pack = hp.to_scores()
        with mlog.stage("pprog"):
            if self.mega is not None:
                pp = MegaPProg(self.mega, pack, seqs, self.device)
            else:
                aligner = PairAligner(seqs, pack, alpha, device=self.device)
                l2g = {s.label: i for i, s in enumerate(seqs)}
                pp = PProg(aligner, l2g)
            return pp.run_guide_tree(shrub_msas, idx1, idx2)


class MegaPProg(PProg):
    """PProg whose pair posteriors come from mega profile emissions.
    PProg.run_guide_tree asks its aligner only for `lens` and
    `sparse_store`; the JAX package's dense facade methods serve only
    its greedy PProg.run, which the port does not have."""

    def __init__(self, mega, pack, seqs: MultiSequence, device=None, **kw):
        from ..ops.emissions import pad_profiles
        from . import posteriors as post_mod
        device = resolve_device(device)
        prof_by_label = dict(zip(mega.labels, mega.profiles))
        profs = [prof_by_label[s.label] for s in seqs]
        lens = np.array([p.shape[0] for p in profs], dtype=np.int32)
        profiles = pad_profiles(profs, post_mod.round_up(int(lens.max()), 128))

        class _Aligner:
            def sparse_store(self, pairs):
                return post_mod.all_pairs_posteriors_mega_sparse(
                    profiles, lens, mega, pack, pairs, device)

        aligner = _Aligner()
        aligner.lens = lens
        super().__init__(aligner, {s.label: i for i, s in enumerate(seqs)},
                         **kw)
