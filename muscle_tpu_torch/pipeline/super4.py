"""Super4 — cluster / align-per-cluster / consensus / coarse-join.

Torch port of muscle_tpu.pipeline.super4 (reference: src/super4.cpp —
EACluster(minEA 0.7) -> split big clusters (EA 0.9 then random <= 500)
-> MPC per cluster -> consensus sequence per cluster MSA -> EA distance
matrix of consensi -> UPGMA(biased) -> PProg joins of the cluster MSAs
along the coarse guide tree).
"""

from __future__ import annotations

import numpy as np

from ..alphabet import alphabet_size
from ..hmm.params import HMMParams
from ..sequence import MultiSequence, Sequence
from ..tree.joinorder import guide_tree_join_order
from ..tree.upgma import LINKAGE_BIASED, fix_ea_distmx, upgma5
from ..utils import logging as mlog
from ..utils.device import resolve_device
from .cluster_batch import run_clusters_batched
from .pairwise import PairAligner
from .pprog import PProg
from .uclust import EACluster

DEFAULT_MIN_EA_PASS1 = 0.7    # reference: src/super4.h:9
DEFAULT_MIN_EA_PASS2 = 0.9    # reference: src/super4.h:10
DEFAULT_MAX_COARSE_SEQS = 500  # reference: src/pprog.h:6


def consensus_sequence(msa: MultiSequence, alpha: str) -> str:
    """Per-column majority letter, skipping majority-gap columns
    (reference: src/getconsseq.cpp:3-53)."""
    from ..alphabet import char_to_code_table
    k = alphabet_size(alpha)
    table = char_to_code_table(alpha)
    mat = msa.to_matrix()
    out = []
    letters = ("ACDEFGHIKLMNPQRSTVWY" if k == 20 else "ACGT")
    for c in range(mat.shape[1]):
        col = mat[:, c]
        gaps = int(((col == ord("-")) | (col == ord("."))).sum())
        codes = table[col]
        counts = np.bincount(codes[codes < k], minlength=k)
        best = int(np.argmax(counts))   # first max wins, like reference
        if gaps > counts[best]:
            continue
        if counts[best] == 0:
            continue
        out.append(letters[best])
    return "".join(out)


class Super4:
    def __init__(self, mpc_factory, pack, alpha: str, device=None):
        self.mpc_factory = mpc_factory
        self.pack = pack
        self.alpha = alpha
        self.device = resolve_device(device)
        # cluster sizes and PProg join counts of the last run
        self.cluster_sizes: list[int] = []
        self.pprog_joins = {"device": 0, "host": 0}

    def _split_cluster(self, members: list[int], seqs: MultiSequence,
                       ec: EACluster) -> list[list[int]]:
        """reference: Super4::SplitBigMFA (EA 0.9 then random chunks)."""
        subs = ec.run(members, seqs, DEFAULT_MIN_EA_PASS2)
        out: list[list[int]] = []
        for sub in subs:
            while len(sub) > DEFAULT_MAX_COARSE_SEQS:
                out.append(sub[:DEFAULT_MAX_COARSE_SEQS])
                sub = sub[DEFAULT_MAX_COARSE_SEQS:]
            out.append(sub)
        return out

    def run(self, seqs: MultiSequence, hp: HMMParams,
            tree_perm: str | None = None) -> MultiSequence:
        n = len(seqs)
        aligner = PairAligner(seqs, self.pack, self.alpha,
                              device=self.device)
        ec = EACluster(aligner, self.alpha)

        with mlog.stage("eacluster"):
            clusters = ec.run(list(range(n)), seqs, DEFAULT_MIN_EA_PASS1)
        split: list[list[int]] = []
        for cl in clusters:
            if len(cl) > DEFAULT_MAX_COARSE_SEQS:
                split.extend(self._split_cluster(cl, seqs, ec))
            else:
                split.append(cl)
        clusters = split
        self.cluster_sizes = [len(c) for c in clusters]
        mlog.progress("Super4: %d clusters (max size %d)", len(clusters),
                      max(self.cluster_sizes) if clusters else 0)

        # per-cluster MSAs (MPC; singletons pass through)
        with mlog.stage("cluster_mpcs"):
            cluster_msas = run_clusters_batched(
                [MultiSequence([seqs[i] for i in cl]) for cl in clusters],
                hp, self.alpha, self.mpc_factory)

        if len(cluster_msas) == 1:
            return cluster_msas[0]

        # consensus sequences -> EA distmx -> coarse guide tree
        labels = [f"Cluster{i}" for i in range(len(cluster_msas))]
        with mlog.stage("consensus+distmx"):
            cons = MultiSequence([
                Sequence(labels[i],
                         consensus_sequence(m, self.alpha) or "A")
                for i, m in enumerate(cluster_msas)])
            cons_aligner = PairAligner(cons, self.pack, self.alpha,
                                       device=self.device)
            dist = cons_aligner.ea_dist_matrix()
        tree = upgma5(labels, fix_ea_distmx(dist), LINKAGE_BIASED)
        if tree_perm and tree_perm != "none":
            from ..tree.permute import perm_tree
            tree = perm_tree(tree, tree_perm)

        # global aligner over the ungapped input seqs for PProg posteriors
        l2g = {s.label: i for i, s in enumerate(seqs)}
        pp = PProg(aligner, l2g)
        idx1, idx2 = guide_tree_join_order(
            tree, {lb: i for i, lb in enumerate(labels)})
        with mlog.stage("pprog"):
            msa = pp.run_guide_tree(cluster_msas, idx1, idx2)
        self.pprog_joins = dict(pp.joins)
        return msa
