"""Super6 — cluster by ML protein distance, align, coarse-join (torch
port of muscle_tpu.pipeline.super6).

reference: src/super6.cpp — UClustPD(maxpd 1.5) -> split big clusters
into sequential <=500-seq chunks (SplitBigMFA_Random, src/super6.cpp:64)
-> cluster distance matrix from 8 sampled cross-pair ML distances
(GetProtDistMFAPair) -> UPGMA(biased) coarse tree -> MPC per cluster
(tree perm off) -> PProg joins along the coarse tree. No derep and no
final sort (the output keeps PProg's row order), matching the reference.

Every ML distance runs the NW DP on the device (kernel nw_viterbi on
the card, ops/nw.py), the cluster MPCs and the PProg pair stores the
pair-HMM kernels; everything runs on the card unless the CPU is asked
for.
"""

from __future__ import annotations

import numpy as np

from ..hmm.params import HMMParams
from ..sequence import MultiSequence
from ..tree.joinorder import guide_tree_join_order
from ..tree.upgma import LINKAGE_BIASED, upgma5
from ..utils import logging as mlog
from ..utils.device import resolve_device
from ..utils.rng import MwcRng
from .mpc import DEFAULT_CONSISTENCY_ITERS, DEFAULT_REFINE_ITERS, MPC
from .pairwise import PairAligner
from .pprog import DEFAULT_TARGET_PAIR_COUNT, PProg
from .uclustpd import (DEFAULT_MAX_PD_PASS1, DEFAULT_SEEDS_PER_ITER,
                       TARGET_PAIR_COUNT_CLUSTER_DIST, ProtDistCalc,
                       UClustPD)

DEFAULT_MAX_COARSE_SEQS = 500   # reference: src/pprog.h:6

# what the last Super6 run did (read by chip_smoke.py): the UClustPD
# clusters' sizes, the cluster sizes after the split, the PProg joins on
# the device / the host
LAST_RUN: dict[str, object] = {}


class Super6:
    def __init__(self, consistency_iters: int = DEFAULT_CONSISTENCY_ITERS,
                 refine_iters: int = DEFAULT_REFINE_ITERS,
                 max_pd1: float = DEFAULT_MAX_PD_PASS1,
                 max_cluster: int = DEFAULT_MAX_COARSE_SEQS,
                 target_cluster_pairs: int = TARGET_PAIR_COUNT_CLUSTER_DIST,
                 target_pair_count: int = DEFAULT_TARGET_PAIR_COUNT,
                 seeds_per_iter: int = DEFAULT_SEEDS_PER_ITER,
                 device=None):
        self.consistency_iters = consistency_iters
        self.refine_iters = refine_iters
        self.max_pd1 = max_pd1
        self.max_cluster = max_cluster
        self.target_cluster_pairs = target_cluster_pairs
        self.target_pair_count = target_pair_count
        self.seeds_per_iter = seeds_per_iter
        self.device = resolve_device(device)

    def run(self, seqs: MultiSequence, hp: HMMParams, alpha: str
            ) -> MultiSequence:
        pack = hp.to_scores()
        n = len(seqs)
        calc = ProtDistCalc(seqs, alpha, device=self.device)

        # 1. UClustPD pass at maxpd 1.5
        with mlog.stage("uclustpd"):
            uc = UClustPD(calc, seeds_per_iter=self.seeds_per_iter)
            clusters = uc.run(list(range(n)), self.max_pd1)
        LAST_RUN.clear()
        LAST_RUN.update(seqs=n, uclustpd=[len(c) for c in clusters])

        # 2. split big clusters into sequential <=max_cluster chunks;
        #    chunk 0 replaces the cluster in place, the rest append
        #    (reference: Super6::PrepareClusters src/super6.cpp:96-140)
        i = 0
        while i < len(clusters):
            cl = clusters[i]
            if len(cl) > self.max_cluster:
                chunks = [cl[k:k + self.max_cluster]
                          for k in range(0, len(cl), self.max_cluster)]
                clusters[i] = chunks[0]
                clusters.extend(chunks[1:])
            i += 1
        LAST_RUN.update(clusters=[len(c) for c in clusters],
                        pprog_joins={"device": 0, "host": 0})

        # 3. coarse guide tree from sampled ML cluster distances
        labels = [f"Cluster{i}" for i in range(len(clusters))]
        if len(clusters) > 1:
            with mlog.stage("cluster_dists"):
                dist = np.zeros((len(clusters), len(clusters)),
                                dtype=np.float64)
                rng = MwcRng(1)
                for a in range(1, len(clusters)):
                    for b in range(a):
                        d = calc.mfa_pair_dist(
                            clusters[a], clusters[b],
                            self.target_cluster_pairs, rng)
                        dist[a, b] = dist[b, a] = d
                tree = upgma5(labels, dist, LINKAGE_BIASED)

        # 4. MPC per cluster (tree perm forced off, src/super6.cpp:54)
        cluster_msas: list[MultiSequence] = []
        with mlog.stage("cluster_mpcs"):
            for cl in clusters:
                sub = MultiSequence([seqs[i] for i in cl])
                if len(cl) == 1:
                    cluster_msas.append(sub)
                else:
                    mpc = MPC(consistency_iters=self.consistency_iters,
                              refine_iters=self.refine_iters, tree_perm=None,
                              device=self.device)
                    cluster_msas.append(mpc.run(sub, hp, alpha))

        if len(cluster_msas) == 1:
            return cluster_msas[0]

        # 5. PProg along the coarse tree
        with mlog.stage("pprog"):
            aligner = PairAligner(seqs, pack, alpha, device=self.device)
            l2g = {s.label: i for i, s in enumerate(seqs)}
            pp = PProg(aligner, l2g, self.target_pair_count)
            idx1, idx2 = guide_tree_join_order(
                tree, {lb: i for i, lb in enumerate(labels)})
            out = pp.run_guide_tree(cluster_msas, idx1, idx2)
        LAST_RUN.update(pprog_joins=dict(pp.joins))
        return out
