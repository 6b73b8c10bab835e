"""Super5 pipeline for large inputs.

Torch port of muscle_tpu.pipeline.super5 (reference:
src/super5.cpp:37-643): derep -> UCLUST (minEA 0.99) on the uniques ->
Super4 on the centroids -> TransAln transitive extension of the members
through their stored member<->centroid paths -> dupe re-insertion.

`-align -minsuper N` switches here when the input has >= N sequences
(reference: src/align.cpp:61-70; cli.py).
"""

from __future__ import annotations

from ..hmm.params import HMMParams
from ..sequence import MultiSequence, Sequence
from ..utils import logging as mlog
from ..utils.device import resolve_device
from ..utils.rng import MwcRng
from .derep import Derep
from .mpc import DEFAULT_CONSISTENCY_ITERS, DEFAULT_REFINE_ITERS, MPC
from .pairwise import PairAligner
from .super4 import Super4
from .transaln import make_extended_msa
from .uclust import UClust

DEFAULT_MIN_EA_PASS1 = 0.99   # reference: src/super5.h:8

# what the last Super5 run did, in counts (read by chip_smoke.py)
LAST_RUN: dict[str, object] = {}


class Super5:
    def __init__(self, consistency_iters: int = DEFAULT_CONSISTENCY_ITERS,
                 refine_iters: int = DEFAULT_REFINE_ITERS,
                 tree_perm: str | None = None, device=None):
        self.consistency_iters = consistency_iters
        self.refine_iters = refine_iters
        self.tree_perm = tree_perm
        self.device = resolve_device(device)

    def run(self, seqs: MultiSequence, hp: HMMParams, alpha: str
            ) -> MultiSequence:
        pack = hp.to_scores()

        # 1. derep
        derep = Derep()
        derep.run(seqs)
        unique = derep.unique_seqs(seqs)
        mlog.progress("Super5: %d seqs, %d unique", len(seqs), len(unique))

        # 2. UCLUST at 0.99 on uniques, keeping member->centroid paths
        aligner = PairAligner(unique, pack, alpha, device=self.device)
        uc = UClust(aligner, alpha)
        with mlog.stage("uclust"):
            centroid_idx, seq_to_centroid, seq_to_path = uc.run(
                unique, DEFAULT_MIN_EA_PASS1)
        centroids = MultiSequence([unique[i] for i in centroid_idx])
        mlog.progress("Super5: %d centroids", len(centroids))

        # 3. Super4 on centroids
        def mpc_factory():
            return MPC(consistency_iters=self.consistency_iters,
                       refine_iters=self.refine_iters, device=self.device)
        s4 = None
        if len(centroids) == 1:
            centroid_msa = MultiSequence([centroids[0]])
        else:
            s4 = Super4(mpc_factory, pack, alpha, device=self.device)
            with mlog.stage("super4"):
                centroid_msa = s4.run(centroids, hp,
                                      tree_perm=self.tree_perm)

        # 4. transitive extension of members
        cen_row = {s.label: k for k, s in enumerate(centroid_msa)}
        members = []
        member_to_row = []
        member_paths = []
        for i in range(len(unique)):
            rep = int(seq_to_centroid[i])
            if rep == i:
                continue
            members.append(unique[i])
            member_to_row.append(cen_row[unique[rep].label])
            member_paths.append(seq_to_path[i])
        with mlog.stage("transaln"):
            if members:
                extended = make_extended_msa(centroid_msa, members,
                                             member_to_row, member_paths)
            else:
                extended = centroid_msa

        # 5. dupe re-insertion (clone aligned representative rows)
        dupes = derep.rep_label_to_dupe_labels(seqs)
        if dupes:
            by_label = {s.label: s for s in extended}
            out = MultiSequence()
            for s in extended:
                out.add(s)
            for rep_label, dupe_labels in dupes.items():
                rep_row = by_label[rep_label]
                for dl in dupe_labels:
                    out.add(Sequence(dl, rep_row.bytes_view()))
            extended = out
        LAST_RUN.clear()
        LAST_RUN.update(
            seqs=len(seqs), unique=len(unique), centroids=len(centroids),
            members=len(members),
            clusters=s4.cluster_sizes if s4 else [1],
            pprog_joins=s4.pprog_joins if s4 else {"device": 0, "host": 0})
        return extended


def super5(seqs: MultiSequence, *, nucleo: bool | None = None,
           perturb_seed: int = 0, device=None, **kwargs) -> MultiSequence:
    """Super5 alignment of a large set of unaligned sequences (reference:
    -super5). Runs on the GPU unless `device="cpu"` is given; raises
    when no GPU is present and no device was asked for."""
    from ..alphabet import ALPHA_AMINO, ALPHA_NUCLEO, guess_is_nucleo
    device = resolve_device(device)
    if nucleo is None:
        nucleo = guess_is_nucleo(seqs, MwcRng(1))
    alpha = ALPHA_NUCLEO if nucleo else ALPHA_AMINO
    hp = HMMParams.from_defaults(nucleo=nucleo)
    if perturb_seed > 0:
        hp.perturb(perturb_seed)
    return Super5(device=device, **kwargs).run(seqs, hp, alpha)
