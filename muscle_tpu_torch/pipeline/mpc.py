"""MPC — the core MSA pipeline (Multithreaded ProbCons), torch port.

Equivalent of the reference's MPCFlat::Run (reference:
src/mpcflat.cpp:285-337) and of muscle_tpu.pipeline.mpc. Stage order:

  derep -> all-pairs posteriors + EA distances (device, batched)
        -> UPGMA5 guide tree (+ permutation)
        -> consistency transform (device)
        -> join order -> progressive align (host) -> refine
        -> sort by tree -> re-insert dupes

Branches, routed as in the JAX package:
* n * pad <= SMALL_DENSE_NL: one batched pair call and the dense
  consistency (pipeline/posteriors.small_family_store);
* n * pad > SMALL_DENSE_NL: the pair store and the blocked Gram-scheme
  consistency (ops/consistency.consistency_sparse), bf16 panels from
  n = 32 on (consistency_precision_for);
* n = 2 or consistency_iters = 0: the pair store, no consistency.
The pair store is length-bucketed for pads up to
posteriors.LONG_PAIR_THRESHOLD and filled pair by pair by the long-pair
router beyond it (posteriors._long_pairs_sparse). With `mega` (a
Muscle-3D MegaProfileSet) the emissions come from the chains' feature
profiles, matched by label (reference: MPCFlat_mega,
src/mpcflat_mega.cpp): the same branches, every pad through the bucketed
store, and no store-budget guard, as in the JAX package.
Refinement joins run on the host below DEVICE_REFINE_N sequences and on
the device from there on (pipeline/devjoin.DeviceJoiner).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..alphabet import ALPHA_AMINO, ALPHA_NUCLEO, guess_is_nucleo
from ..hmm.params import HMMParams
from ..ops.consistency import consistency_sparse
from ..ops.emissions import pad_profiles
from ..sequence import MultiSequence, Sequence
from ..tree.joinorder import guide_tree_join_order
from ..tree.tree import Tree
from ..tree.upgma import LINKAGE_BIASED, fix_ea_distmx, upgma5
from ..utils import logging as mlog
from ..utils.device import resolve_device
from ..utils.rng import GlibcRand, MwcRng
from . import posteriors as post_mod
from .derep import Derep
from .devjoin import DeviceJoiner
from .progressive import progressive_align, refine

DEFAULT_CONSISTENCY_ITERS = 2   # reference: src/pairhmm.h:8
DEFAULT_REFINE_ITERS = 100      # reference: src/pairhmm.h:9
PAIR_BATCH = 256                # default pairs per call (MPC batch_size)
SPARSE_K = 32                   # default slots per store row (MPC sparse_k)

# families of this size and above refine with device joins
# (pipeline/devjoin.py), as the JAX package's default rule
DEVICE_REFINE_N = 64


def consistency_precision_for(n: int, requested: str = "auto") -> str:
    """Precision of the blocked consistency's products: 'auto' keeps
    full f32 below 32 sequences (the regime the golden tier pins) and
    rounds the panels to bf16 from 32 on, as the JAX package does; any
    other value is taken as asked. Only "default" rounds the panels to
    bf16: "high" and "highest" keep them f32 with TF32 off (torch has no
    counterpart of the TPU's bf16x3 passes). The dense branch's products
    are f32 whatever is asked, as the JAX package's are on the CPU."""
    if requested != "auto":
        return requested
    return "highest" if n < 32 else "default"


class MPC:
    def __init__(self,
                 consistency_iters: int = DEFAULT_CONSISTENCY_ITERS,
                 refine_iters: int = DEFAULT_REFINE_ITERS,
                 tree_perm: str | None = None,
                 device=None,
                 guide_tree_in: Tree | None = None,
                 input_order: bool = False,
                 mega=None,
                 batch_size: int = PAIR_BATCH,
                 random_chain_tree: bool = False,
                 sparse_k: int = SPARSE_K,
                 consistency_precision: str = "auto"):
        self.consistency_iters = consistency_iters
        self.refine_iters = refine_iters
        self.tree_perm = tree_perm
        self.device = resolve_device(device)
        # a given guide tree (-guidetreein) replaces UPGMA5 and the
        # permutation; input_order is the caller's (-input_order: rows
        # in input order, applied by the caller as in the JAX package)
        self.guide_tree_in = guide_tree_in
        self.input_order = input_order
        self.mega = mega          # MegaProfileSet for Muscle-3D emissions
        # the options of the JAX package's MPC: pairs in a batched call
        # (a pair's EA depends on its call's other pairs, through the
        # length buckets), the random chain tree in place of UPGMA5
        # (-randomchaintree), the store's slots a row, and the blocked
        # consistency's precision (consistency_precision_for)
        self.batch_size = batch_size
        self.random_chain_tree = random_chain_tree
        self.sparse_k = sparse_k
        self.consistency_precision = consistency_precision
        self.guide_tree: Tree | None = None
        self.dist_mx: np.ndarray | None = None

    def _prepare(self, input_seqs: MultiSequence):
        derep = Derep()
        derep.run(input_seqs)
        unique = derep.unique_seqs(input_seqs)
        n = len(unique)
        labels = unique.labels()
        if n > 1 and len(set(labels)) != n:
            raise ValueError("duplicate labels in input")
        label_to_index = {lb: i for i, lb in enumerate(labels)}
        # pad to the bucket ladder (the JAX package's padding: it
        # decides the kernels' lane layout and so the numbers)
        lmax = max(len(s) for s in unique)
        if lmax > post_mod.BUCKET_LADDER[-1]:
            pad_to = post_mod.round_up(lmax, 128)
        else:
            pad_to = max(128, post_mod._bucket_of(
                lmax, post_mod.BUCKET_LADDER[-1]))
        pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
        return derep, unique, n, labels, label_to_index, pad_to, pairs

    def _tree_from_dist(self, labels, dist_mx):
        """Guide tree from EA distances (+ optional permutation), the
        given one, or the random chain tree."""
        if self.random_chain_tree:
            # ablation tree (reference: -randomchaintree,
            # src/randomchaintree.cpp)
            from ..tree.randomchain import random_chain_tree
            return random_chain_tree(labels)
        if self.guide_tree_in is not None:
            return self.guide_tree_in
        d = fix_ea_distmx(dist_mx)
        tree = upgma5(labels, d, LINKAGE_BIASED)
        if self.tree_perm and self.tree_perm != "none":
            from ..tree.permute import perm_tree
            tree = perm_tree(tree, self.tree_perm)
        return tree

    def run(self, input_seqs: MultiSequence, hp: HMMParams, alpha: str,
            refine_rng: GlibcRand | None = None) -> MultiSequence:
        derep, unique, n, labels, label_to_index, pad_to, pairs = \
            self._prepare(input_seqs)

        if n == 1:
            # all sequences identical: output a copy of the input
            return MultiSequence([Sequence(s.label, s.bytes_view())
                                  for s in input_seqs])

        pack = hp.to_scores()
        mlog.log("MPC: %d unique seqs, %d pairs, pad %d, device %s", n,
                 len(pairs), pad_to, self.device)
        # single-device capacity guard of the blocked branch, kept as the
        # JAX package has it (letters only): the (P+1, L, K) sparse store
        # is 8 B/slot
        p_total = len(pairs)
        store_gb = (p_total + 1) * pad_to * self.sparse_k * 8 / 1e9
        budget_gb = float(os.environ.get("MUSCLE_TPU_HBM_BUDGET_GB", 12.0))
        if (self.mega is None and store_gb > budget_gb
                and n * pad_to > post_mod.SMALL_DENSE_NL):
            raise MemoryError(
                f"MPC sparse store for {n} seqs ({p_total} pairs, "
                f"L={pad_to}, K={self.sparse_k}) needs ~{store_gb:.0f} GB "
                f"device memory (> {budget_gb:.0f} GB budget). Use "
                f"-super5, or raise MUSCLE_TPU_HBM_BUDGET_GB.")
        use_dense = (n >= 3 and self.consistency_iters > 0
                     and n * pad_to <= post_mod.SMALL_DENSE_NL)

        if self.mega is not None:
            # Muscle-3D: feature profiles matched by label
            prof_by_label = dict(zip(self.mega.labels, self.mega.profiles))
            profs = [prof_by_label[s.label] for s in unique]
            lens = np.array([p.shape[0] for p in profs], dtype=np.int32)
            codes = pad_profiles(profs, pad_to)
        else:
            codes, lens = post_mod.encode_batch(unique, alpha, pad_to=pad_to)
        with mlog.stage("posteriors+consistency" if use_dense
                        else "posteriors"):
            if use_dense:
                store_v, store_c, ea, max_nnz = \
                    post_mod.small_family_store(
                        codes, lens, pack, pairs, n, self.sparse_k,
                        self.consistency_iters, self.device, mega=self.mega)
            elif self.mega is not None:
                store_v, store_c, ea, max_nnz = \
                    post_mod.all_pairs_posteriors_mega_sparse(
                        codes, lens, self.mega, pack, pairs, self.device,
                        batch_size=self.batch_size, k=self.sparse_k)
            else:
                store_v, store_c, ea, max_nnz = \
                    post_mod.all_pairs_posteriors_sparse(
                        codes, lens, pack, pairs, self.device,
                        batch_size=self.batch_size, k=self.sparse_k)
        if max_nnz > self.sparse_k:
            mlog.log(f"sparse posterior truncation: max row nnz {max_nnz} > "
                     f"K={self.sparse_k}")
        # trim the store to the occupied K-prefix (sparsify packs valid
        # slots first)
        k2s = min(self.sparse_k, max(8, -(-int(max_nnz) // 8) * 8))
        if k2s < store_v.shape[2]:
            store_v = store_v[:, :, :k2s].contiguous()
            store_c = store_c[:, :, :k2s].contiguous()
        self.dist_mx = post_mod.ea_dist_matrix(n, pairs, ea)

        # guide tree from the pre-consistency EA distances
        # (reference: src/mpcflat.cpp:306-310)
        with mlog.stage("tree"):
            tree = self._tree_from_dist(labels, self.dist_mx)
        self.guide_tree = tree

        if not use_dense and n >= 3 and self.consistency_iters > 0:
            # panels are (blk*l) x (blocks*l): blk*l <= 8192 bounds them
            seq_block = max(1, min(16, 8192 // pad_to))
            with mlog.stage("consistency"):
                store_v = consistency_sparse(
                    store_v, store_c, n, self.consistency_iters,
                    seq_block=seq_block,
                    precision=consistency_precision_for(
                        n, self.consistency_precision),
                    max_nnz=min(int(max_nnz), self.sparse_k))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

        with mlog.stage("store-fetch"):
            posts = post_mod.posts_from_store(store_v, store_c, pairs, lens)
        joiner = None
        if n >= DEVICE_REFINE_N:
            # the store stays on the device for the refine joins
            joiner = DeviceJoiner(store_v, store_c, pairs, n,
                                  min(int(max_nnz), self.sparse_k),
                                  label_to_index)
        del store_v, store_c
        return self._finish(input_seqs, derep, unique, tree, label_to_index,
                            posts, refine_rng, joiner=joiner)

    def _finish(self, input_seqs, derep, unique, tree, label_to_index,
                posts, refine_rng, joiner=None):
        """Join order -> progressive -> refine -> sort -> dupes (shared
        with the ensembles' replicate batching, which refines on the
        host: joiner=None)."""
        idx1, idx2 = guide_tree_join_order(tree, label_to_index)
        with mlog.stage("progressive"):
            msa = progressive_align(unique, idx1, idx2, label_to_index,
                                    posts)
        with mlog.stage("refine"):
            msa = refine(msa, self.refine_iters, label_to_index, posts,
                         rng=refine_rng, joiner=joiner)
        msa = self._sort(msa, tree)
        dupes = derep.rep_label_to_dupe_labels(input_seqs)
        if dupes:
            msa = self._insert_dupes(msa, dupes)
        return msa

    @staticmethod
    def _sort(msa: MultiSequence, tree: Tree) -> MultiSequence:
        by_label = {s.label: s for s in msa}
        ordered = []
        for node in tree.depth_first():
            if tree.is_leaf(node):
                ordered.append(by_label[tree.labels[node]])
        return MultiSequence(ordered)

    @staticmethod
    def _insert_dupes(msa: MultiSequence,
                      dupes: dict[str, list[str]]) -> MultiSequence:
        out = MultiSequence()
        for s in msa:
            out.add(s)
            for dl in dupes.get(s.label, ()):
                out.add(Sequence(dl, s.bytes_view()))
        return out


def align(seqs: MultiSequence, *,
          nucleo: bool | None = None,
          perturb_seed: int = 0,
          tree_perm: str | None = None,
          consistency_iters: int = DEFAULT_CONSISTENCY_ITERS,
          refine_iters: int = DEFAULT_REFINE_ITERS,
          hmm_params: HMMParams | None = None,
          guide_tree_in: Tree | None = None,
          input_order: bool = False,
          device=None,
          mega=None,
          batch_size: int = PAIR_BATCH,
          random_chain_tree: bool = False,
          sparse_k: int = SPARSE_K,
          consistency_precision: str = "auto") -> MultiSequence:
    """Align a set of unaligned sequences (reference: -align, src/align.cpp).

    As muscle_tpu.align: `hmm_params` replaces the default HMM (perturbed
    in place when perturb_seed > 0), `guide_tree_in` replaces UPGMA5 and
    the permutation, and `input_order` returns the rows in the input's
    order instead of the tree's. With `mega` (io/mega.MegaProfileSet:
    Muscle-3D structure profiles, its chains labelled as `seqs`) the
    emissions come from the profiles. `batch_size`, `random_chain_tree`,
    `sparse_k` and `consistency_precision` go to MPC, with the JAX
    package's MPC's meanings (its align() passes on only batch_size).
    Runs on the GPU unless `device="cpu"` is given; raises when no GPU
    is present and no device was asked for.
    """
    device = resolve_device(device)
    if mega is not None:
        nucleo = False            # structure profiles are protein chains
    elif nucleo is None:
        nucleo = guess_is_nucleo(seqs, MwcRng(1))
    alpha = ALPHA_NUCLEO if nucleo else ALPHA_AMINO

    hp = hmm_params or HMMParams.from_defaults(nucleo=nucleo)
    if perturb_seed > 0:
        hp.perturb(perturb_seed)

    mpc = MPC(consistency_iters=consistency_iters,
              refine_iters=refine_iters, tree_perm=tree_perm,
              device=device, guide_tree_in=guide_tree_in,
              input_order=input_order, mega=mega, batch_size=batch_size,
              random_chain_tree=random_chain_tree, sparse_k=sparse_k,
              consistency_precision=consistency_precision)
    msa = mpc.run(seqs, hp, alpha)
    if input_order:
        by_label = {s.label: s for s in msa}
        msa = MultiSequence([by_label[s.label] for s in seqs
                             if s.label in by_label])
    return msa
