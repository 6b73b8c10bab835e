"""Batched ensemble replicates: all replicates' pair grids in one device
stream (torch port of muscle_tpu.pipeline.ensemble_batch).

The reference's replicate loop re-runs the whole MPC per replicate
(reference: cmd_align src/align.cpp:150-167), so with R replicates the
O(N^2 L^2) pair stage runs R times. Here the replicates are the outer
batch axis:

* one pair-stage pass per group of seeds computes every (seed, pair)
  posterior with per-pair HMM score tables
  (posteriors.ensemble_pairs_posteriors_sparse: kernels 1M/2M on the
  card, the scan's batch_posteriors_multi on the CPU); chunks mix
  replicates;
* the blocked Gram consistency (ops/consistency.consistency_sparse)
  runs once per distinct perturbation seed on its slice of the store,
  for every n, as the JAX package does here;
* tree permutation, progressive alignment and refinement run per
  replicate on the host (joiner=None, as the JAX package): a stratified
  ensemble shares one pair stage across the 4 tree permutations of each
  seed.

Each replicate sees the posteriors, consistency and refinement of the
serial replicate loop, so the outputs are its alignments.
"""

from __future__ import annotations

from ..ops.consistency import consistency_sparse
from ..sequence import MultiSequence, Sequence
from ..utils import logging as mlog
from . import posteriors as post_mod
from .mpc import MPC, consistency_precision_for

# budget of one replicate group's sparse stores (vals f32 + cols i32):
# it groups seeds only, and is the JAX package's value, set for a 16 GB
# TPU. Kept: the grouping decides each pair-stage chunk's lanes, whose
# launch shapes can move bits (PERF.md, "Size constants"; its move is
# held for after the port's benchmark)
_STORE_BUDGET_BYTES = 3 << 30


def run_replicates_batched(seqs: MultiSequence, reps, load_hp, alpha: str,
                           consiters: int, refineiters: int, device,
                           hmmout: str | None = None):
    """Yield (seed, perm, msa) for each replicate, in order.

    reps: ordered [(perturb_seed, perm)]; seeds must be non-decreasing
    (true of the -stratified / -diversified / -replicates schedules).
    load_hp: () -> HMMParams (fresh, unperturbed).
    """
    mpc0 = MPC(consistency_iters=consiters, refine_iters=refineiters,
               device=device)
    device = mpc0.device
    derep, unique, n, labels, label_to_index, pad_to, pairs = \
        mpc0._prepare(seqs)

    if n == 1:
        for seed, perm in reps:
            yield seed, perm, MultiSequence(
                [Sequence(s.label, s.bytes_view()) for s in seqs])
        return

    codes, lens = post_mod.encode_batch(unique, alpha, pad_to=pad_to)
    p_count = len(pairs)

    # distinct seeds in first-appearance order; each seed's pair grid is
    # shared by all its permutations
    seed_order: list[int] = []
    for seed, _ in reps:
        if not seed_order or seed_order[-1] != seed:
            seed_order.append(seed)

    def pack_for(seed: int):
        hp = load_hp()
        if seed > 0:
            hp.perturb(seed)
        if hmmout:
            hp.to_file(hmmout)
        return hp.to_scores()

    bytes_per_seed = 8 * (p_count + 1) * pad_to * 32
    group_size = max(1, _STORE_BUDGET_BYTES // max(1, bytes_per_seed))
    mlog.log("ensemble batch: %d reps, %d seeds, %d pairs, group %d",
             len(reps), len(seed_order), p_count, group_size)

    rep_queue = list(reps)
    for glo in range(0, len(seed_order), group_size):
        group = seed_order[glo:glo + group_size]
        packs = [pack_for(s) for s in group]
        with mlog.stage(f"ensemble posteriors x{len(group)}"):
            store_v, store_c, ea_rp, max_nnz = \
                post_mod.ensemble_pairs_posteriors_sparse(
                    codes, lens, packs, pairs, device)
        if max_nnz > 32:
            mlog.log("sparse posterior truncation: max row nnz %d > K=32",
                     max_nnz)

        for r, seed in enumerate(group):
            dist_mx = post_mod.ea_dist_matrix(n, pairs, ea_rp[r])
            sv, sc = store_v[r], store_c[r]
            if n >= 3 and consiters > 0:
                with mlog.stage("consistency"):
                    sv = consistency_sparse(
                        sv, sc, n, consiters,
                        seq_block=max(1, min(16, 8192 // pad_to)),
                        precision=consistency_precision_for(n),
                        max_nnz=min(int(max_nnz), 32))
                    sv[-1:, -1:, -1:].cpu()   # wait for it: honest wall
            with mlog.stage("store-fetch"):
                posts = post_mod.posts_from_store(sv, sc, pairs, lens)

            # all replicates of this seed (perms differ only on the host)
            while rep_queue and rep_queue[0][0] == seed:
                _, perm = rep_queue.pop(0)
                mpc = MPC(consistency_iters=consiters,
                          refine_iters=refineiters, tree_perm=perm,
                          device=device)
                tree = mpc._tree_from_dist(labels, dist_mx)
                mpc.guide_tree = tree
                mpc.dist_mx = dist_mx
                yield seed, perm, mpc._finish(seqs, derep, unique, tree,
                                              label_to_index, posts, None)
        del store_v, store_c
