"""PProg — progressive alignment where leaves are MSAs.

Torch port of muscle_tpu.pipeline.pprog: the guide-tree joins
(reference: src/pprog_tree.cpp) and the greedy best-pair joins
(src/pprog.cpp); src/alnmsasflat.cpp, profile-profile MEA via sampled
pair posteriors; src/getpairs.cpp, <= 2000-pair sampling.

The pair-HMM posteriors of the sampled cross-MSA sequence pairs run on
the device through PairAligner over the global ungapped sequence set.
A join with DEVICE_JOIN_N or more sampled pairs builds its column
posterior and MEA directions on the device too (devjoin's list
variant); smaller joins accumulate on the host (CSR walk + MEA).
"""

from __future__ import annotations

import numpy as np

from ..ops.mea import mea_align
from ..sequence import MultiSequence
from ..utils import logging as mlog
from ..utils.rng import MwcRng
from . import posteriors as post_mod
from .devjoin import align_sampled_device
from .pairwise import PairAligner

DEFAULT_TARGET_PAIR_COUNT = 2000   # reference: src/pprog.h:5

# joins with this many sampled pairs and more run on the device, as the
# JAX package's default rule (its MUSCLE_TPU_DEVICE_REFINE forces either
# way; here tests set this constant)
DEVICE_JOIN_N = 64

# small host joins share one pair store of up to this many pairs; each
# device join has a store of its own (the JAX package's grouping rule:
# a group's pair list decides its length buckets, and so the numbers)
GROUP_PAIRS = 4096


def _device_joins(n_sampled: int) -> bool:
    return n_sampled >= DEVICE_JOIN_N


def get_pairs(count1: int, count2: int, target: int,
              rng: MwcRng) -> list[tuple[int, int]]:
    """reference: GetPairs (src/getpairs.cpp:33-69)."""
    all_pairs = count1 * count2
    if target == 0 or all_pairs < target * 3 // 2:
        return [(i, j) for i in range(count1) for j in range(count2)]
    pair_set: set[tuple[int, int]] = set()
    max_counter = target * 10
    counter = 0
    while counter < max_counter and len(pair_set) < target:
        counter += 1
        i = rng.randu32() % count1
        j = rng.randu32() % count2
        if i == j:
            continue
        pair_set.add((i, j))
    return sorted(pair_set)


def invert_path(path: str) -> str:
    tr = {"B": "B", "X": "Y", "Y": "X"}
    return "".join(tr[c] for c in path)


def align_msas_by_path(msa1: MultiSequence, msa2: MultiSequence,
                       path: str) -> MultiSequence:
    out = MultiSequence()
    for s in msa1:
        out.add(s.add_gaps_path(path, "X"))
    for s in msa2:
        out.add(s.add_gaps_path(path, "Y"))
    return out


# -savedir: when set, every PProg join MSA is written to
# <SAVE_DIR>/join<k> (reference: src/pprog.cpp:354-363 opt(savedir)).
SAVE_DIR: str | None = None


def _save_join(msa: MultiSequence, join_index: int) -> None:
    if not SAVE_DIR:
        return
    import os
    os.makedirs(SAVE_DIR, exist_ok=True)
    msa.write_fasta(os.path.join(SAVE_DIR, f"join{join_index}"))


class PProg:
    """The greedy joins (run) score every pending MSA pair by the mean EA
    of its sampled sequence pairs, in one EA-only pass a round
    (score_round), and build a path only for the pair that joins,
    replaying its sampling from the round's RNG snapshot, so samples and
    results are those of the eager order (align_msas), as in the JAX
    package (the reference computes every path up front,
    src/pprog.cpp:230-256)."""

    def __init__(self, aligner: PairAligner,
                 label_to_global_index: dict[str, int],
                 target_pair_count: int = DEFAULT_TARGET_PAIR_COUNT,
                 rng: MwcRng | None = None):
        """`aligner` is over the global ungapped sequence set (anything
        with `lens` and `sparse_store(pairs)`; the greedy joins also
        call its `ea(pairs)`); label_to_global_index maps row labels into
        it; each join samples up to target_pair_count pairs from `rng`
        (default MwcRng(1))."""
        self.aligner = aligner
        self.l2g = label_to_global_index
        self.target = target_pair_count
        self.rng = rng or MwcRng(1)
        # joins of the last run_guide_tree on the device / on the host
        self.joins = {"device": 0, "host": 0}

    def _gpairs(self, msa1, msa2, sampled):
        return [(self.l2g[msa1[i].label], self.l2g[msa2[j].label])
                for (i, j) in sampled]

    # -- batched scoring (reference: the EA part of AlignMSAsFlat) ------
    def score_round(self, items, node_msas):
        """items: [(i1, i2)] node-index pairs, scored in order. Returns
        {(i1, i2): (avg_ea, rng_snapshot)} after one EA-only pass over
        all sampled sequence pairs of the round."""
        import time as _time
        t0 = _time.perf_counter()
        snaps = {}
        slices = []
        all_pairs: list[tuple[int, int]] = []
        for (i1, i2) in items:
            m1, m2 = node_msas[i1], node_msas[i2]
            snap = self.rng.clone()
            sampled = get_pairs(len(m1), len(m2), self.target, self.rng)
            gp = self._gpairs(m1, m2, sampled)
            slices.append((len(all_pairs), len(gp)))
            all_pairs.extend(gp)
            snaps[(i1, i2)] = snap
        eas = self.aligner.ea(all_pairs) if all_pairs else np.zeros(0)
        out = {}
        for (i1, i2), (lo, cnt) in zip(items, slices):
            avg = float(np.mean(eas[lo:lo + cnt])) if cnt else 0.0
            out[(i1, i2)] = (avg, snaps[(i1, i2)])
        mlog.log("pprog score_round: %d items %d pairs %.2fs",
                 len(items), len(all_pairs), _time.perf_counter() - t0)
        return out

    # -- profile-profile path (reference: AlignMSAsFlat) ----------------
    def _accumulate_path(self, msa1, msa2, sampled, views) -> str:
        """Host column-posterior accumulate (CSR walk) + MEA path."""
        from ..native import build_post_accumulate_csr_native
        from .progressive import _accumulate_csr_np
        cc1, cc2 = msa1.col_count(), msa2.col_count()
        col_post = np.zeros((cc1, cc2), dtype=np.float32)
        ptc1 = {i: msa1[i].pos_to_col() for i in {i for i, _ in sampled}}
        ptc2 = {j: msa2[j].pos_to_col() for j in {j for _, j in sampled}}
        for k, (i, j) in enumerate(sampled):
            v, c, rp = views[k]
            if not build_post_accumulate_csr_native(
                    col_post, v, c, rp, ptc1[i], ptc2[j], False):
                _accumulate_csr_np(col_post, v, c, rp, ptc1[i], ptc2[j],
                                   False)
        _, path = mea_align(col_post)
        return path

    def _store_views(self, sv, sc, gpairs):
        """Host CSR views of a store's first len(gpairs) rows."""
        flat_v, flat_c, nnz = post_mod.store_to_csr(sv, sc)
        return post_mod.csr_views(
            flat_v, flat_c, nnz, len(gpairs),
            lambda t: int(self.aligner.lens[gpairs[t][0]]))

    def path_msas(self, msa1: MultiSequence, msa2: MultiSequence,
                  rng: MwcRng | None = None,
                  sampled: list[tuple[int, int]] | None = None
                  ) -> tuple[float, str]:
        """(mean EA of the sampled pairs, path) for one MSA pair, with
        its own pair store. `rng` (default: the shared stream) drives
        the pair sampling: a clone()d snapshot replays a score_round's
        sampling; or pass `sampled` directly."""
        if sampled is None:
            rng = rng if rng is not None else self.rng
            sampled = get_pairs(len(msa1), len(msa2), self.target, rng)
        gpairs = self._gpairs(msa1, msa2, sampled)
        sv, sc, eas, max_nnz = self.aligner.sparse_store(gpairs)
        avg_ea = float(np.mean(eas)) if len(eas) else 0.0
        if _device_joins(len(sampled)):
            r = align_sampled_device(sv, sc, sampled, msa1, msa2, max_nnz)
            if r is not None:
                return avg_ea, r[1]
        views = self._store_views(sv, sc, gpairs)
        return avg_ea, self._accumulate_path(msa1, msa2, sampled, views)

    def align_msas(self, msa1: MultiSequence, msa2: MultiSequence
                   ) -> tuple[float, str]:
        """Eager score and path (consumes the shared stream once, like
        the reference's AlignMSAsFlat)."""
        return self.path_msas(msa1, msa2)

    # -- greedy best-pair joins (reference: PProg::Run) ------------------
    def run(self, msas: list[MultiSequence]) -> MultiSequence:
        """Join the MSAs best pair first (the highest mean sampled EA,
        first found on ties, strict >), scoring each new node against the
        pending ones; each join's path through path_msas (host below
        DEVICE_JOIN_N sampled pairs, else on the device)."""
        n = len(msas)
        if n == 1:
            return msas[0]
        node_msas: list[MultiSequence | None] = list(msas)
        node_count = 2 * n - 1
        score = np.full((node_count, node_count), -np.inf, dtype=np.float32)
        snaps: dict[tuple[int, int], MwcRng] = {}
        pending = list(range(n))

        items = [(i, j) for i in range(n) for j in range(i + 1, n)]
        for (i, j), (s, snap) in self.score_round(items, node_msas).items():
            score[i, j] = score[j, i] = s
            snaps[(i, j)] = snap

        for join in range(n - 1):
            best = None
            best_s = -np.inf
            for a in range(len(pending)):
                for b in range(a + 1, len(pending)):
                    s = score[pending[a], pending[b]]
                    if s > best_s:
                        best_s = s
                        best = (pending[a], pending[b])
            i1, i2 = best
            new_index = n + join
            key = (i1, i2) if (i1, i2) in snaps else (i2, i1)
            m1, m2 = node_msas[key[0]], node_msas[key[1]]
            _, path = self.path_msas(m1, m2, snaps[key].clone())
            joined = align_msas_by_path(m1, m2, path)
            _save_join(joined, join)
            node_msas.append(joined)
            pending = [p for p in pending if p not in (i1, i2)]
            # score the new node against the remaining pending nodes
            items = [(new_index, p) for p in pending]
            for (a, b), (s, snap) in self.score_round(
                    items, node_msas).items():
                score[a, b] = score[b, a] = s
                snaps[(a, b)] = snap
            pending.append(new_index)

        assert len(pending) == 1
        return node_msas[pending[0]]

    # -- guide-tree-driven joins (reference: src/pprog_tree.cpp) ---------
    def run_guide_tree(self, msas: list[MultiSequence],
                       idx1: list[int], idx2: list[int]) -> MultiSequence:
        """Joins along a precomputed join order. An internal node's row
        list is (m1 rows, m2 rows), so every join's sampled raw-sequence
        pairs are known before any join runs: the pair sampling stream is
        consumed up front in the serial order, and consecutive small
        joins share one pair store (the JAX package's grouping). Each
        group's store is filled just before its joins."""
        node_msas: list[MultiSequence | None] = list(msas)
        njoin = len(idx1)

        # pre-sample every join in serial RNG order
        node_glob: list[list[int] | None] = [
            [self.l2g[s.label] for s in m] for m in msas]
        plan = []
        for k in range(njoin):
            g1, g2 = node_glob[idx1[k]], node_glob[idx2[k]]
            sampled = get_pairs(len(g1), len(g2), self.target, self.rng)
            plan.append((sampled, [(g1[i], g2[j]) for i, j in sampled]))
            node_glob.append(g1 + g2)
        del node_glob

        # groups: host joins batch up to GROUP_PAIRS pairs; a device
        # join is a group of its own
        groups: list[tuple[int, int, list[int]]] = []   # (k0, k1, offs)
        k = 0
        while k < njoin:
            offs = [0]
            k0 = k
            tot = 0
            while k < njoin and (k == k0
                                 or (tot + len(plan[k][1]) <= GROUP_PAIRS
                                     and not _device_joins(
                                         len(plan[k][0])))):
                tot += len(plan[k][1])
                offs.append(tot)
                k += 1
                if _device_joins(len(plan[k0][0])):
                    break
            groups.append((k0, k, offs))
        return self._run_guide_tree_joins(node_msas, idx1, idx2, plan,
                                          groups)

    def _run_guide_tree_joins(self, node_msas, idx1, idx2, plan, groups):
        import time as _time
        self.joins = {"device": 0, "host": 0}
        for g, (k0, k1, offs) in enumerate(groups):
            t_grp = _time.perf_counter()
            gpairs_all = [p for kk in range(k0, k1) for p in plan[kk][1]]
            sv, sc, _ea, mx = self.aligner.sparse_store(gpairs_all)
            group_views = None           # host CSR of the group, lazily
            n_dev = n_host = 0
            for k in range(k0, k1):
                m1 = node_msas[idx1[k]]
                m2 = node_msas[idx2[k]]
                sampled, gpairs = plan[k]
                lo, m = offs[k - k0], len(gpairs)
                r = None
                if _device_joins(len(sampled)):
                    r = align_sampled_device(sv, sc, sampled, m1, m2, mx,
                                             row_offset=lo)
                if r is not None:
                    path = r[1]
                    n_dev += 1
                else:
                    if group_views is None:
                        group_views = self._store_views(sv, sc, gpairs_all)
                    path = self._accumulate_path(
                        m1, m2, sampled, group_views[lo:lo + m])
                    n_host += 1
                joined = align_msas_by_path(m1, m2, path)
                _save_join(joined, k)
                node_msas.append(joined)
                node_msas[idx1[k]] = None
                node_msas[idx2[k]] = None
            del sv, sc
            self.joins["device"] += n_dev
            self.joins["host"] += n_host
            mlog.log("pprog group %d/%d: joins %d-%d (%d dev, %d host) "
                     "%.2fs", g + 1, len(groups), k0 + 1, k1, n_dev, n_host,
                     _time.perf_counter() - t_grp)
        return node_msas[-1]
