"""Classic profile-profile aligner ("muscle3", the v3-style path).

Host copy of muscle_tpu.pipeline.muscle3 (numpy only).

reference: src/muscle3.cpp (kmer dist -> UPGMA -> Clustal weights ->
PProg3 progressive profile alignment -> -treeiters Kimura re-estimation
loops), src/profile3.{h,cpp} / src/profpos3.{h,cpp} (profile columns:
weighted AA freqs, L/G dimer freqs, occupancy, position-specific gap
open/close scores), src/nwsmall3.cpp (profile-profile NW, gap extension
0, terminal gaps discounted through the boundary columns' gap scores),
src/m3alnparams.cpp (BLOSUM62 + center 0.8, gap open -6 defaults).

This is a host/numpy subsystem — profile-profile NW matrices are small
(column counts), and the match-score lattice is a single
freqs_A @ (B62 + center) @ freqs_B^T matmul.
"""

from __future__ import annotations

import numpy as np

from ..alphabet import ALPHA_AMINO
from ..ops.sw import BLOSUM62
from ..sequence import MultiSequence, Sequence
from ..tree.clustalweights import clustal_weights
from ..tree.joinorder import guide_tree_join_order
from ..tree.kimura import kimura_dist_mx
from ..tree.kmerdist import kmer_dist_33, kmer_dist_66
from ..tree.upgma import upgma5

DEFAULT_GAP_OPEN = -6.0   # reference: src/blosum.cpp:69 (blosum62, set 0)
DEFAULT_CENTER = 0.8      # reference: src/blosum.cpp:69

# (pctid, param set) -> (gap open, center)
# reference: GetGapParams_Blosum src/blosum.cpp:50-75
GAP_PARAMS_BLOSUM = {
    (90, 0): (-7.3333335, 1.2),
    (90, 1): (-8.1662216, 1.0788642),
    (90, 2): (-6.7398319, 1.0459337),
    (90, 3): (-7.0647068, 1.2546233),
    (80, 0): (-6.6666665, 0.99999994),
    (80, 1): (-7.2274466, 0.91091353),
    (80, 2): (-7.6157303, 0.86217165),
    (80, 3): (-7.1673636, 0.85966408),
    (70, 0): (-6.2208495, 0.88161403),
    (70, 1): (-7.3177958, 0.70952064),
    (70, 2): (-7.1693735, 0.93325645),
    (70, 3): (-6.7926803, 0.71609467),
    (62, 0): (-6.0, 0.79999995),
    (62, 1): (-5.6413326, 0.71837389),
    (62, 2): (-6.6825562, 0.59377569),
    (62, 3): (-5.574501, 0.66151822),
}


class M3Params:
    """Muscle3 alignment parameters with ensemble perturbation.

    reference: M3AlnParams (src/m3alnparams.{h,cpp}) — BLOSUM scores with
    a center offset added, per-(pctid, set) gap params, and a
    std::minstd_rand perturbation stream over gap params, substitution
    matrix, and (later) the tree-iteration distance matrix. The
    reference ships only the BLOSUM62 matrix (GetSubstMx_Letter_Blosum
    dies for 90/80/70, src/blosum.cpp:33-48 — its -m3ensemble is broken
    as shipped); we use B62 scores with each family's gap params.
    """

    SMALL_PRIME = 997   # reference: src/m3alnparams.cpp Perturb1

    def __init__(self, pctid: int = 62, param_group: int = 0,
                 gap_open: float | None = None, center: float | None = None,
                 perturb_seed: int = 0,
                 perturb_substmx_delta: float = 0.0,
                 perturb_gap_delta: float = 0.0,
                 perturb_distmx_delta: float = 0.0,
                 linkage: str = "min", kmer_dist: str = "66",
                 tree_iters: int = 1):
        from ..utils.rng import MinStdRand
        base_open, base_center = GAP_PARAMS_BLOSUM[(pctid, param_group)]
        self.gap_open = float(gap_open if gap_open is not None else base_open)
        self.center = float(center if center is not None else base_center)
        self.subst = BLOSUM62.astype(np.float64) + self.center
        self.linkage = linkage
        self.kmer_dist = kmer_dist
        self.tree_iters = tree_iters
        self.perturb_seed = perturb_seed
        self.perturb_distmx_delta = perturb_distmx_delta
        self._rng = MinStdRand(perturb_seed) if perturb_seed else None
        # reference order: PerturbGapParams then PerturbSubstMx
        # (PerturbMyParams src/m3alnparams.cpp), center already added
        if self._rng is not None and perturb_gap_delta != 0.0:
            self.gap_open = self._perturb1(self.gap_open, perturb_gap_delta)
            self.center = self._perturb1(self.center, perturb_gap_delta)
        if self._rng is not None and perturb_substmx_delta != 0.0:
            for i in range(20):
                for j in range(20):
                    self.subst[i, j] = self._perturb1(
                        self.subst[i, j], perturb_substmx_delta)

    def _perturb1(self, v: float, max_delta: float) -> float:
        sign = -1.0 if self._rng.rand() % 2 == 0 else 1.0
        f = (self._rng.rand() % self.SMALL_PRIME) / self.SMALL_PRIME
        return v + sign * max_delta * f

    def perturb_dist_mx(self, d: np.ndarray) -> None:
        """In-place symmetric jitter of a distance matrix, continuing
        the parameter stream (reference: PerturbDistMx)."""
        if self._rng is None or self.perturb_distmx_delta == 0.0:
            return
        n = d.shape[0]
        for i in range(n):
            for j in range(i):
                v = self._perturb1(float(d[i, j]),
                                   self.perturb_distmx_delta)
                d[i, j] = d[j, i] = v

_AA_IDX = np.full(256, 20, dtype=np.int64)
for _i, _c in enumerate("ACDEFGHIKLMNPQRSTVWY"):
    _AA_IDX[ord(_c)] = _i
    _AA_IDX[ord(_c.lower())] = _i

NEG = np.float32(-9e9)


class Profile3:
    """Per-column weighted stats of an MSA (reference: Profile3/ProfPos3)."""

    def __init__(self, msa: MultiSequence, weights: np.ndarray,
                 subst: np.ndarray, gap_open: float):
        mat = msa.to_matrix()
        n, cols = mat.shape
        w = np.asarray(weights, dtype=np.float64)
        gaps = (mat == ord("-")) | (mat == ord("."))
        letters = _AA_IDX[mat]

        # weighted AA freqs (wildcards excluded), occupancy
        self.freqs = np.zeros((cols, 20), dtype=np.float64)
        valid = (~gaps) & (letters < 20)
        for a in range(20):
            self.freqs[:, a] = ((valid & (letters == a)) * w[:, None]).sum(0)
        self.occ = ((~gaps) * w[:, None]).sum(0)

        # dimer freqs: previous col + this col (reference: SetFreqs;
        # col 0 treats "previous" as a letter)
        letter_here = ~gaps
        letter_prev = np.ones_like(letter_here)
        letter_prev[:, 1:] = letter_here[:, :-1]
        self.lg = ((~letter_here & letter_prev) * w[:, None]).sum(0)
        self.gl = ((letter_here & ~letter_prev) * w[:, None]).sum(0)

        # position-specific gap open/close (reference: src/profile3.cpp:24-50)
        self.gap_open = np.empty(cols, dtype=np.float64)
        self.gap_open[0] = self.occ[0] * gap_open / 2
        self.gap_open[1:] = gap_open * (1.0 - self.lg[1:]) / 2
        self.gap_close = np.empty(cols, dtype=np.float64)
        self.gap_close[-1] = gap_open * self.occ[-1] / 2
        self.gap_close[:-1] = gap_open * (1.0 - self.gl[1:]) / 2

        self.col_count = cols
        self.subst = subst


def _nw_profile(pa: Profile3, pb: Profile3) -> tuple[float, str]:
    """Profile-profile NW with position-specific affine gaps, ext = 0
    (reference: NWSmall3 src/nwsmall3.cpp:200-400)."""
    a, b = pa.col_count, pb.col_count
    emit = pa.freqs @ pa.subst @ pb.freqs.T     # (a, b)
    oa, ca = pa.gap_open, pa.gap_close
    ob, cb = pb.gap_open, pb.gap_close

    M = np.full((a + 1, b + 1), NEG, dtype=np.float64)
    D = np.full((a + 1, b + 1), NEG, dtype=np.float64)
    I = np.full((a + 1, b + 1), NEG, dtype=np.float64)
    M[0, 0] = 0.0
    # traceback bits: 0..1 M-source (0=M,1=D,2=I), bit 4: D from D,
    # bit 5: I from I
    tb = np.zeros((a + 1, b + 1), dtype=np.uint8)

    # boundary: I along row 0, D along column 0
    I[0, 1] = ob[0]
    for j in range(2, b + 1):
        I[0, j] = I[0, j - 1]
        tb[0, j] |= 32
    D[1, 0] = oa[0]
    for i in range(2, a + 1):
        D[i, 0] = D[i - 1, 0]
        tb[i, 0] |= 16

    ca_pad = np.concatenate(([0.0], ca))        # closeA for last consumed col
    cb_pad = np.concatenate(([0.0], cb))

    for i in range(1, a + 1):
        # M row from previous row (vectorized over j)
        mm = M[i - 1, :-1]
        dm = D[i - 1, :-1] + (ca[i - 2] if i >= 2 else NEG)
        im = I[i - 1, :-1] + cb_pad[:-1]
        best = np.maximum(np.maximum(mm, dm), im)
        src = np.where((mm >= dm) & (mm >= im), 0,
                       np.where(dm >= im, 1, 2)).astype(np.uint8)
        M[i, 1:] = emit[i - 1] + best
        tb[i, 1:] = (tb[i, 1:] & ~np.uint8(3)) | src

        # D: vertical gap, from previous row (vectorized)
        dd = D[i - 1, :]
        md = M[i - 1, :] + oa[i - 1]
        D[i, :] = np.maximum(dd, md)
        tb[i, :] |= np.where(dd > md, 16, 0).astype(np.uint8)

        # I: horizontal gap, within-row running max (ext = 0)
        cand = M[i, :-1] + ob
        run = np.maximum.accumulate(cand)
        I[i, 1:] = run
        # I from I when the running max did not refresh at this j
        from_i = np.empty(b, dtype=bool)
        from_i[0] = False
        from_i[1:] = run[1:] > cand[1:]
        tb[i, 1:] |= np.where(from_i, 32, 0).astype(np.uint8)

    ends = (float(M[a, b]),
            float(D[a, b] + ca[a - 1]),
            float(I[a, b] + cb[b - 1]))
    state = int(np.argmax(ends))
    score = ends[state]

    # traceback
    path = []
    i, j = a, b
    st = "MDI"[state]
    while i > 0 or j > 0:
        if st == "M":
            path.append("B")
            src = tb[i, j] & 3
            i -= 1
            j -= 1
            st = "MDI"[src]
        elif st == "D":
            path.append("X")
            keep = tb[i, j] & 16
            i -= 1
            st = "D" if keep else "M"
        else:
            path.append("Y")
            keep = tb[i, j] & 32
            j -= 1
            st = "I" if keep else "M"
        if i == 0 and j > 0 and st != "I":
            st = "I"
        if j == 0 and i > 0 and st != "D":
            st = "D"
    path.reverse()
    return score, "".join(path)


class Muscle3:
    """reference: Muscle3::Run (src/muscle3.cpp:8-73)."""

    def __init__(self, gap_open: float = DEFAULT_GAP_OPEN,
                 center: float = DEFAULT_CENTER,
                 kmer_dist: str = "66", linkage: str = "min",
                 tree_iters: int = 1, params: M3Params | None = None):
        if params is None:
            params = M3Params(gap_open=gap_open, center=center,
                              linkage=linkage, kmer_dist=kmer_dist,
                              tree_iters=tree_iters)
        self.params = params
        self.subst = params.subst
        self.gap_open = params.gap_open
        self.kmer_dist = params.kmer_dist
        self.linkage = params.linkage
        self.tree_iters = params.tree_iters
        self.final_weights: np.ndarray | None = None  # input order

    def _progressive(self, seqs: MultiSequence, tree) -> MultiSequence:
        labels = seqs.labels()
        weights = clustal_weights(tree, labels)
        self.final_weights = np.asarray(weights, dtype=np.float64)
        l2i = {lb: i for i, lb in enumerate(labels)}
        idx1, idx2 = guide_tree_join_order(tree, l2i)

        nodes: list[MultiSequence | None] = [
            MultiSequence([s]) for s in seqs]
        node_w: list[np.ndarray | None] = [
            np.array([1.0]) for _ in seqs]
        raw_w: list[np.ndarray | None] = [
            np.array([weights[i]]) for i in range(len(seqs))]

        for k in range(len(idx1)):
            m1, m2 = nodes[idx1[k]], nodes[idx2[k]]
            rw1, rw2 = raw_w[idx1[k]], raw_w[idx2[k]]
            p1 = Profile3(m1, rw1 / rw1.sum(), self.subst, self.gap_open)
            p2 = Profile3(m2, rw2 / rw2.sum(), self.subst, self.gap_open)
            _, path = _nw_profile(p1, p2)
            joined = MultiSequence(
                [s.add_gaps_path(path, "X") for s in m1]
                + [s.add_gaps_path(path, "Y") for s in m2])
            nodes.append(joined)
            raw_w.append(np.concatenate([rw1, rw2]))
            nodes[idx1[k]] = nodes[idx2[k]] = None
        return nodes[-1]

    def run(self, seqs: MultiSequence) -> MultiSequence:
        labels = seqs.labels()
        d = (kmer_dist_66(seqs) if self.kmer_dist == "66"
             else kmer_dist_33(seqs))
        tree = upgma5(labels, d, self.linkage)
        msa = self._progressive(seqs, tree)

        for _ in range(self.tree_iters):
            # re-estimate the tree from Kimura distances of the current
            # MSA, in input order (reference: src/muscle3.cpp:43-72)
            by_label = {s.label: s for s in msa}
            ordered = MultiSequence([by_label[lb] for lb in labels])
            d = kimura_dist_mx(ordered).astype(np.float64)
            self.params.perturb_dist_mx(d)   # no-op unless ensemble
            tree = upgma5(labels, d, self.linkage)
            msa = self._progressive(seqs, tree)
        return msa


def muscle3_align(seqs: MultiSequence, **kw) -> MultiSequence:
    return Muscle3(**kw).run(seqs)


# ---------------------------------------------------------------------------
# m3 ensembles (-m3ensemble / -m3select / -m3refine)
# ---------------------------------------------------------------------------

def profile_self_score(msa: MultiSequence, subst: np.ndarray,
                       gap_open: float, weights: np.ndarray) -> float:
    """Sum over columns of f.S.f (reference: Profile3::GetSelfScore
    src/profile3.cpp:269-280, ScoreProfPos2 src/nwsmall3.cpp:35-56).
    `weights` are per-row, normalized internally."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    prof = Profile3(msa, w, subst, gap_open)
    return float(np.einsum("ca,ab,cb->", prof.freqs, subst, prof.freqs))


def _row_weights(m3: Muscle3, seqs: MultiSequence,
                 msa: MultiSequence) -> np.ndarray:
    """Final clustal weights reordered to msa row order."""
    by_label = {s.label: i for i, s in enumerate(seqs)}
    return np.array([m3.final_weights[by_label[s.label]] for s in msa])


def m3_ensemble(seqs: MultiSequence, out_file, replicates: int = 16) -> None:
    """Perturbed muscle3 replicate ensemble in EFA format
    (reference: cmd_m3ensemble src/cmd_m3ensemble.cpp:10-74 — gap-param
    family cycles 90/80/70/62, param set (i*7)%4, perturb seed i/4,
    all three perturbation deltas 0.1)."""
    delta = 0.1
    close = False
    if isinstance(out_file, str):
        out_file = open(out_file, "w")
        close = True
    try:
        for i in range(replicates):
            seed = i // 4
            group = 0 if replicates == 4 else (i * 7) % 4
            pctid = (90, 80, 70, 62)[i % 4]
            params = M3Params(pctid, group, perturb_seed=seed,
                              perturb_substmx_delta=delta,
                              perturb_gap_delta=delta,
                              perturb_distmx_delta=delta)
            msa = Muscle3(params=params).run(seqs)
            out_file.write(f"<blosum{pctid}:{group}.perturb{seed}"
                           f".delta{delta:.3g}\n")
            out_file.write(msa.to_fasta_text())
    finally:
        if close:
            out_file.close()


def m3_select(seqs: MultiSequence, replicates: int = 64) -> MultiSequence:
    """Best-of-N perturbed muscle3 runs by profile self-score under the
    unperturbed master params (reference: cmd_m3select
    src/m3select.cpp:16-85 — B62 set 0, distance-matrix-only
    perturbation, delta 0.1, seed = replicate index)."""
    master = M3Params(62, 0)
    best_msa = None
    best_score = 0.0
    for i in range(replicates):
        params = M3Params(62, 0, perturb_seed=i,
                          perturb_distmx_delta=0.1)
        m3 = Muscle3(params=params)
        msa = m3.run(seqs)
        score = profile_self_score(msa, master.subst, master.gap_open,
                                   _row_weights(m3, seqs, msa))
        if best_msa is None or score > best_score:
            best_msa = msa
            best_score = score
    return best_msa


def m3_refine(msa: MultiSequence, iters: int = 32,
              params: M3Params | None = None) -> MultiSequence:
    """Iterative 3-way split-and-realign refinement keeping the best
    profile self-score. The reference's M3Refine (src/m3refine.cpp:50)
    is unfinished dev code — it draws the same contiguous 3-way splits
    (SplitIndexes3 :15-48, randu32 stream) and computes the profile
    paths but discards them; this completes the evident intent by
    rebuilding the MSA from the three realigned blocks and keeping
    improvements."""
    from ..utils.rng import MwcRng

    if params is None:
        params = M3Params(62, 0)
    n = len(msa)
    if n < 3:
        return msa

    # weights from a Kimura-distance tree (reference: cmd_m3refine
    # src/m3refine.cpp:144-153)
    labels = msa.labels()
    d = kimura_dist_mx(msa)
    tree = upgma5(labels, d, "biased")
    weights = np.asarray(clustal_weights(tree, labels), dtype=np.float64)

    rng = MwcRng(1)
    best = msa
    best_score = profile_self_score(best, params.subst, params.gap_open,
                                    weights)
    for _ in range(iters):
        # contiguous 3-way split (reference: SplitIndexes3)
        ix0 = rng.randu32() % (n - 1)
        ix1 = rng.randu32() % (n - 1)
        if ix1 == ix0:
            ix1 = (ix1 + 1) % (n - 1)
        if ix0 > ix1:
            ix0, ix1 = ix1, ix0
        groups = [list(range(0, ix0 + 1)),
                  list(range(ix0 + 1, ix1 + 1)),
                  list(range(ix1 + 1, n))]

        subs = [best.project(g) for g in groups]
        subw = [weights[g] / weights[g].sum() for g in groups]
        p0 = Profile3(subs[0], subw[0], params.subst, params.gap_open)
        p1 = Profile3(subs[1], subw[1], params.subst, params.gap_open)
        _, path01 = _nw_profile(p0, p1)
        m01 = MultiSequence(
            [s.add_gaps_path(path01, "X") for s in subs[0]]
            + [s.add_gaps_path(path01, "Y") for s in subs[1]])
        w01 = np.concatenate([subw[0], subw[1]])
        p01 = Profile3(m01, w01 / w01.sum(), params.subst, params.gap_open)
        p2 = Profile3(subs[2], subw[2], params.subst, params.gap_open)
        _, path = _nw_profile(p01, p2)
        cand = MultiSequence(
            [s.add_gaps_path(path, "X") for s in m01]
            + [s.add_gaps_path(path, "Y") for s in subs[2]])
        # restore original row order
        by_label = {s.label: s for s in cand}
        cand = MultiSequence([by_label[lb] for lb in labels])
        score = profile_self_score(cand, params.subst, params.gap_open,
                                   weights)
        if score > best_score:
            best = cand
            best_score = score
    return best
