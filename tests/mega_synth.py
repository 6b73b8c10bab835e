"""Synthetic Muscle-3D `.mega` sets for the port's tests.

The reference's mega files are not in the repository, so the tests
build sets of the same width (8 features, as tests/test_e2e_mega.py
asserts): feature 0 the amino acids with the amino pair-HMM's own joint
probabilities (hmm/defaults.py), features 1-7 16-letter alphabets with
symmetric joint matrices and a dominant diagonal, weights summing to 1.
Chains are mutated copies of one random root (1-4 indels of 1-5
positions, then a truncation and substitutions). `mega_text` gives the
set in the reference's text format; both packages parse it.
"""

import numpy as np

AMINO = "ACDEFGHIKLMNPQRSTVWY"
N_FEATURES = 8


def _tables(rng):
    """(names, sizes, weights, joint probability matrices)."""
    from muscle_tpu_torch.hmm.params import HMMParams
    aa = HMMParams.from_defaults().emits.astype(np.float64)
    joints = [aa / aa.sum()]
    for _ in range(N_FEATURES - 1):
        m = rng.uniform(0.05, 1.0, (16, 16))
        m = m + m.T + np.diag(rng.uniform(6.0, 12.0, 16))
        joints.append(m / m.sum())
    w = np.concatenate([[0.4], rng.uniform(0.05, 0.15, N_FEATURES - 1)])
    w = w / w.sum()
    names = ["AA"] + [f"S{f}" for f in range(1, N_FEATURES)]
    return names, [20] + [16] * (N_FEATURES - 1), w, joints


def chains(n, lo, hi, seed):
    """n (L, 8) uint8 profiles, mutated copies of one random root, and
    each chain's root positions (-1 for inserted positions)."""
    rng = np.random.default_rng(seed)
    sizes = [20] + [16] * (N_FEATURES - 1)

    def column():
        return [int(rng.integers(0, k)) for k in sizes]

    root = [column() for _ in range(hi)]
    profs, origins = [], []
    for _ in range(n):
        rows = [list(c) for c in root]
        orig = list(range(hi))
        for _ in range(int(rng.integers(1, 5))):
            p, w = int(rng.integers(0, len(rows))), int(rng.integers(1, 6))
            if rng.random() < 0.5:
                del rows[p:p + w], orig[p:p + w]
            else:
                rows[p:p] = [column() for _ in range(w)]
                orig[p:p] = [-1] * w
        keep = int(rng.integers(lo, hi + 1))
        prof = np.array(rows[:keep], np.uint8)
        for f, k in enumerate(sizes):
            sub = rng.random(len(prof)) < 0.12
            prof[sub, f] = (prof[sub, f] + rng.integers(1, k, sub.sum())) % k
        profs.append(prof)
        origins.append(np.array(orig[:keep]))
    return profs, origins


def mega_text(n, lo, hi, seed):
    """The set in the reference's text format (what write_mega writes)."""
    rng = np.random.default_rng(seed + 7919)
    names, sizes, w, joints = _tables(rng)
    out = ["mega\t%d\t%d\t%.6g\t%.6g" % (N_FEATURES, n, 0.0, 0.0)]
    for f in range(N_FEATURES):
        k = sizes[f]
        p = joints[f]
        freqs = p.sum(axis=1)
        out.append("%d\t%s\t%d\t%.6g" % (f, names[f], k, w[f]))
        out.append("freqs\t" + "\t".join("%.6g" % v for v in freqs))
        for a in range(k):
            out.append("%d\t" % a + "\t".join("%.6g" % p[a, b]
                                              for b in range(a + 1)))
        out.append("logoddsmx")
        for a in range(k):
            ch = AMINO[a] if f == 0 else chr(ord("A") + a)
            out.append("%d\t%s\t" % (a, ch) + "\t".join(
                "%.6g" % np.log(p[a, b] / (freqs[a] * freqs[b]))
                for b in range(a + 1)))
    profs, _ = chains(n, lo, hi, seed)
    for c, prof in enumerate(profs):
        out.append("chain\t%d\tc%d\t%d" % (c, c, len(prof)))
        for pos, row in enumerate(prof):
            syms = AMINO[row[0]] + "".join(chr(ord("A") + v) for v in row[1:])
            out.append("%d\t%d\t%s" % (c, pos, syms))
    return "\n".join(out) + "\n"
