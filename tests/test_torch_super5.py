"""Super5's host modules and pair service in muscle_tpu_torch, on the
CPU, against muscle_tpu on the same numpy-seeded inputs.

* `PairAligner.ea` / `ea_dist_matrix` against muscle_tpu's on
  mixed-length pairs in both orientations (length-bucketed calls), and
  its dense `posteriors`;
* a reversed pair's posterior is the forward pair's transposed;
* `KmerIndex.search`, `UClust.run` and `EACluster.run` equal;
* `make_extended_msa` and `consensus_sequence` equal on the cases of
  tests/test_super5.py and on a random case;
* `-super5` and `-align -minsuper` through the CLI.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
import muscle_tpu
from muscle_tpu.alphabet import ALPHA_AMINO as J_AMINO
from muscle_tpu.alphabet import encode as j_encode
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import pairwise as j_pw
from muscle_tpu.pipeline import super4 as j_s4
from muscle_tpu.pipeline import transaln as j_ta
from muscle_tpu.pipeline import uclust as j_uc
from muscle_tpu_torch import MultiSequence, Sequence, super5
from muscle_tpu_torch.alphabet import ALPHA_AMINO, encode
from muscle_tpu_torch.cli import main as cli_main
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import sparse as sp
from muscle_tpu_torch.pipeline import pairwise as t_pw
from muscle_tpu_torch.pipeline import super4 as t_s4
from muscle_tpu_torch.pipeline import transaln as t_ta
from muscle_tpu_torch.pipeline import uclust as t_uc

AAS = "ARNDCQEGHILKMFPSTWYV"


def _both(text):
    return (MultiSequence.from_fasta(text),
            muscle_tpu.MultiSequence.from_fasta(text))


def _random_seqs(rng, lengths, prefix="s"):
    return "".join(f">{prefix}{i}\n{''.join(AAS[c] for c in rng.integers(0, 20, ln))}\n"
                   for i, ln in enumerate(lengths))


def _near_family(rng, n, lo, hi, sub=(0.0, 0.3), prefix="s"):
    """Truncated, substituted copies of one random protein (as
    tests/test_devjoin.py builds a family)."""
    base = rng.integers(0, 20, size=hi)
    lines = []
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        mut = base[:ln].copy()
        k = int(rng.integers(int(sub[0] * ln), int(sub[1] * ln) + 1))
        pos = rng.integers(0, ln, size=k)
        mut[pos] = rng.integers(0, 20, size=k)
        lines.append(f">{prefix}{i}\n{''.join(AAS[c] for c in mut)}\n")
    return "".join(lines)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU scan runs many small ops, which gain nothing from
    intra-op threads; one thread keeps it from crowding the other test
    workers on the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def packs():
    return (HMMParams.from_defaults().to_scores(),
            JHMMParams.from_defaults().to_scores())


def test_pair_aligner_ea_matches_jax(packs):
    """Mixed lengths (30-200: buckets 128 and 256 in one call) in both
    orientations, at the tolerance tests/test_torch_pairhmm.py holds the
    scan to."""
    rng = np.random.default_rng(11)
    text = _near_family(rng, 7, 30, 200)
    tseqs, jseqs = _both(text)
    pairs = [(0, 1), (1, 0), (2, 5), (5, 2), (3, 6), (6, 4), (0, 6),
             (4, 1), (3, 2), (6, 0), (2, 2)]
    t_al = t_pw.PairAligner(tseqs, packs[0], ALPHA_AMINO, device="cpu")
    j_al = j_pw.PairAligner(jseqs, packs[1], J_AMINO)
    assert t_al.codes.shape == j_al.codes.shape
    ours, ref = t_al.ea(pairs), np.asarray(j_al.ea(pairs))
    assert ours.shape == ref.shape
    assert float(np.abs(ours - ref).max()) < 1e-5
    # the distance matrix holds the EA of its one call over the upper
    # triangle (recorded, not recomputed: the call's pair set decides
    # the buckets)
    calls = []
    ea_of = t_al.ea
    t_al.ea = lambda p: calls.append((p, ea_of(p))) or calls[-1][1]
    d_ours = t_al.ea_dist_matrix()
    upper = [(i, j) for i in range(7) for j in range(i + 1, 7)]
    assert len(calls) == 1 and calls[0][0] == upper
    assert np.array_equal(d_ours[tuple(np.array(upper).T)], calls[0][1])
    assert np.array_equal(d_ours, d_ours.T)
    # the dense pass: whole (L, L) posteriors at the set's padded width
    post, ea = t_al.posteriors(pairs[:2])
    j_post, j_ea = j_al.posteriors(pairs[:2])
    assert post.shape == np.asarray(j_post).shape
    assert float(np.abs(post - np.asarray(j_post)).max()) < 1e-5
    assert float(np.abs(ea - np.asarray(j_ea)).max()) < 1e-5


def test_reversed_pair_gives_transposed_posterior(packs):
    """Store rows of (x, y) and (y, x): each equals muscle_tpu's row for
    the same orientation (the scan's tolerance, 1e-5), and the reversed
    posterior is the forward one transposed within 1e-2, the EA within
    2e-3. Not within the kernel gate's 2e-3 for the posterior: the
    pair-HMM is symmetric, but the reference's LOGEXP1 cubic
    approximates each log-add, and summing in the other order moves
    cells by more than 2e-3 on this input, in muscle_tpu exactly as here
    (cells at the 0.01 threshold ignored)."""
    rng = np.random.default_rng(12)
    text = _near_family(rng, 3, 70, 130)
    tseqs, jseqs = _both(text)
    al = t_pw.PairAligner(tseqs, packs[0], ALPHA_AMINO, device="cpu")
    j_al = j_pw.PairAligner(jseqs, packs[1], J_AMINO)
    pairs = [(0, 1), (1, 0), (2, 1), (1, 2)]
    sv, sc, ea, _ = al.sparse_store(pairs)
    jv, jc, jea, _ = j_al.sparse_store(pairs)
    width = al.codes.shape[1]
    dense = [sp.densify_np(sv[k].numpy(), sc[k].numpy(), width)
             for k in range(4)]
    j_dense = [sp.densify_np(np.asarray(jv[k]), np.asarray(jc[k]), width)
               for k in range(4)]
    for k in range(4):
        assert float(np.abs(dense[k] - j_dense[k]).max()) < 1e-5
    assert float(np.abs(ea - np.asarray(jea)).max()) < 1e-5

    def off_transpose(d, f, r):
        got, want = d[r].T, d[f]
        flip = (((got == 0) | (want == 0))
                & (np.maximum(got, want) <= 0.0102))
        return float(np.where(flip, 0.0, np.abs(got - want)).max())
    for f, r in ((0, 1), (2, 3)):
        assert off_transpose(dense, f, r) < 1e-2
        assert abs(float(ea[f]) - float(ea[r])) < 2e-3
    # muscle_tpu's own reversed posterior is off by more than 2e-3
    assert off_transpose(j_dense, 0, 1) > 2e-3
    views, _ = al.csr_posteriors(pairs[:2])
    assert len(views[0][2]) == len(tseqs[0]) + 1
    assert len(views[1][2]) == len(tseqs[1]) + 1


def test_kmer_index_search_matches_jax():
    rng = np.random.default_rng(13)
    # low-complexity rows repeat words in the query and in the index
    text = (_near_family(rng, 12, 50, 120, prefix="a")
            + _random_seqs(rng, [80, 3, 2, 95])
            + ">rep0\nMKMKMKMKMKAAAAAAAAAAWWWMKMKAAAAGGG\n"
            + ">rep1\nAAAAAAAMKMKMKMKWWWWWWGGGAAA\n"
            + ">rep2\nMKMKMKAAAAAAAAAAAAGGGWWW\n")
    tseqs, _ = _both(text)
    t_idx, j_idx = t_uc.KmerIndex(ALPHA_AMINO), j_uc.KmerIndex(J_AMINO)
    codes = [encode(s.bytes_view(), ALPHA_AMINO) for s in tseqs]
    for i in range(0, len(codes), 2):
        t_idx.add(codes[i], i)
        j_idx.add(j_encode(tseqs[i].bytes_view(), J_AMINO), i)
    for i, c in enumerate(codes):
        want = j_idx.search(j_encode(tseqs[i].bytes_view(), J_AMINO))
        assert t_idx.search(c) == want
    assert t_idx.search(codes[1])


def test_uclust_and_eacluster_match_jax(packs):
    """Centroids, seq_to_centroid and member paths (UCLUST at 0.99) and
    the EACluster partition (0.7 and 0.9) on two families with
    near-duplicates and one unrelated sequence, small waves so queries
    defer across them."""
    rng = np.random.default_rng(14)
    text = (_near_family(rng, 5, 60, 90, sub=(0.0, 0.4), prefix="a")
            + _near_family(rng, 4, 50, 70, sub=(0.1, 0.5), prefix="b")
            + _random_seqs(rng, [75], prefix="r"))
    tseqs, jseqs = _both(text)
    t_al = t_pw.PairAligner(tseqs, packs[0], ALPHA_AMINO, device="cpu")
    j_al = j_pw.PairAligner(jseqs, packs[1], J_AMINO)
    ours = t_uc.UClust(t_al, ALPHA_AMINO, wave_size=5).run(tseqs, 0.99)
    ref = j_uc.UClust(j_al, J_AMINO, wave_size=5).run(jseqs, 0.99)
    assert ours[0] == ref[0]
    assert np.array_equal(ours[1], ref[1])
    assert ours[2] == ref[2]
    assert 1 < len(ours[0]) < len(tseqs)
    for min_ea in (0.7, 0.9):
        got = t_uc.EACluster(t_al, ALPHA_AMINO, wave_size=4).run(
            list(range(len(tseqs))), tseqs, min_ea)
        want = j_uc.EACluster(j_al, J_AMINO, wave_size=4).run(
            list(range(len(jseqs))), jseqs, min_ea)
        assert got == want
        assert len(got) > 1


def _random_transaln_case(rng):
    """A random gapped MSA and fresh sequences, each with a random
    X/Y/B path against the ungapped form of a random MSA row."""
    ncols, nrows = 40, 4
    rows = []
    for r in range(nrows):
        t = [AAS[c] for c in rng.integers(0, 20, ncols)]
        for c in rng.choice(ncols, int(rng.integers(0, 12)), replace=False):
            t[c] = "-"
        rows.append((f"m{r}", "".join(t)))
    fresh, to_row, paths = [], [], []
    for f in range(5):
        r = int(rng.integers(0, nrows))
        m = len(rows[r][1].replace("-", ""))
        fl = int(rng.integers(m - 8, m + 8))
        b = int(rng.integers(0, min(fl, m) + 1))
        ops = list("B" * b + "X" * (fl - b) + "Y" * (m - b))
        rng.shuffle(ops)
        fresh.append((f"f{f}", "".join(AAS[c] for c in rng.integers(0, 20, fl))))
        to_row.append(r)
        paths.append("".join(ops))
    return rows, fresh, to_row, paths


def test_transaln_and_consensus_match_jax():
    cases = [
        ([("c1", "AC-D"), ("c2", "ACED")], [("f1", "ACWD")], [0], ["BBXB"]),
        *[_random_transaln_case(np.random.default_rng(s)) for s in (15, 16)],
    ]
    for rows, fresh, to_row, paths in cases:
        t_msa = MultiSequence([Sequence(lb, t) for lb, t in rows])
        j_msa = muscle_tpu.MultiSequence(
            [muscle_tpu.Sequence(lb, t) for lb, t in rows])
        got = t_ta.make_extended_msa(
            t_msa, [Sequence(lb, t) for lb, t in fresh], to_row, paths)
        want = j_ta.make_extended_msa(
            j_msa, [muscle_tpu.Sequence(lb, t) for lb, t in fresh], to_row,
            paths)
        assert got.to_fasta_text() == want.to_fasta_text()
        assert (t_s4.consensus_sequence(got, ALPHA_AMINO)
                == j_s4.consensus_sequence(want, J_AMINO))
        assert (t_s4.consensus_sequence(t_msa, ALPHA_AMINO)
                == j_s4.consensus_sequence(j_msa, J_AMINO))
    for pw, mp in (("BB", "MGM"), ("BXB", "MM"), ("BYB", "MMM")):
        assert t_ta.make_tpath1(pw, mp) == j_ta.make_tpath1(pw, mp)
    three = [("a", "AC-D"), ("b", "ACED"), ("c", "AC-D")]
    assert t_s4.consensus_sequence(
        MultiSequence([Sequence(*r) for r in three]), ALPHA_AMINO) == "ACD"


SMALL5 = [("s0", "MKVLITGGAGFIGSHLVDELLRRGHEVIVLDNLSTGKKENLP"),
          ("s1", "MKVLITGGAGFIGSHLVDELLRRGHEVIVLDNLSTGKKENLP"),
          ("s2", "MKVLITGGAGFIGSHLVDELLRRGHEVIVLDNLSTGKKENLA"),
          ("s3", "MKVLITGGAGFIGSHLVDELWLRRGHEVIVLDNLSTGKKENLP"),
          ("s4", "WQERTYPHASDNGKLIVMFCWQERTYPHASDNGKLIVMFC")]


def test_cli_super5_and_minsuper(tmp_path):
    """-super5 and -align -minsuper write super5()'s alignment (the
    small case of tests/test_super5.py: a dupe, a member, two clusters);
    -align below -minsuper runs MPC."""
    inp = tmp_path / "in.fa"
    inp.write_text("".join(f">{lb}\n{t}\n" for lb, t in SMALL5))
    seqs = MultiSequence.from_fasta(str(inp))
    want = super5(seqs, refine_iters=2, device="cpu").to_fasta_text()
    rows = {s.label: s.text() for s in MultiSequence.from_fasta(want)}
    assert rows["s0"] == rows["s1"]
    for lb, t in SMALL5:
        assert rows[lb].replace("-", "") == t
    for args in (["-super5", str(inp)],
                 ["-align", str(inp), "-minsuper", "5"]):
        out = tmp_path / "out.afa"
        assert cli_main(args + ["-output", str(out), "-refineiters", "2",
                                "-device", "cpu", "-quiet"]) == 0
        assert out.read_text() == want
    out = tmp_path / "mpc.afa"
    assert cli_main(["-align", str(inp), "-minsuper", "6", "-output",
                     str(out), "-refineiters", "2", "-device", "cpu",
                     "-quiet"]) == 0
    from muscle_tpu_torch import align
    assert out.read_text() == align(seqs, refine_iters=2,
                                    device="cpu").to_fasta_text()


def test_super5_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        super5(MultiSequence([Sequence(lb, t) for lb, t in SMALL5]))
