"""The -align slice of muscle_tpu_torch on the CPU, against muscle_tpu.

* small_family_store (one batched pair call, dense consistency, top-K
  sparsify) against the JAX package's on the same encoded family;
* align(device="cpu") column-identical to the reference binary's
  goldens (BB11001, nt3) and to muscle_tpu.align on a seeded family;
* the entry points refuse to run on the CPU unless asked, and pads
  beyond the long-pair threshold align as muscle_tpu aligns them;
* the CLI writes the same alignment as align().
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
import muscle_tpu
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import posteriors as j_post
from muscle_tpu_torch import MultiSequence, Sequence, align
from muscle_tpu_torch.cli import main as cli_main
from muscle_tpu_torch.hmm.params import HMMParams as THMMParams
from muscle_tpu_torch.ops.sparse import densify_np
from muscle_tpu_torch.pipeline import posteriors as t_post

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens")
NT = os.path.join(ROOT, "tests", "data", "nt")


def _family_fasta(n=6, lo=60, hi=96, seed=3):
    """A mutated-copy protein family as in tests/test_devjoin.py."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=hi)
    aas = "ARNDCQEGHILKMFPSTWYV"
    lines = []
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        mut = base[:ln].copy()
        nmut = int(rng.integers(0, ln // 3))
        pos = rng.integers(0, ln, size=nmut)
        mut[pos] = rng.integers(0, 20, size=nmut)
        lines.append(f">s{i}\n{''.join(aas[c] for c in mut)}\n")
    return "".join(lines)


def _rows(msa):
    return {s.label: s.text() for s in msa}


def _densify_store(sv, sc, n_pairs, ly):
    sv, sc = np.asarray(sv), np.asarray(sc)
    return np.stack([densify_np(sv[p], sc[p], ly) for p in range(n_pairs)])


def test_small_family_store_matches_jax():
    text = _family_fasta(n=5, seed=8)
    seqs = MultiSequence.from_fasta(text)
    from muscle_tpu_torch.alphabet import ALPHA_AMINO
    codes, lens = t_post.encode_batch(seqs, ALPHA_AMINO, pad_to=128)
    n = len(seqs)
    pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
    jv, jc, jea, jnnz = j_post.small_family_store(
        codes, lens, JHMMParams.from_defaults().to_scores(), pairs, n, 32,
        2, "highest")
    tv, tc, tea, tnnz = t_post.small_family_store(
        codes, lens, THMMParams.from_defaults().to_scores(), pairs, n, 32,
        2, torch.device("cpu"))
    assert tv.shape == tuple(np.asarray(jv).shape)
    assert np.max(np.abs(jea - tea)) < 1e-5
    assert int(jnnz) == int(tnnz)
    dj = _densify_store(jv, jc, len(pairs), 128)
    dt = _densify_store(tv.numpy(), tc.numpy(), len(pairs), 128)
    # the stored columns agree except where a value sits at the 0.01
    # threshold of the first posterior (a flip), and the values agree
    flip = (dj == 0) != (dt == 0)
    assert flip.sum() <= 4, int(flip.sum())
    assert np.max(np.abs(np.where(flip, 0.0, dj - dt))) < 1e-5
    # rows beyond the pairs are the empty dump slots
    assert not tv[len(pairs):].any()
    assert bool((tc[len(pairs):] == -1).all())


@pytest.mark.parametrize("inp,golden,strip", [
    ("BB11001.seq.afa", "BB11001.seq.afa", True),
    ("nt3.fa", "nt3.nt.afa", False),
], ids=["BB11001", "nt3"])
def test_align_cpu_column_identical_to_golden(inp, golden, strip):
    path = os.path.join(GOLDEN if strip else NT, inp)
    seqs = MultiSequence.from_fasta(path, strip_gaps=strip)
    msa = align(seqs, device="cpu")
    gold = MultiSequence.from_fasta(os.path.join(GOLDEN, golden))
    assert _rows(msa) == _rows(gold)


@pytest.fixture(scope="module")
def family_text():
    return _family_fasta()


def test_align_cpu_equals_jax_align(family_text):
    ours = align(MultiSequence.from_fasta(family_text), refine_iters=4,
                 device="cpu")
    ref = muscle_tpu.align(muscle_tpu.MultiSequence.from_fasta(family_text),
                           refine_iters=4)
    assert ours.labels() == ref.labels()
    assert _rows(ours) == _rows(ref)


@pytest.mark.parametrize("n,consiters", [(2, 2), (5, 0)],
                         ids=["two-seqs", "no-consistency"])
def test_align_cpu_sparse_branch_equals_jax(family_text, n, consiters):
    """n = 2 and -consiters 0 take the bucketed all-pairs store."""
    text = "".join(f">{c}" for c in family_text.split(">")[1:n + 1])
    ours = align(MultiSequence.from_fasta(text), refine_iters=4,
                 consistency_iters=consiters, device="cpu")
    ref = muscle_tpu.align(muscle_tpu.MultiSequence.from_fasta(text),
                           refine_iters=4, consistency_iters=consiters)
    assert _rows(ours) == _rows(ref)


def test_cli_writes_same_alignment(family_text, tmp_path):
    inp = tmp_path / "fam.fa"
    inp.write_text(family_text)
    out = tmp_path / "fam.afa"
    rc = cli_main(["-align", str(inp), "-output", str(out), "-refineiters",
                   "4", "-device", "cpu", "-quiet"])
    assert rc == 0
    want = align(MultiSequence.from_fasta(family_text), refine_iters=4,
                 device="cpu")
    assert out.read_text() == want.to_fasta_text()


def test_entry_points_refuse_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = MultiSequence([Sequence("a", "MKV"), Sequence("b", "MKI"),
                          Sequence("c", "MRV")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        align(seqs)
    from muscle_tpu_torch.pipeline.mpc import MPC
    with pytest.raises(RuntimeError):
        MPC()
    with pytest.raises(ValueError):
        align(seqs, device="meta")


def test_branches_not_ported_raise(monkeypatch):
    """The branch that raised before long pairs were ported, pads beyond
    LONG_PAIR_THRESHOLD, now aligns as muscle_tpu aligns it. Both
    packages' threshold is lowered to 128 and their dense branch to
    n·L <= 512, so the three 200-residue sequences (pad 256) reach the
    long-pair router: every pair takes the scan route on the CPU."""
    for mod in (t_post, j_post):
        monkeypatch.setattr(mod, "LONG_PAIR_THRESHOLD", 128)
        monkeypatch.setattr(mod, "SMALL_DENSE_NL", 512)
    rng = np.random.default_rng(0)
    text = "".join(
        f">s{i}\n" + "".join("ACDEFGHIKLMNPQRSTVWY"[c]
                             for c in rng.integers(0, 20, 200)) + "\n"
        for i in range(3))
    t_post.reset_routes()
    ours = align(MultiSequence.from_fasta(text), device="cpu")
    ref = muscle_tpu.align(muscle_tpu.MultiSequence.from_fasta(text))
    assert t_post.ROUTES == {"in_cap": 0, "transposed": 0, "striped": 0,
                             "scan": 3}
    assert ours.to_fasta_text() == ref.to_fasta_text()
