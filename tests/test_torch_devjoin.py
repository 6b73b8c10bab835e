"""The device refine joins of muscle_tpu_torch on the CPU (plain
versions of kernel 7 and of the MEA direction DP), against numpy
oracles, the port's host join path and muscle_tpu.

* `densify_reduce_plain` equals a numpy loop over t in order, bit for
  bit, with dump pairs and empty (padding) rows in the grid;
* `mea_dirs_plain` + `_walk` give ops/mea.py::mea_align's path;
* `DeviceJoiner.align` gives muscle_tpu's DeviceJoiner path on the same
  store and split (both grid orientations carry real pairs);
* `align(device="cpu")` on the blocked branch with device refine gives
  muscle_tpu.align's AFA text, and device refine gives host refine's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
import muscle_tpu
from muscle_tpu.alphabet import ALPHA_AMINO
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import devjoin as j_dj
from muscle_tpu.pipeline import posteriors as j_post
from muscle_tpu_torch import MultiSequence, align
from muscle_tpu_torch.ops import devjoin_cuda as t_djc
from muscle_tpu_torch.ops.mea import mea_align
from muscle_tpu_torch.pipeline import devjoin as t_dj
from muscle_tpu_torch.pipeline import mpc as t_mpc
from muscle_tpu_torch.pipeline import posteriors as t_post


def _family_text(n=16, lo=60, hi=110, seed=3):
    """Mutated copies of one random protein (tests/test_devjoin.py)."""
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


def _dr_oracle(sv, sc, k2, pid, bank, dump, cc):
    n_r, n_c = pid.shape
    l = sv.shape[1]
    f = np.zeros((n_r, l, cc), np.float32)
    for s in range(n_r):
        for t in range(n_c):
            p = pid[s, t]
            if p == dump:
                continue
            r, k = np.nonzero(sc[p, :, :k2] >= 0)
            f[s, r, bank[t, sc[p, r, k]]] += sv[p, r, k]
    return f


def test_densify_reduce_plain_matches_oracle():
    rng = np.random.default_rng(7)
    l, kk, k2, cc, n_r, n_c, p1 = 32, 12, 8, 45, 5, 4, 14
    dump = p1 - 1
    sv = np.zeros((p1, l, kk), np.float32)
    sc = np.full((p1, l, kk), -1, np.int32)
    for p in range(dump):
        rows = int(rng.integers(l // 2, l + 1))  # rows past it: padding
        for r in range(rows):
            nnz = int(rng.integers(1, 6))
            sc[p, r, :nnz] = rng.choice(l, nnz, replace=False)
            sv[p, r, :nnz] = rng.random(nnz) * 0.9 + 0.02
    pid = rng.integers(0, dump, size=(n_r, n_c)).astype(np.int32)
    pid[rng.random((n_r, n_c)) < 0.4] = dump
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n_c)]).astype(np.int32)
    got = t_djc.densify_reduce(torch.from_numpy(sv), torch.from_numpy(sc),
                               k2, torch.from_numpy(pid),
                               torch.from_numpy(bank), dump, cc)
    want = _dr_oracle(sv, sc, k2, pid, bank, dump, cc)
    assert got.shape == (n_r, l, cc)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cc1,cc2", [(40, 57), (23, 16), (1, 33)])
def test_mea_dirs_walk_matches_mea_align(cc1, cc2):
    rng = np.random.default_rng(cc1 * 100 + cc2)
    post = (rng.random((cc1, cc2)) ** 3).astype(np.float32)
    packed, scores = t_djc.mea_dirs(torch.from_numpy(post))
    assert packed.shape == (cc1, -(-cc2 // 16))
    assert packed.dtype == torch.int32
    want_score, want_path = mea_align(post)
    assert t_dj._walk(packed.numpy(), cc1, cc2) == want_path
    assert abs(float(scores[-1]) - want_score) <= 1e-4 * abs(want_score)


def test_joiner_matches_jax():
    """One join on real posteriors (muscle_tpu's pair store) split as a
    refine iteration would, interleaved so both grid orientations carry
    real pairs; as tests/test_devjoin.py:125-168."""
    text = _family_text(n=10, seed=5)
    jseqs = muscle_tpu.MultiSequence.from_fasta(text)
    n = len(jseqs)
    pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
    codes, lens = j_post.encode_batch(jseqs, ALPHA_AMINO, pad_to=128)
    sv, sc, _, max_nnz = j_post.all_pairs_posteriors_sparse(
        codes, lens, JHMMParams.from_defaults().to_scores(), pairs,
        batch_size=len(pairs))
    l2i = {s.label: i for i, s in enumerate(jseqs)}
    nnz = min(int(max_nnz), 32)
    j_joiner = j_dj.DeviceJoiner(sv, sc, pairs, lens, n, nnz, l2i)
    t_joiner = t_dj.DeviceJoiner(torch.from_numpy(np.array(sv)),
                                 torch.from_numpy(np.array(sc)), pairs, n,
                                 nnz, l2i)
    msa = align(MultiSequence.from_fasta(text), refine_iters=2,
                device="cpu")
    rows = [s for lb in (f"s{i}" for i in range(n))
            for s in msa if s.label == lb]
    m1 = MultiSequence(rows[0::2]).project(range((n + 1) // 2))
    m2 = MultiSequence(rows[1::2]).project(range(n // 2))
    j_m1, j_m2 = (muscle_tpu.MultiSequence.from_fasta(m.to_fasta_text())
                  for m in (m1, m2))
    j_score, j_path = j_joiner.align(j_m1, j_m2)
    t_score, t_path = t_joiner.align(m1, m2)
    assert t_path == j_path
    assert abs(t_score - j_score) <= 1e-5 * abs(j_score)


@pytest.fixture(scope="module")
def family16():
    return _family_text()


def test_align_blocked_device_refine_matches_jax(family16, monkeypatch):
    """The blocked Gram branch (SMALL_DENSE_NL lowered in both packages)
    with device refine forced in both gives the same AFA text."""
    monkeypatch.setattr(j_post, "SMALL_DENSE_NL", 64)
    monkeypatch.setattr(t_post, "SMALL_DENSE_NL", 64)
    monkeypatch.setattr(t_mpc, "DEVICE_REFINE_N", 1)
    monkeypatch.setenv("MUSCLE_TPU_DEVICE_REFINE", "1")
    ours = align(MultiSequence.from_fasta(family16), refine_iters=12,
                 device="cpu")
    ref = muscle_tpu.align(muscle_tpu.MultiSequence.from_fasta(family16),
                           refine_iters=12)
    assert ours.to_fasta_text() == ref.to_fasta_text()


def test_device_refine_matches_host(family16, monkeypatch):
    seqs = MultiSequence.from_fasta(family16)
    host = align(seqs, refine_iters=12, device="cpu")
    monkeypatch.setattr(t_mpc, "DEVICE_REFINE_N", 1)
    dev = align(seqs, refine_iters=12, device="cpu")
    assert host.labels() == dev.labels()
    assert _rows(host) == _rows(dev)


def test_joiner_on_dense_branch_store():
    """A DeviceJoiner over the dense branch's store (trimmed K, padding
    rows and the trailing dump row) gives the host join's path."""
    from muscle_tpu_torch.alphabet import ALPHA_AMINO as T_AMINO
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.pipeline.progressive import align_alns
    seqs = MultiSequence.from_fasta(_family_text(n=7, seed=9))
    n = len(seqs)
    pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
    codes, lens = t_post.encode_batch(seqs, T_AMINO, pad_to=128)
    sv, sc, _, nnz = t_post.small_family_store(
        codes, lens, HMMParams.from_defaults().to_scores(), pairs, n, 32, 2,
        torch.device("cpu"))
    k2 = max(8, -(-int(nnz) // 8) * 8)
    sv, sc = sv[:, :, :k2].contiguous(), sc[:, :, :k2].contiguous()
    posts = t_post.posts_from_store(sv, sc, pairs, lens)
    l2i = {s.label: i for i, s in enumerate(seqs)}
    joiner = t_dj.DeviceJoiner(sv, sc, pairs, n, int(nnz), l2i)
    msa = align(seqs, refine_iters=0, device="cpu")
    m1 = msa.project([0, 3, 4])
    m2 = msa.project([1, 2, 5, 6])
    host_msa, host_score = align_alns(m1, m2, l2i, posts)
    score, path = joiner.align(m1, m2)
    assert abs(score - host_score) <= 1e-5 * abs(host_score)
    from muscle_tpu_torch.pipeline.progressive import join_by_path
    assert _rows(join_by_path(m1, m2, path)) == _rows(host_msa)
