"""PProg's joins and the Super5 pipeline of muscle_tpu_torch, on the CPU,
against muscle_tpu on the same numpy-seeded inputs.

* `get_pairs` equal for the same MwcRng seed, below and above
  target * 3 // 2 (all pairs / sampled), and the stream left equal;
* `densify_reduce_list_plain` (kernel 7L's plain version) equals a
  numpy transcription of muscle_tpu/pipeline/devjoin.py:223-232 (the
  inverse-map compare and the scatter-add over the entries) exactly;
* `align_sampled_device` gives muscle_tpu's path (score within 1e-5)
  on two joins read from one grouped store, the second at
  row_offset > 0, and `PProg.path_msas` its path on the host and on
  the device.
(`Super5.run` end to end: tests/test_torch_super5_run.py.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
import muscle_tpu
from muscle_tpu.alphabet import ALPHA_AMINO as J_AMINO
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import devjoin as j_dj
from muscle_tpu.pipeline import pairwise as j_pw
from muscle_tpu.pipeline import pprog as j_pp
from muscle_tpu.utils.rng import MwcRng as JMwcRng
from muscle_tpu_torch import MultiSequence, Sequence
from muscle_tpu_torch.alphabet import ALPHA_AMINO
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import devjoin_cuda as t_djc
from muscle_tpu_torch.pipeline import devjoin as t_dj
from muscle_tpu_torch.pipeline import pairwise as t_pw
from muscle_tpu_torch.pipeline import pprog as t_pp
from muscle_tpu_torch.utils.rng import MwcRng

AAS = "ARNDCQEGHILKMFPSTWYV"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU scan runs many small ops, which gain nothing from
    intra-op threads; one thread keeps it from crowding the other test
    workers on the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("count1,count2,target",
                         [(7, 9, 50), (30, 40, 100), (12, 12, 20),
                          (5, 5, 0)])
def test_get_pairs_matches_jax(count1, count2, target):
    t_rng, j_rng = MwcRng(3), JMwcRng(3)
    got = t_pp.get_pairs(count1, count2, target, t_rng)
    want = j_pp.get_pairs(count1, count2, target, j_rng)
    assert got == want
    assert t_rng.randu32() == j_rng.randu32()
    sampled = count1 * count2 >= target * 3 // 2 and target > 0
    assert (len(got) < count1 * count2) == sampled


def _list_oracle(sv, sc, k2, pid, ro, co, imap, n_r, cc):
    """numpy transcription of list_build_and_mea's F: per entry p, the
    compare-accumulate against its col-owner's inverse map
    (devjoin.py:105-110 with per_pair_imap), then f[ro[p]] += e in
    entry order (devjoin.py:223-232)."""
    l = sv.shape[1]
    f = np.zeros((n_r, l, cc), np.float32)
    for p in range(len(pid)):
        inv = imap[co[p]][None, :]
        e = sv[pid[p], :, 0:1] * (sc[pid[p], :, 0:1] == inv)
        for k in range(1, k2):
            e = e + sv[pid[p], :, k:k + 1] * (sc[pid[p], :, k:k + 1] == inv)
        f[ro[p]] = f[ro[p]] + e
    return f


def test_densify_reduce_list_plain_matches_numpy():
    rng = np.random.default_rng(21)
    l, kk, k2, p1, n_r, n2, cc = 24, 10, 6, 30, 5, 4, 40
    dump = p1 - 1
    sv = np.zeros((p1, l, kk), np.float32)
    sc = np.full((p1, l, kk), -1, np.int32)
    for p in range(dump):
        for r in range(int(rng.integers(l // 2, l + 1))):
            nnz = int(rng.integers(1, 6))
            sc[p, r, :nnz] = rng.choice(l, nnz, replace=False)
            sv[p, r, :nnz] = rng.random(nnz) * 0.9 + 0.02
    # col-owners' maps: pos->col (bank), and JAX's col->pos (-1 at gaps)
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n2)]).astype(np.int32)
    imap = np.full((n2, cc), -1, np.int32)
    for t in range(n2):
        imap[t, bank[t]] = np.arange(l)
    n_e = 23
    ro = np.sort(rng.integers(0, n_r, n_e))
    ro[ro == 2] = 3                        # owner 2 has no entry
    pid = rng.integers(0, dump, n_e).astype(np.int32)
    pid[[4, 9]] = dump                     # dump entries add nothing
    co = rng.integers(0, n2, n_e).astype(np.int32)
    row_ptr = np.zeros(n_r + 1, np.int32)
    np.cumsum(np.bincount(ro, minlength=n_r), out=row_ptr[1:])
    got = t_djc.densify_reduce_list(
        *(torch.from_numpy(a) for a in (sv, sc)), k2,
        *(torch.from_numpy(a) for a in (row_ptr, pid, co, bank)), dump, cc)
    want = _list_oracle(sv, sc, k2, pid, ro, co, imap, n_r, cc)
    assert got.shape == (n_r, l, cc)
    assert np.array_equal(got.numpy(), want)
    assert not got[2].any()


def _families_text(seed, fams=3, per=8, lo=60, hi=90):
    """`fams` families of truncated, substituted copies of a random
    protein (10-33 % of positions redrawn), then two exact duplicates
    and three single-substitution near-duplicates of family members."""
    rng = np.random.default_rng(seed)
    rows = []
    for f in range(fams):
        base = rng.integers(0, 20, size=hi)
        for i in range(per):
            ln = int(rng.integers(lo, hi + 1))
            mut = base[:ln].copy()
            pos = rng.integers(0, ln, size=int(rng.integers(ln // 10,
                                                            ln // 3)))
            mut[pos] = rng.integers(0, 20, size=len(pos))
            rows.append((f"f{f}s{i}", "".join(AAS[c] for c in mut)))
    for d in range(2):
        rows.append((f"dup{d}", rows[3 * d + 1][1]))
    for d in range(3):
        s = rows[5 * d + 2][1]
        p = int(rng.integers(0, len(s)))
        rows.append((f"near{d}", s[:p] + AAS[(AAS.index(s[p]) + 1) % 20]
                     + s[p + 1:]))
    return "".join(f">{lb}\n{t}\n" for lb, t in rows)


def _gapped(seqs, width, seed):
    """Each sequence with gaps at random places to `width` columns: an
    MSA as far as the joins care (pos->col maps, all-gap columns)."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in seqs:
        t = np.full(width, "-")
        t[np.sort(rng.choice(width, len(s), replace=False))] = list(s.text())
        rows.append(Sequence(s.label, "".join(t)))
    return MultiSequence(rows)


def test_align_sampled_device_matches_jax(monkeypatch):
    """Two PProg joins read from one grouped store of muscle_tpu's (the
    second at row_offset > 0), each sampled as PProg samples it: the
    port's list variant gives JAX's path, the score within 1e-5."""
    text = _families_text(31, fams=1, per=14)
    seqs = MultiSequence.from_fasta(text)
    msa = _gapped(seqs, 100, 32)
    joins = [(msa.project([0, 2, 4, 6, 8, 10]), msa.project([1, 3, 5, 7, 9])),
             (msa.project([11, 12, 13, 14, 15, 0, 3]),
              msa.project([2, 5, 9, 10, 1]))]
    l2g = {s.label: i for i, s in enumerate(seqs)}
    rng = MwcRng(1)
    plan = []
    for m1, m2 in joins:
        sampled = t_pp.get_pairs(len(m1), len(m2), 20, rng)
        assert len(sampled) < len(m1) * len(m2)
        plan.append((sampled, [(l2g[m1[i].label], l2g[m2[j].label])
                               for i, j in sampled]))
    gpairs = plan[0][1] + plan[1][1]
    jseqs = muscle_tpu.MultiSequence.from_fasta(text)
    j_al = j_pw.PairAligner(jseqs, JHMMParams.from_defaults().to_scores(),
                            J_AMINO)
    jv, jc, _, mx = j_al.sparse_store(gpairs)
    tv, tc = torch.from_numpy(np.array(jv)), torch.from_numpy(np.array(jc))
    offset = 0
    for (m1, m2), (sampled, _) in zip(joins, plan):
        j1, j2 = (muscle_tpu.MultiSequence.from_fasta(m.to_fasta_text())
                  for m in (m1, m2))
        want = j_dj.align_sampled_device(jv, jc, sampled, j1, j2, mx,
                                         row_offset=offset)
        got = t_dj.align_sampled_device(tv, tc, sampled, m1, m2, mx,
                                        row_offset=offset)
        assert got[1] == want[1]
        assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
        offset += len(sampled)
    # path_msas, the one-join entry with a store of its own: the host
    # join (20 pairs < DEVICE_JOIN_N), then forced to the device
    (m1, m2), (sampled, _) = joins[0], plan[0]
    j1, j2 = (muscle_tpu.MultiSequence.from_fasta(m.to_fasta_text())
              for m in (m1, m2))
    j_avg, j_path = j_pp.PProg(j_al, l2g).path_msas(j1, j2, sampled=sampled)
    t_al = t_pw.PairAligner(seqs, HMMParams.from_defaults().to_scores(),
                            ALPHA_AMINO, device="cpu")
    pp = t_pp.PProg(t_al, l2g)
    for n_dev in (t_pp.DEVICE_JOIN_N, 1):
        monkeypatch.setattr(t_pp, "DEVICE_JOIN_N", n_dev)
        avg, path = pp.path_msas(m1, m2, sampled=sampled)
        assert path == j_path
        assert abs(avg - j_avg) < 1e-5
