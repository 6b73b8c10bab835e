"""The MEA direction kernel's schedule (csrc/mea_dirs.cu) on the CPU.

The kernel runs the MEA direction DP as a skewed wavefront over the
rows: one row a lane, bands of 32 rows a warp, the band above's last row
handed over in chunks (a shared-memory ring inside a round of bands, a
row in device memory from a round's last warp to warp 0 of the next).
Max is exact and each cell has one add, so every order gives the same
bits; what can go wrong is the schedule: a lane reading a value before
it is written or after it is overwritten, a tie decided on the wrong
operands, a word packed from the wrong columns. Here:

* `mea_dirs_wave_plain`, the kernel's schedule step by step (its
  lanes, stage slots, ring and link positions checked at every read,
  deadlock detected), equals `mea_dirs_plain` bit for bit, packed and
  scores, on random, tie-heavy (mostly zeros, values from {0.25, 0.5})
  and real posteriors (summed from the port's DeviceJoiner halves), at
  odd shapes, cc1 = 1, and cc1 > 512 (the bands wrap: the link row);
* `mea_dirs_plain` equals the JAX package's `build_and_mea` on a real
  join (muscle_tpu.pipeline.devjoin._build_jit), on the real region;
* the constants the twin repeats are the kernel source's, and the
  launch's shared memory fits a block.
The kernel against the plain version on the card: tests/test_torch_cuda.py
(`test_mea_dirs_wave_matches_plain`) and chip_smoke.py.
"""

import os
import re

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
from muscle_tpu_torch.ops import devjoin_cuda as djc
from muscle_tpu_torch.pipeline import devjoin as t_dj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 33), (23, 16), (40, 57), (130, 150), (767, 769), (1100, 300)]


def _post(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return torch.from_numpy(rng.random(shape, dtype=np.float32))
    vals = np.float32([0, 0, 0, 0, 0, 0, 0.25, 0.5])
    return torch.from_numpy(rng.choice(vals, size=shape))


@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_kernel_schedule_equals_plain(shape, kind):
    post = _post(kind, shape, shape[0] * 1000 + shape[1])
    packed, scores = djc.mea_dirs_wave_plain(post)
    want_p, want_s = djc.mea_dirs_plain(post)
    assert packed.dtype == torch.int32 and packed.shape == want_p.shape
    assert torch.equal(packed, want_p)
    assert torch.equal(scores, want_s)


def _family_text(n=10, lo=60, hi=110, seed=5):
    """Mutated copies of one random protein (tests/test_devjoin.py)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=hi)
    aas = "ARNDCQEGHILKMFPSTWYV"
    lines = []
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        mut = base[:ln].copy()
        nmut = int(rng.integers(0, ln // 3))
        mut[rng.integers(0, ln, size=nmut)] = rng.integers(0, 20, size=nmut)
        lines.append(f">s{i}\n{''.join(aas[c] for c in mut)}\n")
    return "".join(lines)


@pytest.fixture(scope="module")
def join():
    """One refine join of a real family: the JAX package's pair store
    (values also rounded to multiples of 2^-8, whose sums are exact in
    f32 in any order, so both packages sum the same column posterior),
    the labels' indices, and the MSA cut in two halves as a refine
    iteration cuts it (tests/test_torch_devjoin.py)."""
    text = _family_text()
    jseqs = muscle_tpu.MultiSequence.from_fasta(text)
    n = len(jseqs)
    pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
    codes, lens = j_post.encode_batch(jseqs, ALPHA_AMINO, pad_to=128)
    sv, sc, _, max_nnz = j_post.all_pairs_posteriors_sparse(
        codes, lens, JHMMParams.from_defaults().to_scores(), pairs,
        batch_size=len(pairs))
    sv = np.array(sv)
    l2i = {s.label: i for i, s in enumerate(jseqs)}
    msa = align(MultiSequence.from_fasta(text), refine_iters=2, device="cpu")
    rows = [s for lb in (f"s{i}" for i in range(n))
            for s in msa if s.label == lb]
    m1 = MultiSequence(rows[0::2]).project(range((n + 1) // 2))
    m2 = MultiSequence(rows[1::2]).project(range(n // 2))
    return dict(sv=sv, sv_q=(np.round(sv * 256) / 256).astype(np.float32),
                sc=np.array(sc), pairs=pairs, lens=lens, n=n,
                nnz=min(int(max_nnz), 32), l2i=l2i, m1=m1, m2=m2)


def _port_post(join, sv):
    """The column posterior DeviceJoiner.align sums (its two halves)."""
    joiner = t_dj.DeviceJoiner(torch.from_numpy(sv),
                               torch.from_numpy(join["sc"]), join["pairs"],
                               join["n"], join["nnz"], join["l2i"])
    m1, m2 = join["m1"], join["m2"]
    idx1, bank1 = joiner._maps(m1)
    idx2, bank2 = joiner._maps(m2)
    out = joiner._half(joiner.pair_mx[np.ix_(idx1, idx2)], bank1, bank2,
                       m1.col_count(), m2.col_count())
    out2 = joiner._half(joiner.pair_mx[np.ix_(idx2, idx1)], bank2, bank1,
                        m2.col_count(), m1.col_count())
    return (out + out2.T).contiguous()


def test_kernel_schedule_equals_plain_on_a_real_join(join):
    post = _port_post(join, join["sv"])
    assert post.shape == (join["m1"].col_count(), join["m2"].col_count())
    assert float(post.max()) > 0
    packed, scores = djc.mea_dirs_wave_plain(post)
    want_p, want_s = djc.mea_dirs_plain(post)
    assert torch.equal(packed, want_p) and torch.equal(scores, want_s)


def _dirs(packed, cc1, cc2):
    """(cc1, cc2) 2-bit codes of packed words."""
    p = np.asarray(packed).astype(np.int64) & 0xFFFFFFFF
    shifts = 2 * np.arange(16)
    return ((p[:cc1, :, None] >> shifts) & 3).reshape(cc1, -1)[:, :cc2]


def test_plain_equals_jax_build_and_mea(join):
    """mea_dirs_plain on the port's column posterior equals the JAX
    package's build_and_mea (its _mea_dirs scan over the padded
    posterior it sums itself) on the real rows and columns: directions
    and row-end scores bit for bit."""
    m1, m2 = join["m1"], join["m2"]
    cc1, cc2 = m1.col_count(), m2.col_count()
    j_joiner = j_dj.DeviceJoiner(jnp.asarray(join["sv_q"]),
                                 jnp.asarray(join["sc"]), join["pairs"],
                                 join["lens"], join["n"], join["nnz"],
                                 join["l2i"])
    outs = []
    fn = j_joiner._fn

    def keep(*args, **kwargs):
        outs.append(fn(*args, **kwargs))
        return outs[-1]
    j_joiner._fn = keep
    j_m1, j_m2 = (muscle_tpu.MultiSequence.from_fasta(m.to_fasta_text())
                  for m in (m1, m2))
    j_joiner.align(j_m1, j_m2)
    j_packed, j_scores = (np.asarray(a) for a in outs[0])
    post = _port_post(join, join["sv_q"])
    assert torch.equal(post, torch.round(post * 256) / 256)  # exact sums
    packed, scores = djc.mea_dirs_plain(post)
    assert np.array_equal(_dirs(packed, cc1, cc2), _dirs(j_packed, cc1, cc2))
    assert np.array_equal(scores.numpy(), j_scores[:cc1])
    # and the packing itself: bits past cc2 are zero in the port
    assert np.array_equal(_dirs(packed, cc1, 16 * packed.shape[1])[:, cc2:],
                          np.zeros((cc1, 16 * packed.shape[1] - cc2)))


def test_constants_are_the_kernels():
    """The twin's constants are csrc/mea_dirs.cu's and those of the
    header it shares with kernel 4, csrc/mea_wave.cuh."""
    src = ""
    for name in ("mea_wave.cuh", "mea_dirs.cu"):
        with open(os.path.join(ROOT, "muscle_tpu_torch", "csrc", name)) as f:
            src += f.read()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                            src)}
    assert got["CW"] == djc.MEA_CHUNK and got["NCH"] == djc.MEA_SLOTS
    assert got["AHEAD"] == djc.MEA_AHEAD and got["HC"] == djc.MEA_HAND
    assert got["RING"] == djc.MEA_RING
    assert got["LINK_HC"] == djc.MEA_LINK_HAND
    assert got["MAX_WARPS"] == djc.MEA_MAX_WARPS
    # shared memory a warp: 33 stage rows of CHUNK * (SLOTS + 1) floats
    # (slot 0 twice), the ring's 64-bit slots, a count; 16 warps fit the
    # 227 KB a block can take
    per_warp = (4 * got["STAGE_ROWS"] * got["CW"] * (got["NCH"] + 1)
                + 8 * got["RING"] + 4)
    assert per_warp * djc.MEA_MAX_WARPS <= 232448


@pytest.mark.parametrize("cc1,warps", [(1, 1), (32, 1), (33, 2), (512, 16),
                                       (513, 16), (1100, 16)])
def test_warps(cc1, warps):
    """One warp a band of 32 rows, at most 16: two or more bands always
    take two or more warps (a warp never hands a band to itself)."""
    assert djc.mea_warps(cc1) == warps


def test_cpu_tensor_runs_plain_and_counts_nothing():
    post = _post("tie-heavy", (70, 45), 3)
    before = dict(djc.LAUNCHES)
    packed, scores = djc.mea_dirs(post)
    want_p, want_s = djc.mea_dirs_plain(post)
    assert torch.equal(packed, want_p) and torch.equal(scores, want_s)
    assert djc.LAUNCHES == before
