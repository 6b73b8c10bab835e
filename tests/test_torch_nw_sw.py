"""The NW Viterbi and SW score DP scans of muscle_tpu_torch against
muscle_tpu's, on the CPU.

* ops/nw.nw_viterbi_plain (the kernel nw_viterbi's twin) gives
  muscle_tpu.ops.nw.nw_viterbi_batch's trace bits, final rows and scores
  bit for bit, on seeded random amino pairs at pads 40 and 128 (lx ==
  BX, ly == BY, lx < ly and lx > ly among them);
* nw_align_batch gives JAX's (score, path) at batch sizes 1, 4 and 64,
  and its scores match a naive DP (tests/test_super6.py's) to 1e-3;
* ops/sw.sw_scores_plain and sw_dist_matrix give JAX's bit for bit;
* the wrappers of ops/dp_cuda.py run the twins on CPU tensors and count
  no launch; their geometry is the C sources'; without a GPU and without
  device="cpu" the entry points raise.

The kernels themselves are held to the twins on the card
(tests/test_torch_cuda_dp.py, chip_smoke.py).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muscle_tpu.alphabet import ALPHA_AMINO as J_AMINO
from muscle_tpu.ops import nw as j_nw
from muscle_tpu.ops import sw as j_sw
from muscle_tpu.pipeline.posteriors import encode_batch as j_encode
from muscle_tpu.sequence import Sequence as JSequence
from muscle_tpu_torch.alphabet import ALPHA_AMINO
from muscle_tpu_torch.ops import dp_cuda
from muscle_tpu_torch.ops import nw as t_nw
from muscle_tpu_torch.ops import sw as t_sw
from muscle_tpu_torch.pipeline.posteriors import encode_batch, round_up
from muscle_tpu_torch.sequence import MultiSequence, Sequence

LETTERS = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The twins run many small ops, which gain nothing from intra-op
    threads; one thread keeps them from crowding the other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(pad, seed):
    """8 ragged amino pairs (codes 0-20, wildcard-padded) at `pad`: pair 0
    lx = ly = pad, 1 ly = pad > lx, 2 lx = pad > ly, 3 lx < ly, 4 lx > ly,
    5 lx = ly, 6-7 random."""
    rng = np.random.default_rng(seed)
    lo = max(2, pad // 4)
    lx = rng.integers(lo, pad + 1, 8).astype(np.int32)
    ly = rng.integers(lo, pad + 1, 8).astype(np.int32)
    lx[0] = ly[0] = pad
    ly[1], lx[1] = pad, pad // 2
    lx[2], ly[2] = pad, pad // 3
    lx[3], ly[3] = pad // 3, pad - 1
    lx[4], ly[4] = pad - 2, pad // 2
    lx[5] = ly[5] = pad // 2
    xb = np.full((8, pad), 20, np.int32)
    yb = np.full((8, pad), 20, np.int32)
    for i in range(8):
        xb[i, :lx[i]] = rng.integers(0, 21, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, ly[i])
    return xb, yb, lx, ly


def _both(arrays, subst):
    return ([jnp.asarray(a) for a in arrays] + [jnp.asarray(subst)],
            [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(subst)])


def _seqs(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(LETTERS), int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


@pytest.mark.parametrize("pad", [40, 128])
def test_nw_twin_bit_identical_to_jax(pad):
    """bits, final rows and scores equal JAX's bit for bit."""
    xb, yb, lx, ly = _batch(pad, pad)
    jargs, targs = _both((xb, yb, lx, ly), j_sw.BLOSUM62_21)
    jb, jf, js = (np.asarray(a) for a in j_nw.nw_viterbi_batch(*jargs))
    tb, tf, ts = (a.numpy() for a in t_nw.nw_viterbi_plain(*targs))
    assert tb.dtype == np.uint8 and tb.shape == (8, pad, pad + 1)
    assert tf.shape == (8, 3, pad + 1) and ts.shape == (8,)
    assert np.array_equal(jb, tb)
    assert np.array_equal(jf.view(np.int32), tf.view(np.int32))
    assert np.array_equal(js.view(np.int32), ts.view(np.int32))


@pytest.mark.parametrize("batch", [1, 4, 64])
def test_nw_align_batch_matches_jax(batch):
    """(score, path) of every pair equals JAX's, whatever the batch."""
    texts = _seqs(9, 5, 60, 7 + batch)
    codes, lens = encode_batch([Sequence(f"s{k}", t) for k, t in
                                enumerate(texts)], ALPHA_AMINO,
                               pad_to=round_up(60, 8))
    jcodes, jlens = j_encode([JSequence(f"s{k}", t) for k, t in
                              enumerate(texts)], J_AMINO,
                             pad_to=round_up(60, 8))
    assert np.array_equal(codes, jcodes) and np.array_equal(lens, jlens)
    pairs = [(i, j) for i in range(9) for j in range(9) if i != j][:40]
    got = t_nw.nw_align_batch(codes, lens, pairs, batch_size=batch,
                              device="cpu")
    want = j_nw.nw_align_batch(jcodes, jlens, pairs, batch_size=batch)
    assert got == want


def _naive_nw(a, b, S, open_, ext):
    """tests/test_super6.py's reference DP."""
    la, lb = len(a), len(b)
    NEG = -1e30
    M = np.full((la + 1, lb + 1), NEG)
    D = np.full((la + 1, lb + 1), NEG)
    I = np.full((la + 1, lb + 1), NEG)
    M[0, 0] = 0
    for j in range(1, lb + 1):
        I[0, j] = max(M[0, j - 1] + open_, I[0, j - 1] + ext)
    for i in range(1, la + 1):
        D[i, 0] = max(M[i - 1, 0] + open_, D[i - 1, 0] + ext)
        for j in range(1, lb + 1):
            M[i, j] = max(M[i - 1, j - 1], D[i - 1, j - 1],
                          I[i - 1, j - 1]) + S[a[i - 1], b[j - 1]]
            D[i, j] = max(M[i - 1, j] + open_, D[i - 1, j] + ext)
            I[i, j] = max(M[i, j - 1] + open_, I[i, j - 1] + ext)
    return max(M[la, lb], D[la, lb], I[la, lb])


def test_nw_scores_match_naive_dp_and_paths_rescore():
    """Scores within 1e-3 of the naive DP; each path covers both
    sequences and rescores to its score."""
    texts = _seqs(6, 5, 40, 0)
    codes, lens = encode_batch([Sequence(f"s{k}", t) for k, t in
                                enumerate(texts)], ALPHA_AMINO,
                               pad_to=round_up(40, 8))
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    S = t_sw.BLOSUM62_21
    for (sc, path), (i, j) in zip(
            t_nw.nw_align_batch(codes, lens, pairs, batch_size=4,
                                device="cpu"), pairs):
        a, b = codes[i][:lens[i]], codes[j][:lens[j]]
        assert abs(sc - _naive_nw(a, b, S, t_nw.VITERBI_GAP_OPEN,
                                  t_nw.VITERBI_GAP_EXT)) < 1e-3
        assert sum(c in "MD" for c in path) == lens[i]
        assert sum(c in "MI" for c in path) == lens[j]
        ps, x, y, prev = 0.0, 0, 0, None
        for c in path:
            if c == "M":
                ps += S[a[x], b[y]]
                x += 1
                y += 1
            else:
                ps += (t_nw.VITERBI_GAP_OPEN if prev != c
                       else t_nw.VITERBI_GAP_EXT)
                x, y = (x + 1, y) if c == "D" else (x, y + 1)
            prev = c
        assert abs(ps - sc) < 1e-3
        assert t_nw.path_match_pairs(path) == j_nw.path_match_pairs(path)


@pytest.mark.parametrize("pad", [40, 128])
def test_sw_twin_bit_identical_to_jax(pad):
    xb, yb, lx, ly = _batch(pad, 100 + pad)
    jargs, targs = _both((xb, yb, lx, ly), j_sw.BLOSUM62_21)
    want = np.asarray(j_sw.sw_scores_batch(*jargs))
    got = t_sw.sw_scores_plain(*targs).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    assert (got > 0).all()


def test_tables_and_sw_dist_matrix_match_jax():
    """The BLOSUM62 tables and constants are JAX's; sw_dist_matrix on 7
    ragged sequences (pad round_up(max, 8), batches of 64 and of 4)
    equals JAX's bit for bit."""
    assert np.array_equal(t_sw.BLOSUM62_21, j_sw.BLOSUM62_21)
    assert (t_sw.DEFAULT_SW_OPEN, t_sw.DEFAULT_SW_EXT) == (
        j_sw.DEFAULT_SW_OPEN, j_sw.DEFAULT_SW_EXT)
    assert (t_nw.VITERBI_GAP_OPEN, t_nw.VITERBI_GAP_EXT, t_nw.NEG) == (
        j_nw.VITERBI_GAP_OPEN, j_nw.VITERBI_GAP_EXT, j_nw.NEG)
    texts = _seqs(7, 10, 70, 3)
    jseqs = [JSequence(f"s{k}", t) for k, t in enumerate(texts)]
    want = j_sw.sw_dist_matrix(jseqs, J_AMINO)
    tseqs = MultiSequence([Sequence(f"s{k}", t) for k, t in enumerate(texts)])
    for batch in (64, 4):
        got = t_sw.sw_dist_matrix(tseqs, ALPHA_AMINO, batch_size=batch,
                                  device="cpu")
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_cpu_tensors_run_the_twins_and_count_nothing():
    xb, yb, lx, ly = _batch(40, 5)
    args = [torch.from_numpy(a) for a in (xb, yb, lx, ly)] + [
        torch.from_numpy(t_sw.BLOSUM62_21)]
    before = dict(dp_cuda.LAUNCHES)
    got = dp_cuda.nw_viterbi(*args)
    want = t_nw.nw_viterbi_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(dp_cuda.sw_scores(*args), t_sw.sw_scores_plain(*args))
    assert torch.equal(t_sw.sw_scores_batch(*args),
                       t_sw.sw_scores_plain(*args))
    assert dp_cuda.LAUNCHES == before


def test_geometry_and_specs_match_the_sources(monkeypatch):
    """The width constants repeat csrc/dp_rows.cuh's; geometry is the C
    entries' (one warp of 2-4 columns a lane up to 128 lanes, a block of
    4-column warps up to 4096, a cluster of 8192-lane blocks beyond, at
    most 8: 65536 lanes, past which it raises); both libraries build for
    sm_90a without FMA contraction, keyed on the shared header."""
    from muscle_tpu_torch.utils import build
    with open(build.package_path("csrc", "dp_rows.cuh")) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts == {"kWarp": dp_cuda.WARP,
                      "kMaxAlpha": dp_cuda.MAX_ALPHA,
                      "kWarpLanes": dp_cuda.WARP_LANES,
                      "kBlockCols": dp_cuda.BLOCK_COLS,
                      "kBlockLanes": dp_cuda.BLOCK_LANES,
                      "kClusterCols": dp_cuda.CLUSTER_COLS,
                      "kClusterLanes": dp_cuda.CLUSTER_LANES,
                      "kMaxCluster": dp_cuda.MAX_CLUSTER}
    assert dp_cuda.geometry(128) == (4, 1, 1)
    assert dp_cuda.geometry(385) == (4, 4, 1)
    assert dp_cuda.geometry(1025) == (4, 9, 1)
    assert dp_cuda.geometry(2049) == (4, 17, 1)
    assert dp_cuda.geometry(4097) == (8, 32, 1)
    assert dp_cuda.geometry(20481) == (8, 32, 3)
    assert dp_cuda.geometry(dp_cuda.MAX_WIDTH) == (8, 32, 8)
    for bad in (0, dp_cuda.MAX_WIDTH + 1):
        with pytest.raises(ValueError, match="lanes"):
            dp_cuda.geometry(bad)
    for w in list(range(1, 9000, 37)) + list(range(8193, 70000, 4093)):
        if w > dp_cuda.MAX_WIDTH:
            continue
        c, t, q = dp_cuda.geometry(w)
        lanes = dp_cuda.WARP * c * t
        assert c in (2, 4, 8, 16) and 1 <= t <= 1024 // dp_cuda.WARP
        assert (q - 1) * lanes < w <= q * lanes and q <= dp_cuda.MAX_CLUSTER
        if w <= dp_cuda.WARP_LANES:   # the least C of one warp
            assert t == 1 and (c == 2 or c // 2 * dp_cuda.WARP < w)
        elif w <= dp_cuda.BLOCK_LANES:   # the least warps of BLOCK_COLS
            assert c == dp_cuda.BLOCK_COLS and q == 1
            assert (t - 1) * dp_cuda.WARP * c < w
        else:
            assert lanes == dp_cuda.CLUSTER_LANES
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    specs = dp_cuda.kernel_specs()
    assert [s.name for s in specs] == ["nw_viterbi", "sw_scores"]
    for spec in specs:
        assert "arch=compute_90a,code=sm_90a" in spec.flags
        assert "-fmad=false" in spec.flags
        assert spec.sources[0].endswith(f"csrc/{spec.name}.cu")
        assert any(d.endswith("dp_rows.cuh") for d in spec.deps)


def test_entry_points_raise_without_a_gpu(tmp_path):
    """No device given and no GPU: nw_align_batch, ProtDistCalc,
    sw_dist_matrix, Super6, Super7 and run_align_command's Super6 /
    Super7 branches raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from muscle_tpu_torch.pipeline.super6 import Super6
    from muscle_tpu_torch.pipeline.super7 import Super7
    from muscle_tpu_torch.pipeline.uclustpd import ProtDistCalc
    seqs = MultiSequence([Sequence("a", "ACDEFG"), Sequence("b", "ACDFG")])
    codes, lens = encode_batch(list(seqs), ALPHA_AMINO, pad_to=8)
    for make in (lambda: t_nw.nw_align_batch(codes, lens, [(0, 1)]),
                 lambda: ProtDistCalc(seqs),
                 lambda: t_sw.sw_dist_matrix(seqs, ALPHA_AMINO),
                 lambda: Super6(), lambda: Super7()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    from muscle_tpu_torch.pipeline.ensemble import run_align_command
    inp = tmp_path / "in.fa"
    seqs.write_fasta(str(inp))
    for cmd in ("super6", "super7"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_align_command(cmd, str(inp), str(tmp_path / "o.afa"), {})
