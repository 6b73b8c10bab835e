"""The contract of the NW Viterbi and SW score kernels (ops/dp_cuda.py)
on the CPU: what a reader uses, and the kernels' layout.

The kernels stop at each pair's (lx, ly): they write NW's bit rows < lx
and columns <= ly, its final columns <= ly and the scores, and leave the
rest unspecified. These tests state on the CPU why that is enough:

(a) cells past (lx, ly) filled with random bytes and floats change no
    path, score or match list of the host walk (ops/nw._traceback,
    path_match_pairs), which equal muscle_tpu's nw_align_batch;
(b) the plain versions cropped to a pair's ly + 1 (NW) / ly (SW)
    columns, or to the batch's largest lx rows, give the same real cells
    as at full width;
(c) nw_align_batch cut into launches by its bits budget gives the
    one-batch result and muscle_tpu's;
(d) dp_cuda.geometry is csrc/dp_rows.cuh's, at every kind of width;
(e) the kernels' gap-scan rounds on their layout (a lane's contiguous
    columns, shuffles, the edge buffer of the warps below: a model of
    csrc/dp_rows.cuh::maxplus_scan, and of team_scan, where each warp
    also runs the warp below's columns as a shadow) equal the plain
    Hillis-Steele scan bit for bit, ties and all.

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda_dp.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest
import torch

from muscle_tpu.ops import nw as j_nw
from muscle_tpu_torch.ops import dp_cuda
from muscle_tpu_torch.ops import nw as t_nw
from muscle_tpu_torch.ops import sw as t_sw


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ragged(pad, seed, b=10):
    """b ragged amino pairs at `pad` (codes 0-20, wildcard-padded): pair
    0 lx = ly = pad, 1 lx = 1, 2 ly = 1, 3 lx = ly = 1, 4 lx = pad with a
    short ly, 5 ly = pad with a short lx, the rest random."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(2, pad + 1, b).astype(np.int32)
    ly = rng.integers(2, pad + 1, b).astype(np.int32)
    lx[0] = ly[0] = pad
    lx[1] = 1
    ly[2] = 1
    lx[3] = ly[3] = 1
    lx[4], ly[4] = pad, pad // 3
    lx[5], ly[5] = pad // 4, pad
    xb = np.full((b, pad), 20, np.int32)
    yb = np.full((b, pad), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, ly[i])
    return xb, yb, lx, ly


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays] + [
        torch.from_numpy(t_sw.BLOSUM62_21)]


@pytest.mark.parametrize("pad", [40, 128])
def test_poisoned_cells_change_no_path(pad):
    """(a) bits past (lx, ly) and final columns past ly poisoned: the
    walk gives the same path and score as on the plain version's own
    cells, and muscle_tpu's nw_align_batch."""
    xb, yb, lx, ly = _ragged(pad, pad)
    bits, final, scores = (a.numpy() for a in
                           t_nw.nw_viterbi_plain(*_torch(xb, yb, lx, ly)))
    rng = np.random.default_rng(7 + pad)
    pbits, pfinal = bits.copy(), final.copy()
    for k in range(len(lx)):
        pbits[k, lx[k]:] = rng.integers(0, 256, pbits[k, lx[k]:].shape)
        pbits[k, :, ly[k] + 1:] = rng.integers(
            0, 256, pbits[k, :, ly[k] + 1:].shape)
        pfinal[k, :, ly[k] + 1:] = rng.normal(
            0, 1e3, pfinal[k, :, ly[k] + 1:].shape)
    codes = np.concatenate([xb, yb])
    lens = np.concatenate([lx, ly])
    pairs = [(k, len(lx) + k) for k in range(len(lx))]
    want = j_nw.nw_align_batch(codes, lens, pairs, batch_size=len(pairs))
    for k in range(len(lx)):
        clean = t_nw._traceback(bits[k], t_nw._last_row_bits_np(final[k]),
                                final[k], int(lx[k]), int(ly[k]))
        got = t_nw._traceback(pbits[k], t_nw._last_row_bits_np(pfinal[k]),
                              pfinal[k], int(lx[k]), int(ly[k]))
        assert got == clean == want[k][1]
        assert float(scores[k]) == want[k][0]
        assert (t_nw.path_match_pairs(got)
                == j_nw.path_match_pairs(want[k][1]))


@pytest.mark.parametrize("pad", [40, 128])
def test_cropped_inputs_give_the_same_real_cells(pad):
    """(b) each pair cropped to its lx rows and its ly + 1 (NW) / ly
    (SW) lanes, and the whole batch cropped to its largest lx rows, give
    the full-width plain versions' real cells bit for bit."""
    xb, yb, lx, ly = _ragged(pad, 100 + pad)
    lx[6] = pad // 2   # no pair at full lx: the batch crop cuts rows
    lx[0] = lx[4] = pad - 3
    bits, final, scores = t_nw.nw_viterbi_plain(*_torch(xb, yb, lx, ly))
    sw = t_sw.sw_scores_plain(*_torch(xb, yb, lx, ly))

    def same_nw(k, got, kk):
        gb, gf, gs = got
        a, b = int(lx[k]), int(ly[k])
        assert torch.equal(gb[kk, :a, :b + 1], bits[k, :a, :b + 1])
        assert torch.equal(gf[kk, :, :b + 1].view(torch.int32),
                           final[k, :, :b + 1].view(torch.int32))
        assert gs[kk].view(torch.int32) == scores[k].view(torch.int32)

    for k in range(len(lx)):
        a, b = int(lx[k]), int(ly[k])
        one = (xb[k:k + 1, :a].copy(), yb[k:k + 1, :b].copy(),
               lx[k:k + 1], ly[k:k + 1])
        same_nw(k, t_nw.nw_viterbi_plain(*_torch(*one)), 0)
        got = t_sw.sw_scores_plain(*_torch(*one))
        assert got.view(torch.int32) == sw[k:k + 1].view(torch.int32)
    rows = int(lx.max())
    assert rows < pad
    crop = (xb[:, :rows].copy(), yb, lx, ly)
    got = t_nw.nw_viterbi_plain(*_torch(*crop))
    for k in range(len(lx)):
        same_nw(k, got, k)
    assert torch.equal(t_sw.sw_scores_plain(*_torch(*crop)).view(torch.int32),
                       sw.view(torch.int32))


def test_bits_budget_cuts_batches_into_launches(monkeypatch):
    """(c) a bits budget of three pairs cuts 20 pairs into 7 launches;
    the (score, path) list is the one-batch list and muscle_tpu's."""
    rng = np.random.default_rng(3)
    pad = 64
    n = 8
    lens = rng.integers(5, pad + 1, n).astype(np.int32)
    codes = np.full((n, pad), 20, np.int32)
    for i in range(n):
        codes[i, :lens[i]] = rng.integers(0, 20, lens[i])
    pairs = [(i, j) for i in range(n) for j in range(n) if i != j][:20]
    one = t_nw.nw_align_batch(codes, lens, pairs, batch_size=64,
                              device="cpu")
    calls = []
    batch = t_nw.nw_viterbi_batch

    def counted(*args):
        calls.append(args[0].shape[0])
        return batch(*args)

    monkeypatch.setattr(t_nw, "nw_viterbi_batch", counted)
    monkeypatch.setattr(t_nw, "BITS_BUDGET", 3 * pad * (pad + 1) + 5)
    cut = t_nw.nw_align_batch(codes, lens, pairs, batch_size=64,
                              device="cpu")
    assert calls == [3] * 6 + [2]
    assert cut == one == j_nw.nw_align_batch(codes, lens, pairs,
                                             batch_size=64)


def _c_constants():
    from muscle_tpu_torch.utils.build import package_path
    with open(package_path("csrc", "dp_rows.cuh")) as f:
        src = f.read()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}


@pytest.mark.parametrize("width,want", [
    (1, (2, 1, 1)), (33, (2, 1, 1)), (385, (4, 4, 1)), (2049, (4, 17, 1)),
    (16385, (8, 32, 3)), (20481, (8, 32, 3)), (24577, (8, 32, 4)),
    (32769, (8, 32, 5))])
def test_geometry_is_the_sources(width, want):
    """(d) dp_cuda.geometry = the rule of csrc/dp_rows.cuh::geometry,
    computed here from the constants parsed out of the header; each
    block within its mode's launch bound (max_threads: a warp, then
    kBlockLanes / kBlockCols and kClusterLanes / kClusterCols threads)."""
    k = _c_constants()
    if width <= k["kWarpLanes"]:
        cols = 2
        while cols * k["kWarp"] < width:
            cols *= 2
        rule, bound = (cols, 1, 1), k["kWarp"]
    elif width <= k["kBlockLanes"]:
        span = k["kWarp"] * k["kBlockCols"]
        rule = (k["kBlockCols"], -(-width // span), 1)
        bound = k["kBlockLanes"] // k["kBlockCols"]
    else:
        rule = (k["kClusterCols"],
                k["kClusterLanes"] // (k["kWarp"] * k["kClusterCols"]),
                -(-width // k["kClusterLanes"]))
        bound = k["kClusterLanes"] // k["kClusterCols"]
    assert dp_cuda.geometry(width) == rule == want
    cols, warps, blocks = want
    assert warps * k["kWarp"] <= min(bound, 1024)
    assert blocks <= k["kMaxCluster"]


def _team_scan(z, cols, warps, decay):
    """csrc/dp_rows.cuh::maxplus_scan on a team of `warps` warps of 32
    lanes, lane l of warp w holding the columns (32 w + l) cols + c:
    every round reads the last round's values from the lane's registers,
    a shuffle up (a lane below the shift gets its own value, and max(u, u
    + k decay) = u) or the edge buffer, which holds only what the writing
    lanes put there (NaN elsewhere, so a wrong read shows); a column with
    no source in an in-lane round takes -inf."""
    width = z.shape[0]
    n = 32 * warps * cols
    flat = np.full(n, np.float32(7e7))   # lanes past the width: garbage
    flat[:width] = z
    v = flat.reshape(warps, 32, cols).copy()
    col = np.arange(n).reshape(warps, 32, cols)
    j0 = col[:, :, :1]
    lane = np.arange(32)[None, :, None]
    warp = np.arange(warps)[:, None, None]
    multi = warps > 1
    neg_inf = np.float32(-np.inf)

    def publish(mask):
        edge = np.full(n, np.nan, np.float32)
        if multi:
            edge[col[mask]] = v[mask]
        return edge

    def edge_at(edge, j):
        return edge[np.clip(j, 0, n - 1)]

    k = 1
    while k < cols and k < width:      # in the lane, the lowest from below
        kd = np.float32(k * decay)
        wmask = np.zeros_like(v, bool)
        wmask[:, 31, cols - k:] = True
        edge = publish(wmask)
        t = np.roll(v[:, :, cols - k:], 1, axis=1)   # lane l - 1's
        t = np.where((lane == 0) & (j0 > 0),
                     edge_at(edge, col[:, :, :k] - k), t)
        for c in range(cols - 1, k - 1, -1):
            v[:, :, c] = np.maximum(v[:, :, c], v[:, :, c - k] + kd)
        s = np.where(j0 > 0, t, neg_inf)
        v[:, :, :k] = np.maximum(v[:, :, :k], s + kd)
        k *= 2
    d = 1
    while d < 32 and d * cols < width:   # k / C lanes down
        k = d * cols
        kd = np.float32(k * decay)
        wmask = np.zeros_like(v, bool)
        wmask[:, 32 - d:, :] = True
        edge = publish(wmask)
        below = (lane < d) & (warp > 0)
        e = edge_at(edge, col - k)
        for c in range(cols):
            t = np.where(lane[:, :, 0] >= d, np.roll(v[:, :, c], d, axis=1),
                         v[:, :, c])
            s = np.where(below[:, :, 0], e[:, :, c], t)
            v[:, :, c] = np.maximum(v[:, :, c], s + kd)
        d *= 2
    k = 32 * cols
    while k < width:                      # other warps
        kd = np.float32(k * decay)
        edge = publish(np.ones_like(v, bool))
        ok = np.broadcast_to(j0 >= k, v.shape)
        v = np.where(ok, np.maximum(v, edge_at(edge, col - k) + kd), v)
        k *= 2
    return v.reshape(n)[:width]


def _block_scan(z, cols, warps, decay):
    """csrc/dp_rows.cuh::team_scan (a team of several warps): the rounds
    k < 32 cols on each lane's own columns and its shadow (the same
    lane's columns of the warp below, copied from the row; a shadow
    column's source below the warp below is -inf), own lanes below the
    shift reading the shadow by an indexed shuffle, then the rounds
    k >= 32 cols through the edge buffer."""
    width = z.shape[0]
    n = 32 * warps * cols
    flat = np.full(n, np.float32(7e7))
    flat[:width] = z
    v = flat.reshape(warps, 32, cols).copy()
    sv = np.concatenate([np.full((1, 32, cols), np.float32(-3e7)), v[:-1]])
    col = np.arange(n).reshape(warps, 32, cols)
    j0 = col[:, :, :1]
    lane = np.arange(32)[None, :, None]
    warp = np.arange(warps)[:, None, None]
    neg_inf = np.float32(-np.inf)
    k = 1
    while k < cols and k < width:
        kd = np.float32(k * decay)
        up = np.roll(v[:, :, cols - k:], 1, axis=1)
        top = np.broadcast_to(sv[:, 31:32, cols - k:], up.shape)
        sup = np.roll(sv[:, :, cols - k:], 1, axis=1)
        t = np.where(lane > 0, up, np.where(warp > 0, top, neg_inf))
        st = np.where(lane > 0, sup, neg_inf)
        for c in range(cols - 1, k - 1, -1):
            v[:, :, c] = np.maximum(v[:, :, c], v[:, :, c - k] + kd)
            sv[:, :, c] = np.maximum(sv[:, :, c], sv[:, :, c - k] + kd)
        v[:, :, :k] = np.maximum(v[:, :, :k], t + kd)
        sv[:, :, :k] = np.maximum(sv[:, :, :k], st + kd)
        k *= 2
    d = 1
    while d < 32 and d * cols < width:
        k = d * cols
        kd = np.float32(k * decay)
        below = (lane[:, :, 0] < d) & (warp[:, :, 0] > 0)
        src = (np.arange(32) - d) & 31
        for c in range(cols):
            a = np.where(lane[:, :, 0] >= d, np.roll(v[:, :, c], d, axis=1),
                         v[:, :, c])
            b = sv[:, src, c]
            sa = np.where(lane[:, :, 0] >= d,
                          np.roll(sv[:, :, c], d, axis=1), sv[:, :, c])
            v[:, :, c] = np.maximum(v[:, :, c], np.where(below, b, a) + kd)
            sv[:, :, c] = np.maximum(sv[:, :, c], sa + kd)
        d *= 2
    k = 32 * cols
    while k < width:
        kd = np.float32(k * decay)
        edge = v.reshape(n).copy()
        ok = np.broadcast_to(j0 >= k, v.shape)
        v = np.where(ok, np.maximum(v, edge[np.clip(col - k, 0, n - 1)] + kd),
                     v)
        k *= 2
    return v.reshape(n)[:width]


@pytest.mark.parametrize("cols,warps", [(4, 2), (4, 17), (4, 32), (8, 5)])
def test_block_rounds_with_the_shadow_equal_the_plain_scan(cols, warps):
    """(e) the block mode's rounds (own columns and the warp below's as a
    shadow, no barrier below 32 cols) = ops/sw._maxplus_scan bit for
    bit, at widths that stop inside each kind of round."""
    rng = np.random.default_rng(cols * 1000 + warps)
    cap = 32 * cols * warps
    for width in sorted({32 * cols + 1, 32 * cols + 2 * cols + 1,
                         48 * cols, cap - 37, cap}):
        if not 32 * cols < width <= cap:
            continue
        for decay in (-0.5, -1.0):
            ties = (rng.integers(-40, 4, width) * np.float32(0.5)
                    + np.where(rng.random(width) < 0.2, np.float32(-1e30),
                               np.float32(0))).astype(np.float32)
            big = (np.float32(3.3e7) + rng.integers(0, 64, width)
                   * np.float32(4.0)).astype(np.float32)
            for z in (ties, big):
                want = t_sw._maxplus_scan(torch.from_numpy(z[None]),
                                          decay)[0].numpy()
                got = _block_scan(z, cols, warps, decay)
                assert np.array_equal(got.view(np.int32),
                                      want.view(np.int32)), (width, decay)


@pytest.mark.parametrize("cols,warps", [(2, 1), (4, 1), (8, 1), (16, 1),
                                        (4, 17), (16, 3), (8, 12)])
def test_team_rounds_equal_the_plain_scan(cols, warps):
    """(e) the layout's rounds = ops/sw._maxplus_scan bit for bit, at the
    team's full width and at widths that stop inside the in-lane, the
    shuffle and the cross-warp rounds, on values with many ties and on
    values of ~2^25, where each add of k * decay rounds (so that a round
    read out of order shows)."""
    rng = np.random.default_rng(cols * 100 + warps)
    cap = 32 * cols * warps
    for width in sorted({1, 2, 3, cols + 1, 5 * cols - 1, 32 * cols,
                         cap - 37, cap}):
        if not 1 <= width <= cap:
            continue
        for decay in (-0.5, -1.0):
            ties = (rng.integers(-40, 4, width) * np.float32(0.5)
                    + np.where(rng.random(width) < 0.2, np.float32(-1e30),
                               np.float32(0))).astype(np.float32)
            big = (np.float32(3.3e7) + rng.integers(0, 64, width)
                   * np.float32(4.0)).astype(np.float32)
            for z in (ties, big):
                want = t_sw._maxplus_scan(torch.from_numpy(z[None]),
                                          decay)[0].numpy()
                got = _team_scan(z, cols, warps, decay)
                assert np.array_equal(got.view(np.int32),
                                      want.view(np.int32)), (width, decay)
