"""Kernels A and B's two schedules (ops/pairhmm_cuda.py::ab_geometry).

One thread block a pair up to 2048 lanes, or, for wider rows, each
pair's row as a skewed wavefront of groups of G 64-lane segments
(csrc/pairhmm_wave.cuh, the body kernels 5/6 share). These tests hold what runs here: the schedule and G the
wrappers pick at every width chip_smoke.py holds, at the bucket ladder's
rungs and at B = 1, 8 and 512; the limits of a forced schedule; the
hand-over's buffers at the router's largest launch; the row-0 and
boundary-row rounds the wave runs in the launch (`row_cumsum2`), which
must equal the block kernels' full-width prefix sums, `_cumsum_lanes`,
bit for bit; the wave's arithmetic (the body's whole-pass twins,
ops/pairhmm_striped.py, on one stripe of the whole row with A/B's row
0) against the block kernels' plain versions bit for bit and against
the JAX package's Pallas kernels in interpret mode at their gate; and
the wrappers' CPU route. The CUDA kernels on both schedules against the
plain versions: tests/test_torch_cuda.py (`test_ab_schedules_match_plain`),
on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.ops import pairhmm as j_pairhmm
from muscle_tpu.ops import pairhmm_pallas as j_pallas
from muscle_tpu_torch.hmm.params import HMMParams, score_pack_from_numpy
from muscle_tpu_torch.ops import pairhmm_cuda as pc
from muscle_tpu_torch.ops import pairhmm_striped as ps
from muscle_tpu_torch.ops import wavefront
from muscle_tpu_torch.pipeline.posteriors import BUCKET_LADDER, _long_rung

# chip_smoke.py's AB_CHECK_WIDTHS: S = 2..5 and the router's rungs
AB_CHECK_WIDTHS = (2176, 4352, 6272, 8192, 8704, 9728, 10240)
# G at each of them: the largest divisor of the segments up to 4
WANT_G = {2176: 2, 4352: 4, 6272: 2, 8192: 4, 8704: 4, 9728: 4, 10240: 4}


@pytest.mark.parametrize("b", [1, 8, 512])
@pytest.mark.parametrize("width", AB_CHECK_WIDTHS)
def test_schedule_at_check_widths(width, b):
    """Every width chip_smoke.py holds (S >= 2) takes the wave, whatever
    B, at the measured G."""
    geo = pc.ab_geometry(b, width)
    assert geo.schedule == "wave"
    assert geo.g == WANT_G[width]
    assert geo.groups * 64 * geo.g == width


@pytest.mark.parametrize("b", [1, 8, 512])
def test_schedule_at_bucket_rungs(b):
    """The bucket ladder's rungs within the kernels' lane cap: S = 1
    (<= 2048 lanes, phase 2's 512 among them) on one block a pair;
    wider rows on the wave, whatever B."""
    for rung in [r for r in BUCKET_LADDER if r <= pc.MAX_LY]:
        geo = pc.ab_geometry(b, rung)
        if rung <= pc.WAVE_MIN_LY:
            assert geo == pc.ABGeometry("block"), rung
        else:
            assert geo.schedule == "wave", rung
            assert (rung // 64) % geo.g == 0
            assert geo.g == max(d for d in range(1, pc.AB_GROUP_SEGMENTS + 1)
                                if (rung // 64) % d == 0)


def test_long_router_rungs_take_the_wave():
    """The long-pair router launches at most 8 pairs at the rungs
    _long_rung gives 8193-9856 residues: all on the wave at G = 4."""
    for length in (8193, 8704, 9000, 9728, 9729, 9856):
        width = _long_rung(length)
        assert width in (8704, 9216, 9728, 10240)
        for b in range(1, 9):
            assert pc.ab_geometry(b, width) == pc.ABGeometry(
                "wave", 4, width // 256)


def test_forced_schedule_limits():
    assert pc.ab_geometry(512, 512, "wave") == pc.ABGeometry("wave", 4, 2)
    assert pc.ab_geometry(1, 10240, "block") == pc.ABGeometry("block")
    for g in (1, 2, 4, 5, 8, 10, 16, 20, 32):
        assert pc.ab_geometry(1, 10240, "wave", g).g == g
    for g in (0, 3, 33, 40, 160):
        with pytest.raises(ValueError):
            pc.ab_geometry(1, 10240, "wave", g)
    with pytest.raises(ValueError):
        pc.ab_geometry(1, 10240, "block", 4)
    with pytest.raises(ValueError):
        pc.ab_geometry(1, 10240, "stripes")


def test_hand_over_at_the_routers_largest_launch():
    """8 pairs at 11264 x 10240 (the in-cap rung's rectangle): one record
    a DP row a group, 16 B (forward) or 32 B (backward), against the
    group's 256 G B of M row: the backward's records are 1 / (8 G) of
    the (B, Lx, Ly) lattice, 115 MB at G = 4; row 0 takes 4 B Ly
    floats."""
    b, lx, ly = 8, 11264, 10240
    geo = pc.ab_geometry(b, ly)
    fwd = wavefront.hand_bytes(b, geo.groups, lx, "fwd")
    bwd = wavefront.hand_bytes(b, geo.groups, lx, "bwd")
    lattice = b * lx * ly * 4
    assert (geo.g, geo.groups) == (4, 40)
    assert fwd == b * 40 * lx * 16 and bwd == 2 * fwd
    assert bwd * 8 * geo.g == lattice
    assert bwd < 0.12e9
    sync, hand = wavefront.buffers(2, 3, 5, "bwd", "cpu")
    assert sync.shape == (1 + 2 * 3,) and sync.dtype == torch.int32
    assert hand.numel() * 4 == wavefront.hand_bytes(2, 3, 5, "bwd")
    assert not sync.any() and not hand.any()


def _row_cumsum2(init):
    """csrc/pairhmm_wave.cuh row_cumsum2 on (B, n) rows: block_cumsum's
    rounds (round k adds lane j - k, or 0.0) ping-ponging between two
    buffers, started in the one that leaves the sums in the first."""
    n = init.shape[1]
    rounds = 0
    while (1 << rounds) < n:
        rounds += 1
    bufs = [None, None]
    cur = rounds % 2
    bufs[cur] = init.clone()
    k = 1
    while k < n:
        src = bufs[cur]
        dst = torch.empty_like(src)
        dst[:, :k] = src[:, :k] + 0.0
        dst[:, k:] = src[:, k:] + src[:, :-k]
        cur = 1 - cur
        bufs[cur] = dst
        k *= 2
    assert cur == 0
    return bufs[0]


@pytest.mark.parametrize("width", [128, 512, 2176, 6272, 10240])
def test_row0_rounds_equal_cumsum_lanes(width):
    """The wave's row 0 (forward) and boundary row B(lx, .) (backward,
    flipped lanes, padding on the left), computed as group 0 of each
    pair computes them in the launch, equal the block kernels' rows
    (fwd_rows, bwd_post_rows: `_cumsum_lanes`) bit for bit."""
    pack = HMMParams.from_defaults().to_scores()
    _, insert, params = pc.tables(pack, "cpu")
    (_, tSI, tSJ, _, _, _, tII, _, tJJ, _) = pc._unpack(params)
    rng = np.random.default_rng(width)
    ly = torch.tensor([width, max(width - 131, 2), min(100, width), 1])
    yb = torch.full((4, width), 20, dtype=torch.long)
    for i, n in enumerate(ly.tolist()):
        yb[i, :n] = torch.from_numpy(rng.integers(0, 20, n))
    insy = insert[yb]
    # forward: IY/JY row 0 = tS - tXX + prefix(insy + tXX)
    for ts, tt in ((tSI, tII), (tSJ, tJJ)):
        got = (ts - tt) + _row_cumsum2(insy + tt)
        want = ts - tt + pc._cumsum_lanes(insy + tt)
        assert torch.equal(got, want)
    # backward: flipped lanes q < Ly - ly are padding
    insf = insert[yb.flip(1)]
    pad = torch.arange(width)[None, :] < (width - ly)[:, None]
    for ts, tt in ((tSI, tII), (tSJ, tJJ)):
        init = torch.where(pad, 0.0, insf + tt)
        got = torch.where(pad, ts, ts + _row_cumsum2(init))
        want = torch.where(pad, ts, ts + pc._cumsum_lanes(init))
        assert torch.equal(got, want)


@pytest.mark.parametrize("schedule", [None, "block", "wave"])
def test_cpu_tensors_run_the_plain_versions(schedule):
    """On CPU tensors both wrappers run the plain versions whatever the
    schedule, count nothing, and letter_path needs no hand-over check;
    a forced G that does not divide the row raises before that."""
    rng = np.random.default_rng(3)
    lx = np.array([40, 25], np.int32)
    ly = np.array([2176, 1000], np.int32)
    xb = np.full((2, 48), 20, np.int32)
    yb = np.full((2, 2176), 20, np.int32)
    for i in range(2):
        xb[i, :lx[i]] = rng.integers(0, 20, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 20, ly[i])
    x, y, lxt, lyt = (torch.from_numpy(a) for a in (xb, yb, lx, ly))
    tabs = pc.tables(HMMParams.from_defaults().to_scores(), "cpu")
    launches, scheds = dict(pc.LAUNCHES), pc.SCHEDULES.copy()
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, *tabs, schedule=schedule)
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, *tabs)
    assert torch.equal(fm, fm2) and torch.equal(fend, fend2)
    tot = pc._total_prob(fend, tabs[2])
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, *tabs, tot, fm,
                                    schedule=schedule)
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, *tabs, tot, fm)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)
    post3, ea = pc.letter_path(x, y, lxt, lyt, *tabs)
    assert torch.equal(post3, post)
    assert pc.LAUNCHES == launches and pc.SCHEDULES == scheds
    with pytest.raises(ValueError):     # 3 does not divide 34 segments
        pc.pairhmm_fwd(x, y, lxt, lyt, *tabs, schedule="wave", g=3)
    wavefront.check_waits("cpu")        # no launch, no flag


def _ragged(width, seed):
    """6 pairs, Lx 200: a full-width pair, padding inside a segment, on a
    segment edge, one lane past it, a short pair and a one-letter one."""
    rng = np.random.default_rng(seed)
    lx = np.array([200, 150, 37, 199, 64, 120], np.int32)
    ly = np.array([width, width - 5, width - 64, width - 63, 64 * 3 + 17,
                   1], np.int32)
    xb = np.full((6, 200), 20, np.int32)
    yb = np.full((6, width), 20, np.int32)
    for i in range(6):
        xb[i, :lx[i]] = rng.integers(0, 21, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, ly[i])
    return xb, yb, lx, ly


def _wave_twins(x, y, lxt, lyt, match, insert, params, fm):
    """The wave body's arithmetic on CPU tensors: kernels 5/6's
    whole-pass twins on one stripe of the whole row, row 0 and the
    boundary row from kernels A/B's own rounds (`_cumsum_lanes`), as the
    wave computes them in the launch. Returns (fm, fend, post, mea); the
    backward runs on the given forward lattice fm."""
    (_, tSI, tSJ, _, _, _, tII, _, tJJ, _) = pc._unpack(params)
    width = y.shape[1]
    insy = insert[y.long()]
    iy0 = tSI - tII + pc._cumsum_lanes(insy + tII)
    jy0 = tSJ - tJJ + pc._cumsum_lanes(insy + tJJ)
    insf = insert[y.long().flip(1)]
    pad = torch.arange(width)[None, :] < (width - lyt.long())[:, None]
    iy0b = torch.where(pad, tSI, tSI + pc._cumsum_lanes(
        torch.where(pad, 0.0, insf + tII)))
    jy0b = torch.where(pad, tSJ, tSJ + pc._cumsum_lanes(
        torch.where(pad, 0.0, insf + tJJ)))
    args = (x, y, lxt, lyt, match, insert, params)
    fm_w, fend_w = ps.fwd_striped_plain(*args, iy0, jy0, width)
    tot = pc._total_prob(fend_w, params).contiguous()
    post_w, mea_w = ps.bwd_striped_plain(*args, tot, iy0b, jy0b, fm.clone(),
                                         width)
    return fm_w, fend_w, post_w, mea_w


def _real(t, lx, ly):
    r = torch.arange(t.shape[1])[None, :, None]
    c = torch.arange(t.shape[2])[None, None, :]
    return t.where((r < lx[:, None, None]) & (c < ly[:, None, None]), 0.0)


@pytest.mark.parametrize("width", [256, 384, 640])
def test_wave_arithmetic_equals_the_block_plain_versions(width):
    """What the wide schedule computes (each group one run of the shared
    body, the carry chain continued from its left neighbour in segment
    order: one stripe of the whole row) equals fwd_plain and
    bwd_post_plain on the real cells bit for bit, so kernels A and B
    give the same numbers on either schedule."""
    x, y, lxt, lyt = (torch.from_numpy(a) for a in _ragged(width, width))
    tabs = pc.tables(HMMParams.from_defaults().to_scores(), "cpu")
    fm, fend = pc.fwd_plain(x, y, lxt, lyt, *tabs)
    tot = pc._total_prob(fend, tabs[2])
    post, mea = pc.bwd_post_plain(x, y, lxt, lyt, *tabs, tot, fm)
    fm_w, fend_w, post_w, mea_w = _wave_twins(x, y, lxt, lyt, *tabs, fm)
    assert torch.equal(_real(fm_w, lxt, lyt), _real(fm, lxt, lyt))
    assert torch.equal(fend_w, fend)
    assert torch.equal(post_w, post) and torch.equal(mea_w, mea)


def test_wave_arithmetic_matches_pallas_interpret():
    """The same against the JAX package's fused Pallas kernels
    (`_fwd_pallas_fused`, `_bwd_post_pallas` through
    batch_posteriors_pallas) in interpret mode, at their gate
    (tests/test_pallas_fused.py:62-69: posterior within 2e-3 ignoring
    cells that flip at the 0.01 threshold, EA within 2e-3)."""
    xb, yb, lx, ly = _ragged(256, 7)
    xb = np.concatenate([xb, np.full((6, 56), 20, np.int32)], axis=1)
    jp = JHMMParams.from_defaults(nucleo=False).to_scores()
    post_p, ea_p = j_pallas.batch_posteriors_pallas(
        *(jnp.asarray(a) for a in (xb, yb, lx, ly)),
        *j_pairhmm.score_args(jp), fused=True, interpret=True)
    pack = score_pack_from_numpy(
        jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM],
        jp.match, jp.insert)
    x, y, lxt, lyt = (torch.from_numpy(a) for a in (xb, yb, lx, ly))
    tabs = pc.tables(pack, "cpu")
    fm, _ = pc.fwd_plain(x, y, lxt, lyt, *tabs)
    _, _, post_w, mea_w = _wave_twins(x, y, lxt, lyt, *tabs, fm)
    post_p = np.asarray(post_p)
    post = post_w.numpy()
    d = np.abs(post_p - post)
    flip = ((post_p == 0) | (post == 0)) & (np.maximum(post_p, post)
                                             <= 0.0102)
    assert float(np.max(np.where(flip, 0.0, d))) < 2e-3
    ea = (mea_w / torch.minimum(lxt, lyt).float()).numpy()
    assert float(np.max(np.abs(np.asarray(ea_p) - ea))) < 2e-3
