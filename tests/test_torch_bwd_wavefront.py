"""Kernel 3 on the wave (ops/pairhmm_emis_cuda.py::pairhmm_bwd).

Kernel 3, the legacy backward of the Muscle-3D emissions path, runs on
kernels A and B's wide schedule (`pairhmm_emis_cuda.bwd_geometry`):
each pair's row as a skewed wavefront of groups of G 64-lane segments
across SMs (csrc/pairhmm_wave.cuh's backward body in kernel 3's
layout). These tests hold what runs here: the G picked at 512, 2048,
2176 and 12288 (the legacy route's rung); the hand-over's bytes at
mega-long's launch; the boundary row the wave computes in the launch
(`row_cumsum2`'s rounds), which must equal the block body's
`block_cumsum` lanes bit for bit; the wave's arithmetic
(`bwd_wave_plain`: group after group, each taking its left neighbour's
records) against the block body's plain version bit for bit, and
against the JAX package's `_bwd_kernel` in interpret mode at the kernel
gate; the wrapper's CPU route. The CUDA kernel:
tests/test_torch_cuda.py (`test_bwd_wave_matches_plain`), on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muscle_tpu.ops import pairhmm_pallas as j_pallas
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm_cuda as pc
from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
from muscle_tpu_torch.ops import wavefront
from test_torch_ab_wavefront import _row_cumsum2
from test_torch_mega_kernels import (_args, _assert_gate,  # noqa: F401
                                     _bwd_pallas_interpret, _jax_params,
                                     case)


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("width,want", [
    (512, pc.ABGeometry("wave", 4, 2)), (2048, pc.ABGeometry("wave", 4, 8)),
    (2176, pc.ABGeometry("wave", 2, 17)),
    (12288, pc.ABGeometry("wave", 4, 48))])
def test_schedule_at_the_rungs(width, want, b):
    """Every width on the wave, in groups of the largest divisor of the
    segments up to 4: mega-long's 12288 in 48 groups of 4 segments a
    pair."""
    assert pe.bwd_geometry(b, width) == want


def test_hand_over_at_mega_longs_launch():
    """8 pairs at 12288 x 12288: one 32-byte record a step for each of
    the 8 x 48 groups, 151 MB, 1 / (8 G) of RB_M's 4.8 GB; the boundary
    row's buffers 4 B Ly floats."""
    b, lx, ly = 8, 12288, 12288
    geo = pe.bwd_geometry(b, ly)
    hand = wavefront.hand_bytes(b, geo.groups, lx, "bwd")
    rbm = b * lx * ly * 4
    assert hand == 8 * 48 * 12288 * 32 == 150_994_944
    assert hand * 8 * geo.g == rbm
    _, bufs = pc._wave_args(geo, 2, 3, 256, "bwd", "cpu")
    assert bufs[3].numel() == 4 * 2 * 256


@pytest.mark.parametrize("width", [128, 2176, 12288])
def test_boundary_rounds_equal_block_cumsum(width):
    """Kernel 3's boundary row as group 0 of each pair computes it in the
    launch (row_cumsum2's rounds from lane 0 over the reversed insert
    scores, LOG_ZERO past ly) equals the block kernel's block_cumsum
    lanes (`_cumsum_lanes`, bwd_rows' row) bit for bit."""
    rng = np.random.default_rng(width)
    lyb = torch.tensor([width, width - 131 if width > 131 else 100, 1, 70])
    ins_y = torch.from_numpy(-1 - rng.random((4, width), dtype=np.float32))
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), "cpu")
    (_, tSI, tSJ, _, _, _, tII, _, tJJ, _) = pc._unpack(params)
    insy = pc.reversed_lanes(ins_y, lyb)
    for ts, tt in ((tSI, tII), (tSJ, tJJ)):
        got = ts + _row_cumsum2(insy + tt)
        want = ts + pc._cumsum_lanes(insy + tt)
        assert torch.equal(got, want)


def _lattice(width, seed):
    """6 pairs, Lx 90: a full-width pair, padding inside a segment, on a
    segment edge, one lane past it, a short pair and a one-column one."""
    rng = np.random.default_rng(seed)
    lx = torch.tensor([90, 60, 37, 89, 17, 1], dtype=torch.int32)
    ly = torch.tensor([width, width - 5, width - 64, width - 63, 64 * 3 + 17,
                       1], dtype=torch.int32)
    e = torch.from_numpy(rng.random((6, 90, width), dtype=np.float32) * 4 - 3)
    ins_x = torch.from_numpy(-1 - rng.random((6, 90), dtype=np.float32))
    ins_y = torch.from_numpy(-1 - rng.random((6, width), dtype=np.float32))
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), "cpu")
    return e, ins_x, ins_y, lx, ly, params


@pytest.mark.parametrize("width", [256, 384, 640])
def test_wave_arithmetic_equals_the_block_plain_version(width):
    """What the wide schedule computes (each group one run of the body,
    the carry chain continued from its left neighbour in segment order,
    the boundary row from the full-width rounds) equals bwd_plain on
    every cell bit for bit, at the geometry's G and at G = 1 and 2."""
    args = _lattice(width, width)
    want = pe.bwd_plain(*args)
    for g in sorted({1, 2, pe.bwd_geometry(6, width).g}):
        assert torch.equal(pe.bwd_wave_plain(*args, g), want), g


def test_wave_arithmetic_matches_pallas_interpret(case):
    """The wave's RB_M against the JAX package's `_bwd_kernel` in
    interpret mode (fed its roll-flipped e_rev) on 8 mega pairs at 128
    (two groups of one segment): every cell that _finish_posteriors
    reads within 1e-6 relative (tests/test_torch_mega_kernels.py), and
    the posteriors and EA they give through finish_posteriors and the
    MEA row scan at the kernel gate (tests/test_pallas_fused.py:62-69)."""
    arr, lx, ly, jp, _ = case
    _, _, params = _jax_params(jp, 8)
    rb_p = np.asarray(_bwd_pallas_interpret(
        jnp.asarray(arr["e_rev"].transpose(1, 0, 2)),
        jnp.asarray(arr["ins_xr"].T[:, :, None]), jnp.asarray(arr["ins_yr"]),
        params, 8, j_pallas.SCAN_IMPL)).transpose(1, 0, 2)
    args = _args(case)
    rb = pe.bwd_wave_plain(*args, 1)
    for k in range(8):
        want, got = rb_p[k, :lx[k], :ly[k]], rb[k, :lx[k], :ly[k]].numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        assert not rb[k, lx[k]:].any()
    fm, fend = pe.fwd_emis_plain(*args)
    lxt, lyt = args[3], args[4]
    posts = [pe.finish_posteriors(fm.clone(), r, fend, lxt, lyt, args[5])
             for r in (rb, torch.from_numpy(np.ascontiguousarray(rb_p)))]
    eas = [pe.mea_scores_plain(p) / torch.minimum(lxt, lyt).float()
           for p in posts]
    _assert_gate(posts[1].numpy(), eas[1].numpy(), posts[0].numpy(),
                 eas[0].numpy())


@pytest.mark.parametrize("width", [256, 384, 640])
def test_cpu_tensors_run_the_plain_version(width):
    """On CPU tensors the wrapper runs bwd_plain, whatever the wave's G
    at that width, and counts nothing."""
    args = _lattice(width, 1)
    launches, scheds = dict(pe.LAUNCHES), pc.SCHEDULES.copy()
    got = pe.pairhmm_bwd(*args)
    assert torch.equal(got, pe.bwd_plain(*args))
    assert pe.LAUNCHES == launches and pc.SCHEDULES == scheds
