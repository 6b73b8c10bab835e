"""Kernel 1E on kernel A's two schedules (ops/pairhmm_emis_cuda.py).

Kernel 1E, the Muscle-3D forward from an emission lattice, runs one
block a pair up to WAVE_MIN_LY = 2048 lanes and, beyond it, each pair's
row as a skewed wavefront of groups of G 64-lane segments across SMs
(csrc/pairhmm_wave.cuh's forward body, the lattice read a row ahead).
These tests hold what runs here: the schedule and G at the rungs the
main path launches 1E at (mega-128's 384, the fused route's widths up
to FUSED_MAX_LY, the legacy route's 12288); the hand-over's bytes at
mega-long's launch; the wave's arithmetic (`fwd_wave_plain`: group
after group, each taking its left neighbour's records) against the
block plain version `fwd_emis_plain` bit for bit at widths 256-640, at
every group size, and against kernel A's plain version on the letter
lattice; the legacy route built on the wave twin against the JAX
package's `_fwd_pallas` (and `_bwd_kernel`) in interpret mode at the
kernel gate of tests/test_pallas_fused.py:62-69; the wrapper's CPU
route. The CUDA kernel on the card: tests/test_torch_cuda_1e_densify.py.
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
from test_torch_mega_kernels import (_args, _assert_gate,  # noqa: F401
                                     _bwd_pallas_interpret, _jax_params,
                                     case)


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("b", [1, 8, 256])
@pytest.mark.parametrize("width,want", [
    (128, pc.ABGeometry("block")), (384, pc.ABGeometry("block")),
    (2048, pc.ABGeometry("block")), (2176, pc.ABGeometry("wave", 2, 17)),
    (4096, pc.ABGeometry("wave", 4, 16)),
    (9856, pc.ABGeometry("wave", 2, 77)),
    (10240, pc.ABGeometry("wave", 4, 40)),
    (12288, pc.ABGeometry("wave", 4, 48))])
def test_schedule_at_the_rungs(width, want, b):
    """One block a pair up to 2048 lanes (mega-128's 384 rung), the wave
    beyond, in groups of the largest divisor of the segments up to 4:
    mega-long's 12288 in 48 groups of 4 segments a pair, whatever B."""
    assert pc.ab_geometry(b, width) == want


def test_hand_over_at_mega_longs_launch():
    """8 pairs at 12288 x 12288: one 16-byte record a DP row for each of
    the 8 x 48 groups, 75.5 MB, 1 / (16 G) of the M lattice's 4.8 GB;
    row 0's buffers 4 B Ly floats."""
    b, lx, ly = 8, 12288, 12288
    geo = pc.ab_geometry(b, ly)
    hand = wavefront.hand_bytes(b, geo.groups, lx, "fwd")
    assert hand == 8 * 48 * 12288 * 16 == 75_497_472
    assert hand * 16 * geo.g == b * lx * ly * 4
    _, bufs = pc._wave_args(geo, 2, 3, 256, "fwd", "cpu")
    assert bufs[3].numel() == 4 * 2 * 256


def _lattice(width, seed, b=6, rows=48):
    """A random lattice with ragged pairs: a full-width pair, padding
    inside a segment, on a segment edge, one lane past it, a short pair
    and a one-column one; lx from 1 to rows."""
    rng = np.random.default_rng(seed)
    lx = np.array([rows, rows - 7, 13, rows - 1, 1, 30], np.int32)[:b]
    ly = np.array([width, width - 5, width - 64, width - 63, 64 * 2 + 17, 1],
                  np.int32)[:b]
    e = (rng.random((b, rows, width), dtype=np.float32) * 4 - 3)
    ins_x = -1 - rng.random((b, rows), dtype=np.float32)
    ins_y = -1 - rng.random((b, width), dtype=np.float32)
    return tuple(torch.from_numpy(a) for a in (e, ins_x, ins_y, lx, ly))


def _real(t, lx, ly):
    r = torch.arange(t.shape[1])[None, :, None]
    c = torch.arange(t.shape[2])[None, None, :]
    return t.where((r < lx[:, None, None]) & (c < ly[:, None, None]), 0.0)


@pytest.mark.parametrize("width,g", [(256, 1), (256, 4), (384, 2), (384, 3),
                                     (640, 2), (640, 5)])
def test_wave_twin_equals_block_plain(width, g):
    """What the wide schedule computes (each group one run of the body,
    the carry chain continued from its left neighbour in segment order)
    equals fwd_emis_plain on the real cells and fend bit for bit, so
    kernel 1E gives the same numbers on either schedule."""
    e, ins_x, ins_y, lx, ly = _lattice(width, width + g)
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), "cpu")
    assert pc.ab_geometry(6, width, "wave", g).groups == width // (64 * g)
    fm, fend = pe.fwd_emis_plain(e, ins_x, ins_y, lx, ly, params)
    fm_w, fend_w = pe.fwd_wave_plain(e, ins_x, ins_y, lx, ly, params, g)
    assert torch.equal(_real(fm_w, lx, ly), _real(fm, lx, ly))
    assert torch.equal(fend_w, fend)


def test_wave_twin_on_the_letter_lattice_equals_kernel_a():
    """Fed the letter lattice match[x_i, y_j] with insert[x_i],
    insert[y_j], the wave twin gives kernel A's plain version bit for
    bit (on the card: 1E on the wave = kernel A on the wave)."""
    rng = np.random.default_rng(21)
    b, rows, width = 4, 40, 512
    lx = np.array([40, 17, 33, 2], np.int32)
    ly = np.array([512, 300, 449, 64], np.int32)
    xb = np.full((b, rows), 20, np.int32)
    yb = np.full((b, width), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, ly[i])
    x, y, lxt, lyt = (torch.from_numpy(a) for a in (xb, yb, lx, ly))
    match, insert, params = pc.tables(HMMParams.from_defaults().to_scores(),
                                      "cpu")
    fm, fend = pc.fwd_plain(x, y, lxt, lyt, match, insert, params)
    e = match[x.long()[:, :, None], y.long()[:, None, :]]
    fm_w, fend_w = pe.fwd_wave_plain(e, insert[x.long()], insert[y.long()],
                                     lxt, lyt, params, 2)
    assert torch.equal(_real(fm_w, lxt, lyt), _real(fm, lxt, lyt))
    assert torch.equal(fend_w, fend)


def test_legacy_route_on_the_wave_matches_pallas_interpret(case):
    """The legacy route with 1E and 3 on the wave (their twins, two
    groups of one segment a pair), finish_posteriors and kernel 4,
    against the JAX package's legacy route: `_fwd_pallas` and
    `_bwd_kernel` in interpret mode, `_finish_posteriors`, at the kernel
    gate."""
    arr, lx, ly, jp, _ = case
    start, _, params_j = _jax_params(jp, 8)
    e_j = jnp.asarray(arr["e"])
    b, _, by = e_j.shape
    lymask = (jnp.arange(by)[None, :]
              == (jnp.asarray(ly)[:, None] - 1)).astype(jnp.float32)
    lxf = jnp.broadcast_to(jnp.asarray(lx, jnp.float32)[:, None], (b, 128))
    fm_t, f_end5 = j_pallas._fwd_pallas(
        e_j.transpose(1, 0, 2), jnp.asarray(arr["ins_x"]).T[:, :, None],
        jnp.asarray(arr["ins_y"]), lymask, lxf, params_j, 8,
        j_pallas.SCAN_IMPL, interpret=True)
    rbm_t = _bwd_pallas_interpret(
        jnp.asarray(arr["e_rev"].transpose(1, 0, 2)),
        jnp.asarray(arr["ins_xr"].T[:, :, None]), jnp.asarray(arr["ins_yr"]),
        params_j, 8, j_pallas.SCAN_IMPL)
    # its MEA (mea_scores_pallas) in interpret mode too
    post_p, _ = j_pallas._finish_posteriors(
        fm_t, rbm_t, f_end5, jnp.asarray(lx), jnp.asarray(ly), start, False,
        8)
    ea_p = j_pallas.mea_scores_pallas(post_p.transpose(1, 0, 2), 8,
                                      interpret=True) / np.minimum(lx, ly)
    e, ins_x, ins_y, lxt, lyt, params = _args(case)
    fm, fend = pe.fwd_wave_plain(e, ins_x, ins_y, lxt, lyt, params, 1)
    rbm = pe.bwd_wave_plain(e, ins_x, ins_y, lxt, lyt, params, 1)
    post = pe.finish_posteriors(fm, rbm, fend, lxt, lyt, params)
    ea = pe.mea_scores_plain(post) / torch.minimum(lxt, lyt).float()
    _assert_gate(post_p, ea_p, post, ea)


@pytest.mark.parametrize("schedule", [None, "block", "wave"])
def test_cpu_tensors_run_the_plain_version(schedule):
    """On CPU tensors the wrapper runs fwd_emis_plain whatever the
    schedule and counts nothing, and both routes need no hand-over check;
    a forced G that does not divide the row raises first."""
    e, ins_x, ins_y, lx, ly = _lattice(2176, 3, b=2, rows=12)
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), "cpu")
    launches, scheds = dict(pe.LAUNCHES), pc.SCHEDULES.copy()
    fm, fend = pe.pairhmm_fwd_emis(e, ins_x, ins_y, lx, ly, params,
                                   schedule=schedule)
    fm2, fend2 = pe.fwd_emis_plain(e, ins_x, ins_y, lx, ly, params)
    assert torch.equal(fm, fm2) and torch.equal(fend, fend2)
    pe.emissions_path_fused(e, ins_x, ins_y, lx, ly, params)
    assert pe.LAUNCHES == launches and pc.SCHEDULES == scheds
    with pytest.raises(ValueError):     # 3 does not divide 34 segments
        pe.pairhmm_fwd_emis(e, ins_x, ins_y, lx, ly, params,
                            schedule="wave", g=3)
    wavefront.check_waits("cpu")
