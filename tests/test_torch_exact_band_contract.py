"""The schedule of the reference-order kernels (csrc/pairhmm_exact.cu) on
the CPU: `pairhmm_exact_cuda.exact_band_plain` runs it lane by lane and
band by band (warps of 32 rows, lane t's row above from lane t - 1 by a
shuffle, lane 0's from the band above's ring inside a block or from the
round above's link row between blocks, band 0's from row 0's chain, the
M cells through each warp's tile), in an order a seeded generator picks
among the warps whose waits allow, with fewer blocks resident than the
launch has. Held here:

(a) bit for bit to the plain versions (fwd_exact_wave / bwd_exact_wave)
    inside each pair, at lx in {1, 31, 32, 33, 70} and ly in {1, 5, 40}
    with more bands than a round holds, for letters (shared tables) and
    their lattice, and (letters) to the JAX package's scans under
    MUSCLE_TPU_EXACT_ASSOC;
(b) lane 0 takes a hand-over slot only once it holds the column it
    wants (the kernel's slot tags), and no ring slot is overwritten
    before its column was used: a producer let run past its ring's room
    is caught, and a ring too small for a run's lag deadlocks and is
    caught;
(c) the model's constants and geometry are the kernel source's.

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda_exact.py, chip_smoke.py).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muscle_tpu.ops import pairhmm as jph
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm as ph
from muscle_tpu_torch.ops import pairhmm_cuda as pc
from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (lx, ly) of the pairs: every lx against every ly
LX = (1, 31, 32, 33, 70)
LY = (1, 5, 40)


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pairs(seed):
    """Letters (codes 0-19, wildcard-padded at 70 x 40) of every (lx,
    ly) and their lattice, with the default amino scores."""
    rng = np.random.default_rng(seed)
    lx = np.repeat(LX, len(LY)).astype(np.int32)
    ly = np.tile(LY, len(LX)).astype(np.int32)
    b = len(lx)
    xb = np.full((b, max(LX)), 20, np.int32)
    yb = np.full((b, max(LY)), 20, np.int32)
    for k in range(b):
        xb[k, :lx[k]] = rng.integers(0, 20, lx[k])
        yb[k, :ly[k]] = rng.integers(0, 20, ly[k])
    pack = HMMParams.from_defaults().to_scores()
    match, insert, params = pc.tables(pack, "cpu")
    t = [torch.from_numpy(a) for a in (xb, yb, lx, ly)]
    letters = pec.Letters(t[0], t[1], match, insert)
    return letters, t[2], t[3], params, pack


def _inside(lat, lx, ly, bwd):
    """The cells each kernel writes, pair by pair."""
    d = int(bwd)
    return [lat[k, :min(int(lx[k]) + d, lat.shape[1]),
                :min(int(ly[k]) + d, lat.shape[2])]
            for k in range(lat.shape[0])]


def _jax_scans(e, ins_x, ins_y, e_r, ins_xr, ins_yr, pack):
    """(F_M, fend, RB_M) of the JAX package's scans under its exact flag
    (read at trace time; set for these calls only)."""
    _, _, start, tv = ph.score_args(pack)
    st, t = jnp.asarray(start.numpy()), jnp.asarray(tv.numpy())
    fwd = jax.vmap(jph._forward_scan, in_axes=(0, 0, 0, None, None))
    bwd = jax.vmap(jph._backward_scan, in_axes=(0, 0, 0, None, None))
    saved = jph.EXACT_ASSOC
    jph.EXACT_ASSOC = True
    try:
        f = fwd(*(jnp.asarray(a.numpy()) for a in (e, ins_x, ins_y)), st, t)
        rb = bwd(*(jnp.asarray(a.numpy()) for a in (e_r, ins_xr, ins_yr)),
                 st, t)
    finally:
        jph.EXACT_ASSOC = saved
    return [np.asarray(s) for s in f], np.asarray(rb[0])


@pytest.mark.parametrize("source", ["letters", "lattice"])
def test_band_schedule_equals_plain_and_jax(source):
    letters, lx, ly, params, pack = _pairs(17)
    lat = pec.Lattice(*pec._lattice(letters))
    src = letters if source == "letters" else lat
    fm, fend = pec.exact_band_plain(src, lx, ly, params, warps=2,
                                    resident=3, seed=1)
    rbm, far = pec.exact_band_plain(src, lx, ly, params, bwd=True, warps=2,
                                    resident=3, seed=2)
    want_fm, want_fend = pec.fwd_exact_plain(src, lx, ly, params)
    want_rbm, want_far = pec.bwd_exact_plain(src, lx, ly, params)
    for got, want in zip(_inside(fm, lx, ly, False),
                         _inside(want_fm, lx, ly, False)):
        assert torch.equal(got, want)
    for got, want in zip(_inside(rbm, lx, ly, True),
                         _inside(want_rbm, lx, ly, True)):
        assert torch.equal(got, want)
    assert torch.equal(fend, want_fend) and torch.equal(far, want_far)
    if source == "lattice":
        return  # the letters' lattice: the same values the JAX scans get
    f, rb = _jax_scans(*lat, *pec._reversed(src, lx, ly), pack)
    for k, got in enumerate(_inside(fm, lx, ly, False)):
        n, m = got.shape
        assert np.array_equal(got.numpy(), f[0][k, 1:n + 1, 1:m + 1])
    for k, got in enumerate(_inside(rbm, lx, ly, True)):
        n, m = got.shape
        assert np.array_equal(got.numpy(), rb[k, :n, :m])
    ar = np.arange(len(lx))
    jend = np.stack([s[ar, lx.numpy(), ly.numpy()] for s in f], 1)
    assert np.array_equal(fend.numpy(), jend)


def test_overrun_and_small_ring_are_caught(monkeypatch):
    """A producer that waits for room a ring and a half ahead overwrites
    columns its consumer has not used; a ring shorter than a run's lag
    stalls both neighbours."""
    letters, lx, ly, params, _ = _pairs(18)
    monkeypatch.setattr(pec, "EXACT_RING", 16)
    monkeypatch.setattr(pec._Schedule, "ROOM", 24)
    with pytest.raises(RuntimeError, match="overwritten before it was read"):
        pec.exact_band_plain(letters, lx, ly, params, warps=3)
    monkeypatch.setattr(pec._Schedule, "ROOM", 16)
    with pytest.raises(RuntimeError, match="deadlock"):
        pec.exact_band_plain(letters, lx, ly, params, warps=3)


def test_constants_and_geometry_are_the_kernels():
    src = open(os.path.join(REPO, "muscle_tpu_torch", "csrc",
                            "pairhmm_exact.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("MAX_WARPS"), const("HC"), const("RING"), const("MC"),
            const("CWM")) == (pec.EXACT_MAX_WARPS, pec.EXACT_HC,
                              pec.EXACT_RING, pec.EXACT_MC, pec.EXACT_CWM)
    # the launch's blocks: B * ceil(ceil(Lx / 32) / warps)
    assert "((Lx + 31) / 32 + warps - 1) / warps" in src
    for lx in (1, 70, 512, 8448, 12288):
        warps, rounds = pec.exact_geometry(lx)
        assert 1 <= warps <= pec.EXACT_MAX_WARPS
        assert rounds == -(-(-(-lx // 32)) // warps)
        assert warps <= -(-lx // 32)
    with pytest.raises(ValueError):
        pec.exact_geometry(64, warps=pec.EXACT_MAX_WARPS + 1)
