"""Long pairs: the port's long-pair routes against muscle_tpu.

* The checkpoint/recompute scan (ops/pairhmm_long.py) against
  muscle_tpu.ops.pairhmm_long on the cases of tests/test_long_pair.py,
  and against the port's own monolithic scan, exactly.
* The plain twins of the Y-striped kernels 5/6 (ops/pairhmm_striped.py,
  what the wrappers run on CPU tensors) against the Pallas striped
  kernels in interpret mode, at the kernel gate of
  tests/test_pallas_fused.py:62-69: posterior within 2e-3 ignoring cells
  that flip at the 0.01 threshold, EA within 2e-3.
* Kernels A/B's twins at the lane widths the router adds, against the
  Pallas kernels (interpret mode) and the port's scan.
The router and align() through it: tests/test_torch_longpair_router.py
(a file of its own, so that the test workers share the load). The CUDA
kernels against their twins: tests/test_torch_cuda.py, on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.ops import pairhmm as j_pairhmm
from muscle_tpu.ops import pairhmm_long as j_long
from muscle_tpu.ops import pairhmm_pallas as j_pallas
from muscle_tpu.ops import pairhmm_striped as j_striped
from muscle_tpu_torch.hmm.params import score_pack_from_numpy
from muscle_tpu_torch.ops import pairhmm as t_pairhmm
from muscle_tpu_torch.ops import pairhmm_cuda as t_cuda
from muscle_tpu_torch.ops import pairhmm_long as t_long
from muscle_tpu_torch.ops import pairhmm_striped as t_striped
from muscle_tpu_torch.ops import sparse as t_sparse
from muscle_tpu_torch.ops.sparse import densify_np


@pytest.fixture(scope="module")
def packs():
    jp = JHMMParams.from_defaults().to_scores()
    tp = score_pack_from_numpy(
        jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM],
        jp.match, jp.insert)
    return jp, tp


def _t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _edge_flips(a, b):
    """Cells zero in one posterior only, at the 0.01 threshold."""
    return ((a == 0) | (b == 0)) & (np.maximum(a, b) <= 0.0102)


def _ragged(lxs, lys, bx, by, seed):
    rng = np.random.default_rng(seed)
    b = len(lxs)
    xb = np.full((b, bx), 20, np.int32)
    yb = np.full((b, by), 20, np.int32)
    for i in range(b):
        xb[i, :lxs[i]] = rng.integers(0, 20, lxs[i])
        yb[i, :lys[i]] = rng.integers(0, 20, lys[i])
    return xb, yb, np.asarray(lxs, np.int32), np.asarray(lys, np.int32)


# ---------------------------------------------------------------------------
# 1. the checkpoint/recompute scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lx,ly,rb", [(300, 260, 64), (257, 300, 128),
                                      (128, 128, 128)])
def test_scan_route_matches_jax(packs, lx, ly, rb):
    jp, tp = packs
    rng = np.random.default_rng(5)
    base = rng.integers(0, 20, max(lx, ly))
    xc = base[:lx].copy()
    yc = base[:ly].copy()
    mut = rng.random(ly) < 0.2
    yc[mut] = rng.integers(0, 20, mut.sum())

    jv, jc, jea, _ = j_long.long_pair_posterior_sparse(xc, yc, jp, k=32,
                                                       row_block=rb)
    tv, tc, tea, _ = t_long.long_pair_posterior_sparse(xc, yc, tp, k=32,
                                                       row_block=rb)
    dj = densify_np(np.asarray(jv), np.asarray(jc), ly)
    dt = densify_np(tv, tc, ly)
    edge = _edge_flips(dj, dt)
    assert not (((dj > 0) != (dt > 0)) & ~edge).any()
    assert float(np.abs(np.where(edge, 0.0, dj - dt)).max()) < 1e-6
    assert abs(jea - tea) < 1e-5

    # the blocked output equals the port's monolithic scan exactly
    post, ea = t_pairhmm.batch_posteriors(
        *_t(xc[None].astype(np.int32), yc[None].astype(np.int32),
            np.array([lx]), np.array([ly])), *t_pairhmm.score_args(tp))
    assert np.array_equal(dt, post[0].numpy())
    assert abs(tea - float(ea[0])) < 1e-5


def test_scan_route_at_a_checkpoint_boundary(packs):
    """lx a multiple of row_block with two blocks: the first block's
    lowest backward row is a checkpoint row. The port equals its
    monolithic scan there (muscle_tpu's blocked scan misreads that row,
    ROADMAP.md, faults)."""
    _, tp = packs
    rng = np.random.default_rng(5)
    xc = rng.integers(0, 20, 256)
    yc = xc[:200].copy()
    tv, tc, tea, _ = t_long.long_pair_posterior_sparse(xc, yc, tp, k=32,
                                                       row_block=128)
    post, ea = t_pairhmm.batch_posteriors(
        *_t(xc[None].astype(np.int32), yc[None].astype(np.int32),
            np.array([256]), np.array([200])), *t_pairhmm.score_args(tp))
    assert np.array_equal(densify_np(tv, tc, 200), post[0].numpy())
    assert abs(tea - float(ea[0])) < 1e-6


# ---------------------------------------------------------------------------
# 2. the striped kernels' twins
# ---------------------------------------------------------------------------

def _striped_case():
    """tests/test_long_pair.py:71-84: ly == By, ly < one stripe, ly
    crossing a stripe edge, lx == Bx, short pairs in long padding."""
    return _ragged([256, 200, 90, 256, 130, 240, 70, 220],
                   [512, 500, 450, 255, 256, 300, 100, 400], 256, 512, 0)


def test_striped_twins_match_pallas_interpret(packs):
    jp, tp = packs
    xb, yb, lx, ly = _striped_case()
    jv, jc, jea, jnnz = j_striped.striped_posteriors_sparse(
        *_j(xb, yb, lx, ly), *j_pairhmm.score_args(jp), k=32, stripe_w=256,
        tile_p=8, interpret=True)
    before = dict(t_striped.LAUNCHES)
    tv, tc, tea, tnnz = t_striped.striped_posteriors_sparse(
        *_t(xb, yb, lx, ly), tp, k=32, stripe_w=256)
    assert t_striped.LAUNCHES == before     # CPU tensors: twins only
    jv, jc = np.asarray(jv), np.asarray(jc)
    tv, tc = tv.numpy(), tc.numpy()
    for i in range(len(lx)):
        a = densify_np(jv[i], jc[i], 512)
        b = densify_np(tv[i], tc[i], 512)
        assert float(np.abs(np.where(_edge_flips(a, b), 0.0, a - b)).max()) \
            < 2e-3
        both = (jv[i] > 0.0101) & (tv[i] > 0.0101)
        assert np.array_equal(jc[i][both], tc[i][both])
    assert float(np.abs(np.asarray(jea) - tea.numpy()).max()) < 2e-3
    assert int(jnnz) == tnnz


def test_one_stripe_equals_kernel_twins(packs, monkeypatch):
    """With W = By the striped twins are kernels A/B's twins but for the
    row-0 prefix sums: the orchestration groups them as XLA does, kernel
    A/B as Hillis-Steele rounds. The sums differ in the last bit (~6e-5
    at |row-0 score| ~ 500, so posteriors move ~1e-5); given the same
    sums, the results are equal bit for bit."""
    _, tp = packs
    xb, yb, lx, ly = _striped_case()
    post, ea = t_cuda.batch_posteriors_cuda(*_t(xb, yb, lx, ly), tp)
    vals, cols, nnz = t_sparse.sparsify(post, 32)
    sv, sc, sea, snnz = t_striped.striped_posteriors_sparse(
        *_t(xb, yb, lx, ly), tp, k=32, stripe_w=512)
    assert float((sv - vals).abs().max()) < 1e-4
    assert torch.equal(sc, cols)
    assert float((sea - ea).abs().max()) < 1e-5
    monkeypatch.setattr(t_striped, "_cumsum_xla", t_cuda._cumsum_lanes)
    sv, sc, sea, snnz = t_striped.striped_posteriors_sparse(
        *_t(xb, yb, lx, ly), tp, k=32, stripe_w=512)
    assert torch.equal(sv, vals) and torch.equal(sc, cols)
    assert torch.equal(sea, ea) and snnz == int(nnz)


def test_stripe_wrappers_reject_bad_inputs(packs):
    _, tp = packs
    xb, yb, lx, ly = _t(*_striped_case())
    match, insert, params = t_cuda.tables(tp, "cpu")
    iy0, jy0, _, _ = t_striped.row0_closed_forms(yb, ly, insert, params)
    args = (xb, yb, lx, ly, match, insert, params, {"iy0": iy0})
    assert t_striped._check(*args, 256) == (8, 256, 512, 21)
    with pytest.raises(ValueError):
        t_striped._check(*args, 192)      # does not divide By
    with pytest.raises(ValueError):
        t_striped._check(*args, 32)       # not a multiple of 64
    with pytest.raises(ValueError):
        t_striped._check(xb.long(), *args[1:], 256)
    with pytest.raises(ValueError):
        t_striped._check(*args[:7], {"iy0": iy0.double()}, 256)


# ---------------------------------------------------------------------------
# 3. kernels A/B's twins at the router's lane widths
# ---------------------------------------------------------------------------

def test_kernel_twins_at_long_rungs(packs):
    """Against the Pallas kernels at Ly = 1024 (interpret mode at 10240
    costs ~45 s of compile here), and against the port's scan at the new
    top rung Ly = 10240; on the card the kernels equal these twins at
    10240 (tests/test_torch_cuda.py, chip_smoke.py)."""
    jp, tp = packs
    xb, yb, lx, ly = _ragged([48, 33], [1000, 931], 48, 1024, 1)
    post_p, ea_p = j_pallas.batch_posteriors_pallas(
        *_j(xb, yb, lx, ly), *j_pairhmm.score_args(jp), tile_p=8,
        interpret=True)
    post, ea = t_cuda.batch_posteriors_cuda(*_t(xb, yb, lx, ly), tp)
    post_p, post = np.asarray(post_p), post.numpy()
    assert float(np.abs(np.where(_edge_flips(post_p, post), 0.0,
                                 post_p - post)).max()) < 2e-3
    assert float(np.abs(np.asarray(ea_p) - ea.numpy()).max()) < 2e-3

    xb, yb, lx, ly = _ragged([40, 29], [9800, 9731], 40, 10240, 2)
    post, ea = t_cuda.batch_posteriors_cuda(*_t(xb, yb, lx, ly), tp)
    post_s, ea_s = t_pairhmm.batch_posteriors(*_t(xb, yb, lx, ly),
                                              *t_pairhmm.score_args(tp))
    post, post_s = post.numpy(), post_s.numpy()
    assert float(np.abs(np.where(_edge_flips(post_s, post), 0.0,
                                 post_s - post)).max()) < 2e-3
    assert float((ea - ea_s).abs().max()) < 2e-3
