"""Pair-HMM posteriors: the port against the JAX package.

* The port's CPU scan (muscle_tpu_torch.ops.pairhmm) against
  muscle_tpu.ops.pairhmm.batch_posteriors, the path both packages take
  on the CPU. Same pairing tree for the within-row scan and the same
  row-0 prefix-sum grouping, so posterior and EA agree within 1e-5.
* The plain twins of the two CUDA kernels (fwd_plain, _total_prob,
  bwd_post_plain; what batch_posteriors_cuda runs on CPU tensors)
  against the Pallas kernels they replace, run in interpret mode, on the
  cases of tests/test_pallas_fused.py and at its tolerance: posterior
  within 2e-3 ignoring cells that flip at the 0.01 threshold, EA within
  2e-3.
* The CUDA kernels against their twins: tests/test_torch_cuda.py, on
  the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.ops import pairhmm as j_pairhmm
from muscle_tpu.ops import pairhmm_pallas as j_pallas
from muscle_tpu_torch.hmm.params import score_pack_from_numpy
from muscle_tpu_torch.ops import pairhmm as t_pairhmm
from muscle_tpu_torch.ops import pairhmm_cuda as t_cuda


def _batch(b, lmax, seed, nucleo, lane_pad):
    """Ragged right-padded batch as in tests/test_pallas_fused.py."""
    nletters = 4 if nucleo else 20
    rng = np.random.default_rng(seed)
    lx = rng.integers(max(8, lmax // 3), lmax + 1, size=b).astype(np.int32)
    ly = rng.integers(max(8, lmax // 3), lmax + 1, size=b).astype(np.int32)
    lx[0] = ly[0] = lmax
    lpad = ((lmax + 127) // 128) * 128 if lane_pad else lmax
    xb = np.full((b, lpad), nletters, np.int32)
    yb = np.full((b, lpad), nletters, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, nletters + 1, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, nletters + 1, size=ly[i])
    return xb, yb, lx, ly


def _jax_pack(nucleo, seed=0):
    hp = JHMMParams.from_defaults(nucleo=nucleo)
    if seed:
        hp.perturb(seed)
    return hp.to_scores()


def _port_pack(jp):
    """The same tables carried into the port as numpy arrays."""
    return score_pack_from_numpy(
        jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM],
        jp.match, jp.insert)


def _t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


@pytest.mark.parametrize("b,lmax,seed,nucleo,perturb", [
    (8, 96, 0, False, 0),
    (8, 70, 1, True, 0),
    (8, 80, 2, False, 11),
], ids=["amino", "nt", "amino-perturbed"])
def test_scan_matches_jax_scan(b, lmax, seed, nucleo, perturb):
    xb, yb, lx, ly = _batch(b, lmax, seed, nucleo, lane_pad=False)
    jp = _jax_pack(nucleo, perturb)
    post_j, ea_j = j_pairhmm.batch_posteriors(
        *_j(xb, yb, lx, ly), *j_pairhmm.score_args(jp))
    post_t, ea_t = t_pairhmm.batch_posteriors(
        *_t(xb, yb, lx, ly), *t_pairhmm.score_args(_port_pack(jp)))
    dpost = float(np.max(np.abs(np.asarray(post_j) - post_t.numpy())))
    dea = float(np.max(np.abs(np.asarray(ea_j) - ea_t.numpy())))
    assert dpost < 1e-5, dpost
    assert dea < 1e-5, dea


def _assert_close(post_ref, ea_ref, post, ea):
    """tests/test_pallas_fused.py:62-69."""
    post_ref = np.asarray(post_ref)
    post = np.asarray(post)
    d = np.abs(post_ref - post)
    flip = ((post_ref == 0) | (post == 0)) & \
        (np.maximum(post_ref, post) <= 0.0102)
    dpost = float(np.max(np.where(flip, 0.0, d)))
    dea = float(np.max(np.abs(np.asarray(ea_ref) - np.asarray(ea))))
    assert dpost < 2e-3, dpost
    assert dea < 2e-3, dea


def _twins(xb, yb, lx, ly, pack):
    """fwd_plain -> _total_prob -> bwd_post_plain on CPU tensors."""
    x, y, lxt, lyt = _t(xb, yb, lx, ly)
    match, insert, params = t_cuda.tables(pack, "cpu")
    fm, fend = t_cuda.fwd_plain(x, y, lxt, lyt, match, insert, params)
    tot = t_cuda._total_prob(fend, params)
    post, mea = t_cuda.bwd_post_plain(x, y, lxt, lyt, match, insert,
                                      params, tot, fm)
    return post, mea / torch.minimum(lxt, lyt).float()


@pytest.mark.parametrize("b,lmax,seed,nucleo", [
    (8, 96, 0, False),
    (8, 70, 1, True),
    (8, 96, 3, False),
], ids=["amino", "nt", "amino-seed3"])
def test_twins_match_pallas_interpret(b, lmax, seed, nucleo):
    xb, yb, lx, ly = _batch(b, lmax, seed, nucleo, lane_pad=True)
    jp = _jax_pack(nucleo)
    post_p, ea_p = j_pallas.batch_posteriors_pallas(
        *_j(xb, yb, lx, ly), *j_pairhmm.score_args(jp), fused=True,
        interpret=True)
    post, ea = _twins(xb, yb, lx, ly, _port_pack(jp))
    _assert_close(post_p, ea_p, post.numpy(), ea.numpy())
    # the wrapper on CPU tensors runs exactly these twins
    post_w, ea_w = t_cuda.batch_posteriors_cuda(*_t(xb, yb, lx, ly),
                                                _port_pack(jp))
    assert torch.equal(post_w, post) and torch.equal(ea_w, ea)


def test_twins_match_pallas_per_pair_perturbed_tables():
    """Per-pair perturbed tables (the ensembles' multi-table call on the
    JAX side); the port runs each pair with its own tables."""
    b, lmax, seed = 8, 80, 2
    xb, yb, lx, ly = _batch(b, lmax, seed, False, lane_pad=True)
    packs = [_jax_pack(False, i + 1) for i in range(b)]
    post_p, ea_p = j_pallas.batch_posteriors_pallas_multi(
        *_j(xb, yb, lx, ly),
        jnp.asarray(np.stack([p.match for p in packs])),
        jnp.asarray(np.stack([p.insert for p in packs])),
        jnp.asarray(np.stack([p.start for p in packs])),
        jnp.stack([j_pairhmm._trans_vec(p) for p in packs]),
        fused=True, interpret=True)
    posts, eas = [], []
    for i, jp in enumerate(packs):
        sl = slice(i, i + 1)
        post, ea = _twins(xb[sl], yb[sl], lx[sl], ly[sl], _port_pack(jp))
        posts.append(post)
        eas.append(ea)
    _assert_close(post_p, ea_p, torch.cat(posts).numpy(),
                  torch.cat(eas).numpy())


def test_wrapper_rejects_bad_inputs():
    xb, yb, lx, ly = _batch(2, 40, 0, False, lane_pad=False)
    pack = _port_pack(_jax_pack(False))
    match, insert, params = t_cuda.tables(pack, "cpu")
    with pytest.raises(ValueError):
        t_cuda._check_inputs(*_t(xb, yb, lx, ly), match, insert, params)
    xb, yb, lx, ly = _batch(2, 40, 0, False, lane_pad=True)
    x, y, lxt, lyt = _t(xb, yb, lx, ly)
    with pytest.raises(ValueError):
        t_cuda._check_inputs(x.long(), y, lxt, lyt, match, insert, params)
    assert t_cuda._check_inputs(x, y, lxt, lyt, match, insert,
                                params) == (2, 128, 128, 21)
