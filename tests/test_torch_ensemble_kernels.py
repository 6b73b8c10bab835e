"""The ensembles' pair-HMM forms: the port against the JAX package.

The replicate batching runs every (replicate, pair) lane with its own
score tables. Here, on the CPU:

* the port's CPU scan `batch_posteriors_multi` (+ `score_args_multi`)
  against muscle_tpu.ops.pairhmm.batch_posteriors_multi, within 1e-5;
* the plain versions of kernels 1M and 2M (what
  `batch_posteriors_cuda_multi` runs on CPU tensors) against
  `batch_posteriors_pallas_multi(..., interpret=True)`, 8 lanes at
  L = 128 with 2 packs mixed, at the kernel gate of
  tests/test_pallas_fused.py:62-69 (posterior within 2e-3 ignoring cells
  that flip at the 0.01 threshold, EA within 2e-3);
* the plain legacy letter route (3K, `finish_posteriors` with each
  pair's start scores, kernel 4) against
  `batch_posteriors_pallas_multi(fused=False, interpret=True)` (its
  pallas_calls forced to interpret mode: the legacy route passes no
  interpret flag), and 3K's plain version against `_bwd_kernel` (kk=K)
  on every cell the combine reads;
* each multi lane against the single-pack plain versions, bit for bit,
  and kernels 1E/2E's plain versions with per-pair params on the
  per-pair lattice against 1M/2M's;
* the identity behind 3K: JAX's rolled codes `roll(x[::-1], lx - Lx)`
  are x read reversed.
The kernels against these plain versions on the card:
tests/test_torch_cuda.py and chip_smoke.py.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.ops import pairhmm as j_pairhmm
from muscle_tpu.ops import pairhmm_pallas as j_pallas
from muscle_tpu_torch.hmm.params import score_pack_from_numpy
from muscle_tpu_torch.ops import pairhmm as t_pairhmm
from muscle_tpu_torch.ops import pairhmm_cuda as t_cuda
from muscle_tpu_torch.ops import pairhmm_emis_cuda as t_emis

B, LMAX, PAD = 8, 120, 128
REP = np.array([0, 1, 1, 0, 1, 0, 0, 1])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run many small ops, which gain nothing from
    intra-op threads; one thread keeps them from crowding the other test
    workers on the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(b, lmax, width, seed):
    rng = np.random.default_rng(seed)
    lx = rng.integers(lmax // 3, lmax + 1, size=b).astype(np.int32)
    ly = rng.integers(lmax // 3, lmax + 1, size=b).astype(np.int32)
    lx[0] = ly[0] = lmax
    xb = np.full((b, width), 20, np.int32)
    yb = np.full((b, width), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
    return xb, yb, lx, ly


def _port_pack(jp):
    return score_pack_from_numpy(
        jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM],
        jp.match, jp.insert)


@pytest.fixture(scope="module")
def case():
    """8 ragged amino pairs padded to 128 and two packs (seed 0 and a
    perturbed one), mixed lane by lane as REP says."""
    jps = []
    for seed in (0, 5):
        hp = JHMMParams.from_defaults()
        if seed:
            hp.perturb(seed)
        jps.append(hp.to_scores())
    return _batch(B, LMAX, PAD, 17), jps, [_port_pack(p) for p in jps]


def _t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _jax_multi(jps):
    return j_pairhmm.score_args_multi(jps, REP)


def _port_multi(tps):
    return t_pairhmm.score_args_multi(tps, REP)


def _assert_gate(post_ref, ea_ref, post, ea):
    post_ref, post = np.asarray(post_ref), np.asarray(post)
    d = np.abs(post_ref - post)
    flip = ((post_ref == 0) | (post == 0)) & \
        (np.maximum(post_ref, post) <= 0.0102)
    dpost = float(np.max(np.where(flip, 0.0, d)))
    dea = float(np.max(np.abs(np.asarray(ea_ref) - np.asarray(ea))))
    assert dpost < 2e-3, dpost
    assert dea < 2e-3, dea


def test_multi_scan_matches_jax(case):
    """The CPU scan with per-pair tables within 1e-5 of JAX's, and each
    lane equal to the shared-table scan on its own pack."""
    (xb, yb, lx, ly), jps, tps = case
    post_j, ea_j = j_pairhmm.batch_posteriors_multi(
        *(jnp.asarray(a) for a in (xb, yb, lx, ly)), *_jax_multi(jps))
    args = _t(xb, yb, lx, ly)
    post_t, ea_t = t_pairhmm.batch_posteriors_multi(*args, *_port_multi(tps))
    assert float(np.abs(np.asarray(post_j) - post_t.numpy()).max()) < 1e-5
    assert float(np.abs(np.asarray(ea_j) - ea_t.numpy()).max()) < 1e-5
    for r, tp in enumerate(tps):
        rows = torch.as_tensor(np.flatnonzero(REP == r))
        post_s, ea_s = t_pairhmm.batch_posteriors(
            *args, *t_pairhmm.score_args(tp))
        assert torch.equal(post_t[rows], post_s[rows])
        assert torch.equal(ea_t[rows], ea_s[rows])


def test_emissions_multi_scan_matches_jax(case):
    """The scan's per-pair form from emission lattices (JAX's
    batch_posteriors_emissions_multi) within 1e-5 of JAX's on the same
    lattices and per-pair transitions."""
    (xb, yb, lx, ly), jps, tps = case
    match_b, insert_b, start_b, tv_b = _port_multi(tps)
    xt, yt, lxt, lyt = (a.long() for a in _t(xb, yb, lx, ly))
    xr = t_pairhmm.reverse_padded(xt, lxt)
    yr = t_pairhmm.reverse_padded(yt, lyt)
    ar = torch.arange(B)[:, None, None]
    lat = (match_b[ar, xt[:, :, None], yt[:, None, :]],
           match_b[ar, xr[:, :, None], yr[:, None, :]],
           *(torch.gather(insert_b, 1, c) for c in (xt, yt, xr, yr)))
    post_t, ea_t = t_pairhmm.batch_posteriors_emissions_multi(
        *lat, lxt, lyt, start_b, tv_b)
    j_start, j_tv = _jax_multi(jps)[2:]
    post_j, ea_j = j_pairhmm.batch_posteriors_emissions_multi(
        *(jnp.asarray(a.numpy()) for a in lat), jnp.asarray(lx),
        jnp.asarray(ly), j_start, j_tv)
    assert float(np.abs(np.asarray(post_j) - post_t.numpy()).max()) < 1e-5
    assert float(np.abs(np.asarray(ea_j) - ea_t.numpy()).max()) < 1e-5


def test_multi_plain_matches_pallas_multi_interpret(case):
    """1M, the per-pair total-probability fold and 2M (plain) against
    the Pallas multi path in interpret mode (which takes its per-pair
    emission lattice through 1E/2E at this size)."""
    (xb, yb, lx, ly), jps, tps = case
    post_p, ea_p = j_pallas.batch_posteriors_pallas_multi(
        *(jnp.asarray(a) for a in (xb, yb, lx, ly)), *_jax_multi(jps),
        fused=True, interpret=True)
    post, ea = t_cuda.batch_posteriors_cuda_multi(*_t(xb, yb, lx, ly),
                                                  *_port_multi(tps))
    _assert_gate(post_p, ea_p, post, ea)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Every pallas_call in interpret mode: JAX's legacy letter route
    launches `_bwd_pallas_fused` and `mea_scores_pallas` without an
    interpret flag."""
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)
    monkeypatch.setattr(j_pallas.pl, "pallas_call", interpreted)


def test_legacy_route_matches_pallas_multi_interpret(case, interpret_pallas):
    """The legacy letter route (1M, 3K, finish_posteriors with each
    pair's start scores, kernel 4; plain versions) against
    batch_posteriors_pallas_multi(fused=False), and against the fused
    route, at the kernel gate."""
    (xb, yb, lx, ly), jps, tps = case
    post_p, ea_p = j_pallas.batch_posteriors_pallas_multi(
        *(jnp.asarray(a) for a in (xb, yb, lx, ly)), *_jax_multi(jps),
        fused=False, interpret=True)
    args = _t(xb, yb, lx, ly)
    post, ea = t_cuda.batch_posteriors_cuda_multi(*args, *_port_multi(tps),
                                                  fused=False)
    _assert_gate(post_p, ea_p, post, ea)
    _assert_gate(*t_cuda.batch_posteriors_cuda_multi(*args,
                                                     *_port_multi(tps)),
                 post, ea)


def _bwd_fused_interpret(xm_rev_t, oy_rev, insx_rev_t, insy_rev, params,
                         tile_p, kk):
    """`_bwd_pallas_fused`'s pallas_call of `_bwd_kernel` (kk=K), with
    interpret=True."""
    lx, b, _ = xm_rev_t.shape
    kp, ly = oy_rev.shape[1], oy_rev.shape[2]
    return pl.pallas_call(
        partial(j_pallas._bwd_kernel, kk, j_pallas.SCAN_IMPL),
        grid=(b // tile_p, lx),
        in_specs=[
            pl.BlockSpec((tile_p, 16), lambda t, i: (t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, tile_p, 128),
                         lambda t, i: (jnp.maximum(i - 1, 0), t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((tile_p, kp, ly), lambda t, i: (t, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, tile_p, 1),
                         lambda t, i: (jnp.maximum(i - 1, 0), t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((tile_p, ly), lambda t, i: (t, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, tile_p, ly), lambda t, i: (i, t, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((lx, b, ly), jnp.float32),
        scratch_shapes=[pltpu.VMEM((tile_p, ly), jnp.float32)] * 5
        + [pltpu.VMEM((tile_p, 128), jnp.float32)],
        interpret=True,
    )(params, xm_rev_t, oy_rev, insx_rev_t, insy_rev)


def _rolled(codes, lens):
    """JAX's legacy-route codes: jnp.roll(x[::-1], lx - Lx) per pair."""
    width = codes.shape[1]
    return jax.vmap(lambda x, n: jnp.roll(x[::-1], n - width))(
        jnp.asarray(codes), jnp.asarray(lens))


def test_bwd_codes_plain_matches_pallas_bwd_kernel(case):
    """3K's plain version (codes read through reversed indices, per-pair
    tables) against the Pallas `_bwd_kernel` with kk=K fed JAX's rolled
    codes and `batch_posteriors_pallas_multi`'s per-pair match rows, on
    every cell the combine reads (rows u < lx, lanes v < ly); rows past
    lx are zero in the port."""
    (xb, yb, lx, ly), jps, tps = case
    match_b, insert_b, start_b, tv_b = _jax_multi(jps)
    kk = match_b.shape[1]
    kp = -(-kk // 8) * 8
    xr, yr = _rolled(xb, lx), _rolled(yb, ly)
    oxT = jax.nn.one_hot(xr.T, kk, dtype=jnp.float32)
    xm = jnp.einsum("lbk,bkm->lbm", oxT, match_b,
                    precision=jax.lax.Precision.HIGHEST)
    xm = jnp.pad(xm, ((0, 0), (0, 0), (0, 128 - kk)))
    oy = jnp.pad(jax.nn.one_hot(yr, kk, dtype=jnp.float32, axis=1),
                 ((0, 0), (0, kp - kk), (0, 0)))

    def ins(c):
        return jnp.take_along_axis(insert_b, c, axis=1)
    rb_p = np.asarray(_bwd_fused_interpret(
        xm, oy, ins(xr).T[:, :, None], ins(yr),
        j_pallas._params_rows_multi(start_b, tv_b), 8, kk)
    ).transpose(1, 0, 2)
    m, i, s, t = _port_multi(tps)
    rb = t_cuda.pairhmm_bwd_codes(*_t(xb, yb, lx, ly), m, i,
                                  t_cuda.params_rows(s, t)).numpy()
    for k in range(B):
        want, got = rb_p[k, :lx[k], :ly[k]], rb[k, :lx[k], :ly[k]]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        assert not rb[k, lx[k]:].any()


def test_rolled_codes_are_codes_read_reversed(case):
    """Position k < lx of JAX's roll(x[::-1], lx - Lx) is x[lx-1-k]: the
    identity by which 3K reads the codes reversed instead."""
    (xb, yb, lx, ly), _, _ = case
    for codes, lens in ((xb, lx), (yb, ly)):
        rolled = np.asarray(_rolled(codes, lens))
        for k in range(B):
            n = lens[k]
            assert np.array_equal(rolled[k, :n], codes[k, :n][::-1])


def test_multi_lanes_equal_single_pack_plain(case):
    """Each lane of 1M, 2M and 3K (plain, per-pair tables) equals the
    shared-table plain versions (A, B, 3K) on its own pack, bit for bit,
    and the fused and legacy entry points likewise."""
    (xb, yb, lx, ly), _, tps = case
    args = _t(xb, yb, lx, ly)
    m, i, s, t = _port_multi(tps)
    p = t_cuda.params_rows(s, t)
    fm, fend = t_cuda.fwd_plain(*args, m, i, p)
    tot = t_cuda._total_prob(fend, p)
    post, mea = t_cuda.bwd_post_plain(*args, m, i, p, tot, fm)
    rb = t_cuda.bwd_codes_plain(*args, m, i, p)
    multi = {f: t_cuda.batch_posteriors_cuda_multi(*args, m, i, s, t,
                                                   fused=f)
             for f in (True, False)}
    for r, tp in enumerate(tps):
        rows = torch.as_tensor(np.flatnonzero(REP == r))
        match, insert, params = t_cuda.tables(tp, "cpu")
        fm1, fend1 = t_cuda.fwd_plain(*args, match, insert, params)
        tot1 = t_cuda._total_prob(fend1, params)
        post1, mea1 = t_cuda.bwd_post_plain(*args, match, insert, params,
                                            tot1, fm1)
        rb1 = t_cuda.bwd_codes_plain(*args, match, insert, params)
        for got, want in ((fm, fm1), (fend, fend1), (tot, tot1),
                          (post, post1), (mea, mea1), (rb, rb1)):
            assert torch.equal(got[rows], want[rows])
        for f in (True, False):
            single = t_cuda.batch_posteriors_cuda(*args, tp, fused=f)
            assert torch.equal(multi[f][0][rows], single[0][rows])
            assert torch.equal(multi[f][1][rows], single[1][rows])


def test_lattice_kernels_take_per_pair_params(case):
    """Kernels 1E/2E's plain versions with (B, 16) params rows on the
    per-pair lattice match_b[x_i, y_j] give 1M/2M's plain bits (on the
    card: chip_smoke.py holds the kernels so)."""
    (xb, yb, lx, ly), _, tps = case
    args = _t(xb, yb, lx, ly)
    m, i, s, t = _port_multi(tps)
    p = t_cuda.params_rows(s, t)
    fm, fend = t_cuda.fwd_plain(*args, m, i, p)
    tot = t_cuda._total_prob(fend, p)
    post, mea = t_cuda.bwd_post_plain(*args, m, i, p, tot, fm)
    x, y = args[0].long(), args[1].long()
    ar = torch.arange(B)[:, None, None]
    e = m[ar, x[:, :, None], y[:, None, :]]
    ins_x, ins_y = torch.gather(i, 1, x), torch.gather(i, 1, y)
    fm2, fend2 = t_emis.pairhmm_fwd_emis(e, ins_x, ins_y, args[2], args[3],
                                         p)
    post2, mea2 = t_emis.pairhmm_bwd_post_emis(e, ins_x, ins_y, args[2],
                                               args[3], p, tot, fm)
    assert torch.equal(fm, fm2) and torch.equal(fend, fend2)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)


def test_multi_wrappers_check_shapes(case):
    """Per-pair tables must have one row a lane; the CPU wrappers count
    no launch."""
    (xb, yb, lx, ly), _, tps = case
    args = _t(xb, yb, lx, ly)
    m, i, s, t = _port_multi(tps)
    p = t_cuda.params_rows(s, t)
    with pytest.raises(ValueError, match="score table shapes"):
        t_cuda._check_inputs(*(a.int() for a in args), m[:4].contiguous(),
                             i, p)
    assert t_cuda._check_inputs(*(a.int() for a in args), m, i,
                                p) == (B, PAD, PAD, 21)
    before = dict(t_cuda.LAUNCHES)
    t_cuda.batch_posteriors_cuda_multi(*args, m, i, s, t, fused=False)
    assert t_cuda.LAUNCHES == before
