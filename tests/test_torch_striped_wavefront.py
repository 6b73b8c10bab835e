"""Kernels 5 and 6 as one launch a pass (ops/pairhmm_striped.py).

The whole-pass wrappers run, on CPU tensors, the per-stripe twins
chained stripe by stripe; these tests hold them and the orchestration
built on them (one pass each way, the posterior written over the M
lattice in place) to the per-stripe route they replace, bit for bit, on
the cases of tests/test_torch_longpair.py::_striped_case. They also hold
the launch geometry's limits and the wrappers' input checks. The CUDA
kernels against these twins: tests/test_torch_cuda.py, on the card.
"""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm_cuda as t_cuda
from muscle_tpu_torch.ops import pairhmm_striped as t_striped


@pytest.fixture(scope="module")
def pack():
    return HMMParams.from_defaults().to_scores()


def _striped_case():
    """tests/test_torch_longpair.py::_striped_case: ly == By, ly < one
    stripe, ly crossing a stripe edge, lx == Bx, short pairs in long
    padding."""
    lxs = [256, 200, 90, 256, 130, 240, 70, 220]
    lys = [512, 500, 450, 255, 256, 300, 100, 400]
    rng = np.random.default_rng(0)
    xb = np.full((8, 256), 20, np.int32)
    yb = np.full((8, 512), 20, np.int32)
    for i in range(8):
        xb[i, :lxs[i]] = rng.integers(0, 20, lxs[i])
        yb[i, :lys[i]] = rng.integers(0, 20, lys[i])
    return tuple(torch.from_numpy(a) for a in
                 (xb, yb, np.asarray(lxs, np.int32),
                  np.asarray(lys, np.int32)))


def _inputs(pack):
    xb, yb, lx, ly = _striped_case()
    match, insert, params = t_cuda.tables(pack, "cpu")
    forms = t_striped.row0_closed_forms(yb, ly, insert, params)
    return (xb, yb, lx, ly, match, insert, params), forms


def _per_stripe_passes(args, forms, w):
    """The orchestration before one launch a pass: one twin call a
    stripe, each forward stripe's M rows kept, each reversed stripe's
    posterior its own tensor."""
    iy0, jy0, iy0b, jy0b = forms
    n_s = args[1].shape[1] // w
    fms, bnd, fend = [], None, None
    for s in range(n_s):
        bnd, fe, fm = t_striped.fwd_stripe_plain(*args, iy0, jy0, bnd, s, w)
        fms.append(fm)
        fend = fe if fend is None else torch.maximum(fend, fe)
    tot = t_cuda._total_prob(fend, args[6]).contiguous()
    posts, bnd, mea = [], None, None
    for sp in range(n_s):
        post, bnd, mea = t_striped.bwd_stripe_plain(
            *args, tot, iy0b, jy0b, bnd, fms[n_s - 1 - sp], sp, w)
        posts.append(post)
    return fms, fend, tot, posts, mea


@pytest.mark.parametrize("w", [256, 512])
def test_whole_pass_wrappers_equal_chained_twins(pack, w):
    args, forms = _inputs(pack)
    iy0, jy0, iy0b, jy0b = forms
    fms, fend_s, tot_s, posts, mea_s = _per_stripe_passes(args, forms, w)
    before = dict(t_striped.LAUNCHES)
    fm, fend = t_striped.pairhmm_fwd_striped(*args, iy0, jy0, w)
    assert fm.shape == (8, 256, 512)
    assert torch.equal(fm, torch.cat(fms, dim=2))
    assert torch.equal(fend, fend_s)
    tot = t_cuda._total_prob(fend, args[6]).contiguous()
    assert torch.equal(tot, tot_s)
    post, mea = t_striped.pairhmm_bwd_striped(*args, tot, iy0b, jy0b, fm, w)
    assert post.data_ptr() == fm.data_ptr()     # written in place
    assert torch.equal(post, torch.cat(posts[::-1], dim=2))
    assert torch.equal(mea, mea_s)
    assert t_striped.LAUNCHES == before     # CPU tensors: twins only


@pytest.mark.parametrize("w", [256, 512])
def test_sparse_route_equals_per_stripe_route(pack, w):
    """One pass each way with the posterior over the M lattice: the same
    stripe top-Ks, merged in the same order, so the same stored columns
    (ties included), values, EA and nnz as the per-stripe route."""
    args, forms = _inputs(pack)
    xb, yb, lx, ly = args[:4]
    k = 32
    _, _, _, posts, mea = _per_stripe_passes(args, forms, w)
    n_s = yb.shape[1] // w
    vals_parts, cols_parts, nnz = [], [], 0
    for sp, post in enumerate(posts):
        v, c = t_striped._top_k(post, k)
        vals_parts.append(v)
        cols_parts.append(torch.where(v > 0, c.to(torch.int32)
                                      + (n_s - 1 - sp) * w, -1))
        nnz = nnz + (post > 0).sum(dim=-1)
    v, idx = t_striped._top_k(torch.cat(vals_parts, dim=-1), k)
    c = torch.gather(torch.cat(cols_parts, dim=-1), -1, idx)
    want_vals = torch.where(v > 0, v, 0.0)
    want_cols = torch.where(v > 0, c, -1).to(torch.int32)
    want_ea = mea / torch.minimum(lx, ly).float()

    vals, cols, ea, max_nnz = t_striped.striped_posteriors_sparse(
        xb, yb, lx, ly, pack, k=k, stripe_w=w)
    assert torch.equal(vals, want_vals)
    assert torch.equal(cols, want_cols)
    assert torch.equal(ea, want_ea)
    assert max_nnz == int(nnz.max())
    assert bool((cols >= 0).any()) and bool((ea > 0).all())


@pytest.mark.parametrize("b,by,w", [(1, 20480, 2048), (8, 20480, 2048),
                                    (8, 26624, 2048), (3, 4096, 2048),
                                    (8, 512, 256), (2, 576, 192)])
def test_geometry_limits(b, by, w):
    """The chosen G divides 32 and the stripe's segments (so a group
    never straddles a stripe edge), the groups tile the row, and every
    valid forced G is taken as given."""
    nseg_w = w // 64
    geo = t_striped._geometry(b, by, w)
    assert 32 % geo.g == 0 and nseg_w % geo.g == 0
    assert geo.groups * 64 * geo.g == by
    # the measured best where the stripe allows it, else the largest
    # power of two below it that divides the stripe
    want = t_striped.GROUP_SEGMENTS
    while nseg_w % want:
        want //= 2
    assert geo.g == want
    for g in (1, 2, 4, 8, 16, 32):
        if nseg_w % g == 0:
            assert t_striped._geometry(b, by, w, g).g == g
        else:
            with pytest.raises(ValueError):
                t_striped._geometry(b, by, w, g)
    for g in (0, 3, 64):
        with pytest.raises(ValueError):
            t_striped._geometry(b, by, w, g)


def test_hand_over_at_the_striped_budget():
    """The router's largest striped group: 8 pairs at 24576 x 26624
    (654 M cells each, within _STRIPED_CELL_BUDGET; a 20.9 GB M
    lattice). One record a DP row a group, 16 B (forward) or 32 B
    (backward) against the group's 256 G B of M row: the backward's
    records are 1 / (8 G) of the lattice they run beside, 654 MB at the
    chosen G = 4, 2.6 GB at G = 1."""
    from muscle_tpu_torch.pipeline.posteriors import _STRIPED_CELL_BUDGET
    b, lx, by, w = 8, 24576, 26624, 2048
    assert lx * by <= _STRIPED_CELL_BUDGET
    lattice = b * lx * by * 4
    geo = t_striped._geometry(b, by, w)
    fwd = geo.hand_bytes(b, lx, "pairhmm_fwd_stripe")
    bwd = geo.hand_bytes(b, lx, "pairhmm_bwd_stripe")
    assert fwd == b * geo.groups * lx * 16 and bwd == 2 * fwd
    assert geo.g == 4 and bwd * 8 * geo.g == lattice
    assert bwd < 0.7e9
    one = t_striped._geometry(b, by, w, 1)
    assert one.hand_bytes(b, lx, "pairhmm_bwd_stripe") * 8 == lattice


def test_wrappers_reject_bad_inputs(pack):
    args, forms = _inputs(pack)
    iy0, jy0, iy0b, jy0b = forms
    fm, fend = t_striped.pairhmm_fwd_striped(*args, iy0, jy0, 256)
    tot = t_cuda._total_prob(fend, args[6]).contiguous()
    with pytest.raises(ValueError):     # 192 does not divide By = 512
        t_striped.pairhmm_fwd_striped(*args, iy0, jy0, 192)
    with pytest.raises(ValueError):
        t_striped.pairhmm_bwd_striped(*args, tot, iy0b, jy0b, fm, 192)
    with pytest.raises(ValueError):     # codes not int32
        t_striped.pairhmm_fwd_striped(args[0].long(), *args[1:], iy0, jy0,
                                      256)
    with pytest.raises(ValueError):
        t_striped.pairhmm_bwd_striped(*args[:1], args[1].long(), *args[2:],
                                      tot, iy0b, jy0b, fm, 256)
    with pytest.raises(ValueError):     # fm of one stripe, not the row
        t_striped.pairhmm_bwd_striped(*args, tot, iy0b, jy0b,
                                      fm[:, :, :256].contiguous(), 256)
    with pytest.raises(ValueError):     # fm not contiguous
        t_striped.pairhmm_bwd_striped(*args, tot, iy0b, jy0b,
                                      fm.transpose(1, 2), 256)
    with pytest.raises(ValueError):     # a group straddling the stripe
        t_striped.pairhmm_fwd_striped(*args, iy0, jy0, 256, 8)
    t_striped.wavefront.check_waits("cpu")  # no launch, no flag
